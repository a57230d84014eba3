"""The control: the plain reference computed one precision below the
configuration's (TF32 for float32 with TF32 off) and put in the program's
place has to come out not correct. On the CPU TF32 is emulated (each
product's operands rounded to TF32); on a card (`gpu`) cuBLAS and cuDNN
run it. calibrate.py reads it at each cell's own size on the card."""

import pytest

from portbench.core.cell import make_driver

from test_portbench_faults import ROOT, SEED, SMALL, small_cell


def control_fails(name, device):
    cell = small_cell(name)
    driver = make_driver(ROOT, cell, SEED, device)
    driver.setup()
    driver.release()
    readings = driver.control()
    return [n for n, limit in cell["limits"].items() if not readings[n] <= limit], readings


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_emulated_control_fails(name):
    failed, readings = control_fails(name, "cpu")
    assert failed, readings


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_on_the_card(name, card):
    failed, readings = control_fails(name, card)
    assert failed, readings
