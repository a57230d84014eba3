"""Each cell's check on the CPU at a small size: a sound run of the
program is correct, and a run with a fault planted under the timed path
(portbench/faults.py) comes out not correct. The look for a card is
skipped: the harness runs here on the CPU with the program's plain
paths, as the card runs its kernels."""

import time
from pathlib import Path

import pytest

from portbench.core.cell import load_cell, run
from portbench.faults import FAULTS, planted

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99
SMALL = {
    "dpdist_serve_np64": ({}, dict(batch=8, pool_batches=2, warmup_steps=1)),
    "dpdist_grad_np64": ({}, dict(batch=4, pool_batches=2, warmup_steps=1)),
    "dpdist_serve_np1024": ({}, dict(batch=8, num_point=256, pool_batches=2, warmup_steps=1)),
    "aue_train_b16": (dict(n_gaussians=8), dict(batch=4, pool_batches=4, log_every=2)),
}


def small_cell(name):
    cell = load_cell(ROOT, name)
    config, traffic = SMALL[name]
    cell["config"].update(config)
    cell["traffic"].update(traffic)
    return cell


def run_small(name, seconds=0.3):
    result, notes = run(ROOT, small_cell(name), SEED, seconds, False, "cpu", time.perf_counter())
    return result, notes


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    result, notes = run_small(name)
    assert result["correct"] is True and result["failed"] == 0, notes
    assert result["attempted"] >= 1 and set(result["checks"]) == set(small_cell(name)["limits"])
    assert list(result)[-1] == "checks"
    assert notes[-len(result["checks"]):] == [
        f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in result["checks"].items()]


CASES = [(name, fault) for name in sorted(SMALL)
         for fault in FAULTS[small_cell(name)["traffic"]["driver"]]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_caught(name, fault):
    with planted(small_cell(name)["traffic"]["driver"], fault):
        result, notes = run_small(name)
    assert result["correct"] is False, notes
