"""The DPDist training cell (dpdist_train_b256) on the CPU at a small size:
its traffic follows the ground-truth protocol, the plain reference's step
is the program's, a sound run is correct and reads the training spans, and
the control and planted faults come out not correct."""

import json
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core.cell import load_cell, make_driver, run
from portbench.drivers import dpdist_train
from portbench.reference import dpdist_3dmfv_k5_train as ref

ROOT = Path(__file__).resolve().parents[2]
NAME = "dpdist_train_b256"
SEED = 2 ** 31 + 123
SMALL = dict(batch=4, pool_batches=4, surfaces=7, surface_points=2000, gt_points=128,
             candidates=512)
CPU = torch.device("cpu")


def small_cell():
    cell = load_cell(ROOT, NAME)
    cell["traffic"].update(SMALL)
    return cell


def test_traffic_follows_the_ground_truth_protocol():
    t = dict(small_cell()["traffic"], rotate="none")
    data, labels = dpdist_train.training_pool(t, 5)
    n = t["num_point"]
    assert data.shape == (4, 4, 6 * n, 3) and labels.shape == (4, 4, 4 * n)
    near_d, far_d = labels[..., :2 * n], labels[..., 2 * n:]
    assert np.all((near_d > 0.001) & (near_d < 0.1))
    assert np.all(far_d > 0.1)
    # Unrotated, the surface points lie within 0.8 of the origin, and some far
    # points are the cube's points outside the unit sphere.
    assert np.linalg.norm(data[:, :, :2 * n], axis=-1).max() <= 0.8 + 1e-6
    assert (np.linalg.norm(data[:, :, 4 * n:], axis=-1) > 1).any()
    pcA, pcB, lab = dpdist_train.assemble(data[0], labels[0])
    assert pcA.shape == pcB.shape == (4, n, 3) and lab.shape == (4, n)
    assert np.all(lab[:, :n // 2] == 0) and np.all(lab[:, n // 2:] > 0.001)
    # The same seed gives the same pool.
    again = dpdist_train.training_pool(t, 5)
    assert np.array_equal(again[0], data) and np.array_equal(again[1], labels)


def test_the_reference_step_is_the_programs():
    """One DPDistTrainer step on the CPU against the reference's Adam step
    from the same leaves and batch: the loss and every leaf after it."""
    from dpdist_tpu_torch.configs import TrainConfig
    from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
    from dpdist_tpu_torch.train.logging import NullLogger
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    from portbench.core.pairs import dpdist_config
    from portbench.core.weights import initial_leaves

    cell = small_cell()
    cfg, t = cell["config"], cell["traffic"]
    data, labels = dpdist_train.training_pool(t, 9)
    trainer = DPDistTrainer(dpdist_config(cfg), TrainConfig(batch_size=4, augment=False),
                            run_dir="unused", device="cpu", logger=NullLogger())
    start = initial_leaves(ref.leaf_shapes(cfg), 11, CPU)
    start[ref.head_bias(cfg)] += cfg["head_bias_offset"]
    leaves = dict(tree_flatten_with_paths(trainer.params))
    with torch.no_grad():
        for p, v in start.items():
            leaves[p].copy_(v)
    got = float(trainer.train_step(data[0], labels[0])["loss"])
    params = {p: v.clone() for p, v in start.items()}
    batch = tuple(torch.as_tensor(a) for a in dpdist_train.assemble(data[0], labels[0]))
    with ref.Arith("float32", CPU) as arith:
        (want,), grads = ref.train(cfg, arith, params, [batch])
    assert abs(got - want) / want < 1e-6
    assert set(grads) == set(leaves) and min(grads.values()) > 0
    lr = cfg["learning_rate"]
    for p, v in tree_flatten_with_paths(trainer.params):
        # Adam's first step moves a weight by about lr * sign(g); where |g|
        # is near 1e-8 rounding may flip its direction.
        moved = (v.detach() - params[p].detach()).abs()
        assert float(moved.max()) <= 2 * lr * (1 + 1e-3), p
        assert float((moved > 1e-3 * lr).float().mean()) < 1e-3, p


def _run_small(trace=False):
    return run(ROOT, small_cell(), SEED, 0.5, trace, "cpu", time.perf_counter())


def test_a_sound_run_is_correct_and_reads_the_training_spans():
    result, notes = _run_small(trace=True)
    assert result["correct"] is True and result["failed"] == 0, notes
    assert set(result["checks"]) == {"loss_gap", "change_gap", "later_loss_gap", "grad_gap"}
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("forward_idle_ms.train", "backward_idle_ms.train", "optim_idle_ms.train",
                 "step_idle_ms.train", "optim_ms.train", "launches.train"):
        assert name in m, (name, sorted(m))
    assert m["optim_ms.train"] > 0 and m["step_idle_ms.train"] > 0
    # Nothing runs on a device here: each training span is idle throughout,
    # and the three with the step's own add up to no more than the entry's
    # idle time a step.
    entry = dict(result["breakdown"]["idle_gaps"])["entry"] * 1e3 / result["attempted"]
    spans = m["forward_idle_ms.train"] + m["backward_idle_ms.train"] + m["optim_idle_ms.train"]
    assert 0.5 * entry < spans < spans + m["step_idle_ms.train"] <= entry
    assert m["optim_idle_ms.train"] == pytest.approx(m["optim_ms.train"], rel=1e-6)


def test_the_emulated_control_fails():
    driver = make_driver(ROOT, small_cell(), SEED, "cpu")
    driver.setup()
    driver.release()
    readings = driver.control()
    limits = small_cell()["limits"]
    assert [n for n, v in limits.items() if not readings[n] <= v], readings


@contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _unchanged(self, params, grads, state):
    return {**state, "count": state["count"] + 1}


def _altered(orig):
    def step_loss(self, params, state, batch):
        loss, new_state = orig(self, params, state, batch)
        return loss * (1 + 1e-3), new_state
    return step_loss


def _uphill(orig):
    def step(self, params, grads, state):
        return orig(self, params, [-g for g in grads], state)
    return step


@pytest.mark.parametrize("fault", ["unchanged", "altered", "uphill"])
def test_a_planted_fault_is_caught(fault):
    from dpdist_tpu_torch.train.optim import Optimizer
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    if fault == "unchanged":
        patch = _patched(Optimizer, "step", _unchanged)
    elif fault == "altered":
        patch = _patched(DPDistTrainer, "step_loss", _altered(DPDistTrainer.step_loss))
    else:
        # Adam's step taken against the gradient: each weight moves as far
        # as it should, the wrong way, so only the later losses see it.
        patch = _patched(Optimizer, "step", _uphill(Optimizer.step))
    with patch:
        result, notes = _run_small()
    assert result["correct"] is False, notes
    if fault == "uphill":
        checks = result["checks"]
        assert checks["later_loss_gap"]["value"] > checks["later_loss_gap"]["limit"], notes


def test_the_limits_file_names_the_checked_numbers():
    limits = json.loads((ROOT / "portbench" / "limits" / f"{NAME}.json").read_text())
    assert set(limits) == {"loss_gap", "change_gap", "later_loss_gap", "grad_gap"}
    assert 0 < limits["change_gap"] < 1
