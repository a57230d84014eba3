"""The PCRNet training cell (pcrnet_dpdist_b16) on the CPU at a small size
(a 4^3 grid, out_features 64, head 32-16, 3 loops, 2 pairs of 32
points): its traffic follows the protocol, the plain reference's step is
the program's, a sound run is correct and reads the new spans, and the
control and planted faults come out not correct."""

import functools
import json
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core import counts, pcrnet_counts
from portbench.core.cell import load_cell, make_driver, run
from portbench.core.traffic import pair_pool
from portbench.reference import pcrnet_3dmfv_dpdist as ref

ROOT = Path(__file__).resolve().parents[2]
NAME = "pcrnet_dpdist_b16"
SEED = 2 ** 31 + 123
SMALL_CONFIG = dict(mfv_grid=4, out_features=64, head_widths=[32, 16], max_loops=3, num_point=32)
SMALL_TRAFFIC = dict(batch=2, num_point=32, surfaces=7, surface_points=256, pool_batches=4)
COMPARED = {"pose_gap", "loss_gap", "grad_gap", "state_gap", "update_gap"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    # Many small eager ops on a CPU that the test workers share stall at the
    # thread pool's barriers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell():
    cell = load_cell(ROOT, NAME)
    cell["config"].update(SMALL_CONFIG)
    cell["traffic"].update(SMALL_TRAFFIC)
    return cell


@pytest.fixture
def card_routes(monkeypatch):
    """The card's routes on the CPU, where each kernel wrapper runs its
    plain version: the policy's encode through row 7's autograd Function
    (whose backward replays the plain encode), the frozen loss on the
    table kernels with row 7 at any size."""
    from dpdist_tpu_torch.models import dpdist, pcrnet
    from dpdist_tpu_torch.ops.threedmfv import threedmfv

    from portbench.core import pairs

    monkeypatch.setattr(pcrnet, "threedmfv", functools.partial(threedmfv, impl="kernel"))
    monkeypatch.setattr(dpdist, "KERNEL_MIN_POINTS", 1)
    config = pairs.dpdist_config
    monkeypatch.setattr(pairs, "dpdist_config",
                        lambda cfg: config(dict(cfg, fused_gather="table")))


def test_traffic_follows_the_protocol():
    cell = small_cell()
    driver = make_driver(ROOT, cell, 5, "cpu")
    t = driver.ctx.traffic
    tmpl, src = pair_pool(t, 5)
    assert tmpl.shape == src.shape == (4, 2, 32, 3)
    # Templates in their canonical pose: the unit-scaled surfaces' samples,
    # within the unit ball; each source the same surface turned about the
    # origin, so its points keep their distances to it.
    assert np.linalg.norm(tmpl, axis=-1).max() <= 1 + 1e-6
    dense = pair_pool(dict(t, num_point=t["surface_points"]), 5)
    assert np.allclose(np.sort(np.linalg.norm(dense[0], axis=-1), -1),
                       np.sort(np.linalg.norm(dense[1], axis=-1), -1), atol=1e-5)
    assert not np.allclose(dense[0], dense[1])
    again = pair_pool(t, 5)
    assert np.array_equal(again[0], tmpl) and np.array_equal(again[1], src)
    assert t["rotate"] == "none" and t["source_angle_deg"] == 45 and t["surface_scale"] == 0.8


def _trainer(cfg, frozen, arrays, loops):
    from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
    from dpdist_tpu_torch.train.logging import NullLogger
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    from portbench.core.pairs import dpdist_config
    from portbench.core.weights import nest

    pcfg = PCRNetConfig(num_point=32, encoder="3dmfv", out_features=cfg["out_features"],
                        max_loops=loops, head_widths=tuple(cfg["head_widths"]),
                        sigma3dmfv=cfg["sigma3dmfv"], mfv_grid=cfg["mfv_grid"])
    tcfg = TrainConfig(batch_size=2, learning_rate=cfg["learning_rate"], grad_clip=1.0)
    return PCRNetTrainer(pcfg, tcfg, loss_type="dpdist", dpdist=(dpdist_config(frozen),
                                                                 nest(arrays), None),
                         train_single=True, run_dir="unused", logger=NullLogger(), device="cpu")


def test_the_reference_step_is_the_programs():
    """One PCRNetTrainer step over one iteration (well conditioned: no
    chain of iterations) against the reference's free-running step, its
    clipping and Adam, from the same leaves and batch."""
    from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

    from portbench.core.weights import initial_leaves, read_checkpoint

    cell = small_cell()
    cfg = dict(cell["config"], max_loops=1)
    frozen = json.loads((ROOT / "portbench/configs/dpdist_3dmfv_k5.json").read_text())
    arrays = read_checkpoint(str(ROOT / frozen["checkpoint"]))
    tmpl, src = (torch.as_tensor(a[0] * np.float32(0.8)) for a in pair_pool(cell["traffic"], 9))
    trainer = _trainer(cfg, frozen, arrays, 1)
    shapes, state_shapes = ref.leaf_shapes(cfg)
    start = initial_leaves(shapes, 11, "cpu")
    leaves = dict(tree_flatten_with_paths(trainer.params))
    with torch.no_grad():
        for p, v in start.items():
            leaves[p].copy_(v)
    got = float(trainer.train_step(tmpl, src)["loss"])
    from portbench.reference.dpdist_3dmfv_k5 import Arith, Net

    want = ref.step(cfg, Arith("float32", "cpu"), Net(frozen, arrays, "cpu"), start,
                    initial_leaves(state_shapes, 11, "cpu"), tmpl, src)
    assert abs(got - want["loss"]) / want["loss"] < 1e-6
    zeros = {p: torch.zeros_like(v) for p, v in start.items()}
    update = ref.adam_update(cfg, ref.clip(cfg, want["grads"]), zeros, dict(zeros), 0)
    lr = cfg["learning_rate"]
    norms = {p: float(g.norm()) for p, g in want["grads"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    for p, v in leaves.items():
        moved = v.detach() - start[p]
        # Adam's first step moves each weight by about lr * sign(g). A conv
        # bias before a BN has no gradient in exact arithmetic: its rounding
        # noise picks the signs, on either side.
        assert float((moved - update[p]).abs().max()) <= 2 * lr * (1 + 1e-3), p
        if norms[p] >= floor:
            # Elsewhere a sign flips only where |g| is rounding-sized too (at
            # most 6.1e-5 of a leaf's weights on this batch).
            assert float(((moved - update[p]).abs() > lr).float().mean()) < 1e-3, p
        else:
            assert p.startswith("mfv_blocks/") and p.endswith("/b"), p
    for p, v in tree_flatten_with_paths(trainer.state):
        assert torch.allclose(v, want["state"][p], rtol=1e-5, atol=1e-6), p


def _run_small(trace=False):
    return run(ROOT, small_cell(), SEED, 0.5, trace, "cpu", time.perf_counter())


def test_a_sound_run_is_correct_and_reads_the_new_spans(card_routes):
    result, notes = _run_small(trace=True)
    assert result["correct"] is True and result["failed"] == 0, notes
    assert set(result["checks"]) == COMPARED
    m = {k: v["value"] for k, v in result["metrics"].items()}
    # One replay a loop but the first (its source needs no gradient), and
    # one in the loss, a step.
    assert m["replays.train"] == 3
    # Nothing runs on a device here: the refinement is idle throughout, and
    # inside the forward.
    assert 0 < m["refine_idle_ms.train"] < m["forward_idle_ms.train"]


def test_the_emulated_control_fails():
    driver = make_driver(ROOT, small_cell(), SEED, "cpu")
    driver.setup()
    driver.release()
    readings = driver.control()
    limits = small_cell()["limits"]
    assert [n for n, v in limits.items() if not readings[n] <= v], readings


@contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _fault(fault):
    from dpdist_tpu_torch.models import pcrnet
    from dpdist_tpu_torch.train import pcrnet_trainer
    from dpdist_tpu_torch.train.optim import Optimizer
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    if fault == "unchanged":
        return _patched(Optimizer, "step", lambda orig: lambda self, params, grads, state: {
            **state, "count": state["count"] + 1})
    if fault == "uphill":
        return _patched(Optimizer, "step", lambda orig: lambda self, params, grads, state: orig(
            self, params, [-g for g in grads], state))
    if fault == "altered":
        def make(orig):
            def step_loss(self, params, state, batch):
                loss, new_state = orig(self, params, state, batch)
                return loss * (1 + 1e-3), new_state
            return step_loss
        return _patched(PCRNetTrainer, "step_loss", make)
    if fault == "half_batch":
        def make(orig):
            def step_loss(self, params, state, batch):
                template, source, pose6 = batch
                b = template.shape[0] // 2
                return orig(self, params, state, (template[:b], source[:b], pose6))
            return step_loss
        return _patched(PCRNetTrainer, "step_loss", make)
    if fault == "last_iteration_only":
        def make(orig):
            def refine(*args, **kwargs):
                return orig(*args, **dict(kwargs, stop_gradient_iters=True))
            return refine
        return _patched(pcrnet_trainer, "pcrnet_refine", make)
    if fault == "bn_decoupled":
        # Source and template encoded apart: BN's statistics of each half
        # alone; the state the template's call leaves.
        def make(orig):
            def encode(params, cfg, points, *, state=None, train=False):
                b = points.shape[0] // 2
                fs, _ = orig(params, cfg, points[:b], state=state, train=train)
                ft, st = orig(params, cfg, points[b:], state=state, train=train)
                return torch.cat([fs, ft]), st
            return encode
        return _patched(pcrnet, "_encode_3dmfv", make)
    raise ValueError(fault)


FAULTS = {
    "unchanged": "update_gap",
    "uphill": "update_gap",
    "altered": "loss_gap",
    "half_batch": "pose_gap",
    "last_iteration_only": "grad_gap",
    "bn_decoupled": "pose_gap",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(fault):
    with _fault(fault):
        result, notes = _run_small()
    assert result["correct"] is False, notes
    checks = result["checks"]
    number = FAULTS[fault]
    assert checks[number]["value"] > checks[number]["limit"], notes


def test_the_limits_file_names_the_checked_numbers():
    limits = json.loads((ROOT / "portbench" / "limits" / f"{NAME}.json").read_text())
    assert set(limits) == COMPARED
    assert all(0 < v < 1 for v in limits.values())


def test_counts_at_the_published_widths():
    cell = load_cell(ROOT, NAME)
    cfg, t = cell["config"], cell["traffic"]
    frozen = json.loads((ROOT / "portbench/configs/dpdist_3dmfv_k5.json").read_text())
    # Block 1 at 8^3 cells (640 MFLOP: 1^3 from 20 channels twice, 3^3 and
    # 5^3 at 64), blocks 2-3 at 8^3 from 256 channels (671 MFLOP each),
    # 4-5 at 4^3, 6 at 2^3.
    assert pcrnet_counts.conv_flops(cfg) == 2_160_590_848
    assert pcrnet_counts.feature_dim(cfg) == 2048
    # 2 * (4,096 * 1,024 + 1,024 * 512 + 512 * 256 + 256 * 7)
    assert pcrnet_counts.head_flops(cfg) == 9_702_912
    flops = pcrnet_counts.step_flops(cfg, frozen, t["batch"], t["num_point"])
    decoder = counts.grad_call_flops(frozen, 8 * 16, 1024)
    assert decoder == 2 * 2 * 128 * 1024 * 9_326_592
    # Iteration 0's first 1^3 convolutions need no input gradient.
    convs = 3 * 8 * 32 * 2_160_590_848 - 32 * 2 * (2 * 512 * 20 * 64)
    assert flops == convs + 3 * 8 * 16 * 9_702_912 + decoder
    assert flops / 1e12 == pytest.approx(6.55, abs=0.01)
    shapes, state = ref.leaf_shapes(cfg)
    weights = sum(int(np.prod(s)) for s in shapes.values())
    assert weights / 1e6 == pytest.approx(8.76, abs=0.01)
    assert len(state) == 6 * 4 * 2
