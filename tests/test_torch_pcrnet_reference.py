"""The port's PCRNetTrainer (3dmfv encoder, train_single, the frozen DPDist
loss on the committed net, grad_clip 1.0, Adam) against the benchmark's
plain reference (portbench/reference/pcrnet_3dmfv_dpdist.py), on the CPU
at a small size: a 4^3 grid, out_features 64, head 32-16, max_loops 3,
B = 2 pairs of 32 points, seeded weights.

Over one iteration the step is compared directly. Over three it is
compared teacher-forced, as the benchmark's check does
(portbench/drivers/pcrnet_train.py): a seeded policy's training-mode
refinement is chaotic, so two float32 chains run side by side part
(tests/test_torch_pcrnet_3dmfv.py), and the reference recomputes each
iteration from the program's own input to it. Tolerances, each between
the readings of five seeds (on one thread / on four) and the TF32
control's (the reference with each product's operands rounded to TF32):
  poses             5e-5 absolute: a single iteration's float32 rounding,
                    through BN's batch statistics over the 2B clouds
                    (read 2.1e-7 / 2.6e-6; control 2.6e-3 and over);
  loss              1e-6 relative, at the program's trajectory (1.1e-7 /
                    7.7e-8; control 1.9e-6 and over);
  gradient          2e-3 of the worst leaf over the larger of its norm and
                    the median leaf's: the chain through three iterations'
                    BN backward (7.1e-6 / 9.5e-5; control 0.137 and over);
                    conv biases before a BN, whose gradient is rounding
                    alone, left out;
  BN state          1e-5 relative to the larger of a leaf's norm and the
                    median's (9.6e-10 / 6.4e-7; control 2.6e-4 and over);
  update            5e-4 of the worst leaf: Adam's bias correction in
                    float32 (the program, as optax) against exact factors
                    moves 1 - 0.999 by 4.7e-5, which shows through the
                    rounding of the weights (3.7e-5 / 3.5e-5; the control
                    does not move it).

Under a profiler session the step records the spans pcrnet.refine,
pcrnet.encode[threedmfv], pcrnet.head and, with the card's routes taken
on the CPU, one threedmfv.replay a loop but the first and one in the loss.
"""

import functools
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
from dpdist_tpu_torch.train.logging import NullLogger
from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

from portbench.core.cell import load_cell, make_driver
from portbench.core.pairs import dpdist_config
from portbench.core.traffic import pair_pool
from portbench.core.weights import initial_leaves, nest, read_checkpoint
from portbench.reference import pcrnet_3dmfv_dpdist as ref
from portbench.reference.dpdist_3dmfv_k5 import Arith, Net

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 77
CONFIG = dict(mfv_grid=4, out_features=64, head_widths=[32, 16], max_loops=3, num_point=32)
TRAFFIC = dict(batch=2, num_point=32, surfaces=7, surface_points=256, pool_batches=4)
TOL = {"pose_gap": 5e-5, "loss_gap": 1e-6, "grad_gap": 2e-3, "state_gap": 1e-5,
       "update_gap": 5e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    cell = load_cell(ROOT, "pcrnet_dpdist_b16")
    cell["config"].update(CONFIG)
    cell["traffic"].update(TRAFFIC)
    return cell


@pytest.fixture(scope="module")
def frozen():
    """(configuration, checkpoint arrays) of the frozen loss's net."""
    name = _cell()["config"]["frozen_loss"]
    dcfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    return dcfg, read_checkpoint(str(ROOT / dcfg["checkpoint"]))


def _trainer(cfg, frozen, loops):
    dcfg, arrays = frozen
    pcfg = PCRNetConfig(num_point=32, encoder="3dmfv", out_features=cfg["out_features"],
                        max_loops=loops, head_widths=tuple(cfg["head_widths"]),
                        sigma3dmfv=cfg["sigma3dmfv"], mfv_grid=cfg["mfv_grid"])
    tcfg = TrainConfig(batch_size=2, learning_rate=cfg["learning_rate"],
                       grad_clip=cfg["grad_clip"])
    return PCRNetTrainer(pcfg, tcfg, loss_type="dpdist",
                         dpdist=(dpdist_config(dcfg), nest(arrays), None), train_single=True,
                         run_dir="unused", logger=NullLogger(), device="cpu")


def _batch(cell, seed):
    t, s = pair_pool(cell["traffic"], seed)
    scale = np.float32(cell["traffic"]["surface_scale"])
    return torch.as_tensor(t[0] * scale), torch.as_tensor(s[0] * scale)


def _seeded(trainer, cfg, seed):
    shapes, state_shapes = ref.leaf_shapes(cfg)
    start = initial_leaves(shapes, seed, "cpu")
    leaves = dict(tree_flatten_with_paths(trainer.params))
    with torch.no_grad():
        for p, v in start.items():
            leaves[p].copy_(v)
    return leaves, start, initial_leaves(state_shapes, seed, "cpu")


def test_one_iteration_matches_the_reference(frozen):
    """max_loops 1: the loss, the BN state and each leaf's update of one
    trainer step against the reference's step, clipping and Adam."""
    cell = _cell()
    cfg = dict(cell["config"], max_loops=1)
    tmpl, src = _batch(cell, 9)
    trainer = _trainer(cfg, frozen, 1)
    leaves, start, state = _seeded(trainer, cfg, 11)
    got = float(trainer.train_step(tmpl, src)["loss"])
    want = ref.step(cfg, Arith("float32", "cpu"), Net(frozen[0], frozen[1], "cpu"), start,
                    state, tmpl, src)
    assert abs(got - want["loss"]) / want["loss"] < TOL["loss_gap"]
    for p, v in tree_flatten_with_paths(trainer.state):
        assert torch.allclose(v, want["state"][p], rtol=1e-5, atol=1e-6), p
    zeros = {p: torch.zeros_like(v) for p, v in start.items()}
    update = ref.adam_update(cfg, ref.clip(cfg, want["grads"]), zeros, dict(zeros), 0)
    norms = {p: float(g.norm()) for p, g in want["grads"].items()}
    floor = 1e-3 * float(np.median(list(norms.values())))
    lr = cfg["learning_rate"]
    for p, v in leaves.items():
        flips = ((v.detach() - start[p]) - update[p]).abs() > lr
        # Adam's first step moves each weight by about lr * sign(g): a sign
        # flips only where |g| is rounding-sized, in every weight of a conv
        # bias before a BN, elsewhere in under 1e-3 of a leaf's weights.
        if norms[p] >= floor:
            assert float(flips.float().mean()) < 1e-3, p
        else:
            assert p.startswith("mfv_blocks/") and p.endswith("/b"), p


def test_three_iterations_teacher_forced_match_the_reference():
    """The benchmark's check at the small size: every compared number
    within its tolerance (the module docstring)."""
    driver = make_driver(ROOT, _cell(), SEED, "cpu")
    driver.setup()
    driver.release()
    readings = driver.check()
    for name, tol in TOL.items():
        assert readings[name] <= tol, (name, readings)


@pytest.fixture
def card_routes(monkeypatch):
    """The card's routes on the CPU (each kernel wrapper then runs its plain
    version): the policy's encode through row 7's autograd Function, whose
    backward replays the plain encode, and the frozen loss on the table
    kernels with row 7 at any size."""
    from dpdist_tpu_torch.models import dpdist, pcrnet
    from dpdist_tpu_torch.ops.threedmfv import threedmfv

    monkeypatch.setattr(pcrnet, "threedmfv", functools.partial(threedmfv, impl="kernel"))
    monkeypatch.setattr(dpdist, "KERNEL_MIN_POINTS", 1)


def test_a_step_records_the_pcrnet_spans(frozen, card_routes):
    from torch.profiler import ProfilerActivity, profile

    from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
    from dpdist_tpu_torch.train import profiling

    cell = _cell()
    cfg = cell["config"]
    dcfg, arrays = frozen
    trainer = _trainer(cfg, (dict(dcfg, fused_gather="table"), arrays), cfg["max_loops"])
    _seeded(trainer, cfg, 13)
    tmpl, src = _batch(cell, 3)
    replays = threedmfv_kernel.replays
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        trainer.train_step(tmpl, src)
    spans = [(n, d) for n, d, s, e, _, _ in profiling.spans() if s >= t0 and e > 0]
    loops = cfg["max_loops"]
    assert spans.count(("pcrnet.refine", "threedmfv")) == 1
    assert spans.count(("pcrnet.encode", "threedmfv")) == loops
    assert spans.count(("pcrnet.head", "")) == loops
    # The first loop's source is the data, which needs no gradient.
    assert spans.count(("threedmfv.replay", "")) == loops - 1 + 1
    assert threedmfv_kernel.replays - replays == loops
