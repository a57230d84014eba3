"""The port's DPDist forward and served distance against dpdist_tpu, on both
committed nets at canonical width, plus the golden-pair file.

Run as a script from the repo root to regenerate
dpdist_tpu_torch/assets/golden_distance.json from the JAX package:

    PYTHONPATH=. python tests/test_torch_dpdist.py --write-golden
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import dpdist_distance as jax_distance
from dpdist_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from dpdist_tpu.ops.emd import sinkhorn_emd as jax_sinkhorn_emd

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.data.golden import GOLDEN_PATH, golden_clouds, load_golden
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x
from dpdist_tpu_torch.kernels.table_gather import table_gather_bwd, table_gather_x
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import apply_dpdist, dpdist_distance, init_dpdist
from dpdist_tpu_torch.ops import chamfer_distance, sinkhorn_emd
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
# Port (plain PyTorch on the CPU) against dpdist_tpu (XLA on the CPU):
# the encode and the decoder sum in other orders; the largest difference
# measured on these inputs was below 1e-6 (predictions and distances).
TOL = 1e-4
# The golden file keeps the frozen loss's gradient in pcA for these pairs
# only (one in the grid, one partly off it), so that it stays small.
GRAD_PAIRS = (0, 7)
# Golden input gradients, per point and relative to the largest entry: the
# criterion of tests/test_torch_losses_optim.py (the encodes' rounding
# difference, magnified on a few points by the signed sqrt near 0).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05
# The golden file's second section: the same pairs at 256 points, the
# JAX bench's second forward size (bench.py:133-138), where the port's
# card path runs the streaming encode and the patch-only gather.
NP_LARGE, LARGE = 256, "np256"
# Chamfer and EMD, port (CPU) against the stored JAX values
# (tests/test_torch_chamfer_emd.py's tolerance).
TOL_CHAMFER = TOL_EMD = 1e-5
# The golden file's bf16 section: per-pair distances of both nets served
# in bfloat16 at these sizes, through JAX's fused_forward kernel ("full",
# in interpret mode on the CPU) and its composed bf16 path ("auto", the XLA
# composition on the CPU). The port's CPU path meets them within TOL (a
# hidden activation at a bf16 rounding edge may round the other way where
# sums run in another order; measured up to 1.8e-5), and they lie within
# the JAX package's bounds of each other (2e-3) and of float32 (0.03).
BF16, BF16_MODES, BF16_SIZES = "bf16", ("full", "auto"), (64, NP_LARGE)
TOL_FULL_VS_COMPOSED, TOL_BF16_VS_F32 = 2e-3, 0.03
# The golden file's bf16_grad section: per size, the frozen loss of both
# nets in bfloat16 (JAX's XLA composition on the CPU) and its gradient in
# pcA for GRAD_PAIRS. The port meets them by the bf16 criterion of
# tests/test_torch_bf16_grad.py: the loss within 2e-3; d/dpcA within 1e-2
# of its largest entry on all but 5 % of the points, within 5e-2 on every
# point, and a cosine of at least 0.999.
BF16_GRAD = "bf16_grad"
TOL_BF16_LOSS, REL_BF16, OUTLIERS_BF16, REL_BF16_FEW, MIN_COS_BF16 = 2e-3, 1e-2, 0.05, 5e-2, 0.999
# The golden file's fp16 section: per-pair distances of both nets served in
# float16 at both sizes, by JAX's plain composition ("off") and its table
# kernels in interpret mode ("table"); its fp16_grad section: per size the
# frozen loss of both nets in float16 and its gradient in pcA for
# GRAD_PAIRS. The port's CPU path meets the distances and the loss within
# TOL_FP16, 8x tighter than bf16's 2e-3 for float16's three more mantissa
# bits (measured up to 3.2e-6 and 5.5e-7), the JAX values lie within
# TOL_FP16_VS_F32 of float32 (8x tighter than bf16's 0.03; measured up to
# 2.7e-5), and d/dpcA meets the bf16 criterion above (measured up to 9.8e-3
# of the largest entry, a cosine of at least 0.9999985).
FP16, FP16_MODES, FP16_GRAD = "fp16", ("off", "table"), "fp16_grad"
TOL_FP16, TOL_FP16_VS_F32 = 2.5e-4, 4e-3

GOLDEN_PAIRS = [
    {"a": ["chair", 0], "b": ["chair", 1], "scale": 0.8},
    {"a": ["box", 2], "b": ["box", 3], "scale": 0.8},
    {"a": ["sphere", 4], "b": ["sphere", 5], "scale": 0.8},
    {"a": ["chair", 6], "b": ["box", 7], "scale": 0.8},
    {"a": ["torus", 8], "b": ["cone", 9], "scale": 0.8},
    {"a": ["capsule", 10], "b": ["cylinder", 11], "scale": 0.8},
    {"a": ["chair", 12], "b": ["chair", 13], "scale": 1.1},   # partly off-grid
    {"a": ["sphere", 14], "b": ["box", 15], "scale": 1.2},    # partly off-grid
]


def _inputs(seed=0, B=3, N=64):
    """Seeded clouds of which some points lie outside [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    pcA = rng.uniform(-0.9, 0.9, (B, N, 3)).astype(np.float32)
    pcB = rng.uniform(-1.15, 1.15, (B, N, 3)).astype(np.float32)
    return pcA, pcB


@pytest.fixture(scope="module", params=NETS)
def net(request):
    cfg, params, state = jax_load(request.param)
    tcfg, tparams_np, _ = load_dpdist_checkpoint(request.param)
    return request.param, (cfg, params, state), (tcfg, params_from_jax(tparams_np, "cpu"))


def test_forward_and_distance_match_jax(net):
    _, (cfg, params, state), (tcfg, tparams) = net
    pcA, pcB = _inputs()
    jAB, jBA, _ = jax_apply(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB))
    tA, tB = torch.as_tensor(pcA), torch.as_tensor(pcB)
    with torch.no_grad():
        pAB, pBA = apply_dpdist(tparams, tcfg, tA, tB)
        d_mean = dpdist_distance(tparams, tcfg, tA, tB)
        d_pair = dpdist_distance(tparams, tcfg, tA, tB, per_example=True)
    np.testing.assert_allclose(pAB.numpy(), np.asarray(jAB), atol=TOL, rtol=0)
    np.testing.assert_allclose(pBA.numpy(), np.asarray(jBA), atol=TOL, rtol=0)
    for per_example, got in ((False, d_mean), (True, d_pair)):
        want = jax_distance(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB),
                            per_example=per_example)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.asarray(jAB)[..., 0].min() == 0.0   # off-grid points were masked


@pytest.mark.parametrize("n_a", [64, 50])
def test_kernel_mode_on_cpu_takes_plain_path(net, n_a):
    """fused_gather='mfv' on CPU tensors runs the wrapper's plain version:
    same values as 'off', and no kernel launch. Clouds of one size go in one
    2B call, clouds of two sizes in one call per direction."""
    _, _, (tcfg, tparams) = net
    pcA, pcB = (torch.as_tensor(a) for a in _inputs(seed=1))
    pcA = pcA[:, :n_a].contiguous()
    before = mfv_x.launches
    with torch.no_grad():
        d_mfv = dpdist_distance(tparams, tcfg.replace(fused_gather="mfv"), pcA, pcB,
                                per_example=True)
        d_off = dpdist_distance(tparams, tcfg.replace(fused_gather="off"), pcA, pcB,
                                per_example=True)
    np.testing.assert_allclose(d_mfv.numpy(), d_off.numpy(), atol=1e-6, rtol=0)
    assert mfv_x.launches == before


def test_frozen_distance_module(net):
    path, (cfg, params, state), _ = net
    model = load_frozen_distance(path, device="cpu")
    assert not model.training
    assert all(not p.requires_grad for p in model.parameters())
    pcA, pcB = _inputs(seed=2)
    with torch.no_grad():
        got = model(torch.as_tensor(pcA), torch.as_tensor(pcB))
    want = jax_distance(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB),
                        per_example=True)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@functools.partial(jax.jit, static_argnums=(2, 5))
def jax_frozen_value_and_grad(params, state, cfg, pcA, pcB, penalty):
    """JAX's frozen loss and its gradient in pcA, jitted with the
    parameters as arguments so that the two nets share one compile."""
    loss_fn = jax_frozen_loss(params, state, cfg, out_of_grid_penalty=penalty)
    return jax.value_and_grad(loss_fn)(pcA, pcB)


def _golden_section(pcA, pcB):
    """Per net, the per-pair distances, and the frozen loss (penalty 1.0)
    over all pairs with its gradient in pcA for GRAD_PAIRS."""
    section = {"distance": {},
               "frozen_loss": {"out_of_grid_penalty": 1.0, "grad_pairs": list(GRAD_PAIRS)}}
    for path in NETS:
        cfg, params, state = jax_load(path)
        d = jax_distance(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB),
                         per_example=True)
        section["distance"][path] = [float(v) for v in np.asarray(d)]
        value, grad = jax_frozen_value_and_grad(params, state, cfg.replace(fused_gather="off"),
                                                jnp.asarray(pcA), jnp.asarray(pcB), 1.0)
        section["frozen_loss"][path] = {
            "value": float(value),
            "grad_pcA": [[[float("%.8g" % c) for c in p] for p in np.asarray(grad)[i]]
                         for i in GRAD_PAIRS]}
    return section


def compute_golden(fp16=True):
    """The golden file's content, computed with the JAX package: the
    section of _golden_section at 64 points, under LARGE the same at
    NP_LARGE points plus each pair's chamfer and EMD, under BF16 the bf16
    distances of both nets at both sizes, under BF16_GRAD their bf16
    frozen loss and its gradient at both sizes, and, with fp16, under FP16
    and FP16_GRAD the same in float16."""
    golden = {"num_point": 64, "pairs": GOLDEN_PAIRS}
    golden.update(_golden_section(*golden_clouds(golden)))
    pcA, pcB = golden_clouds(golden, NP_LARGE)
    large = {"num_point": NP_LARGE, **_golden_section(pcA, pcB)}
    large["chamfer"] = [float(jax_chamfer(jnp.asarray(pcA[i:i + 1]), jnp.asarray(pcB[i:i + 1])))
                        for i in range(len(pcA))]
    large["emd"] = [float(v) for v in np.asarray(jax_sinkhorn_emd(jnp.asarray(pcA),
                                                                  jnp.asarray(pcB)))]
    golden[LARGE] = large
    golden[BF16] = {mode: {f"np{n}": {} for n in BF16_SIZES} for mode in BF16_MODES}
    for n in BF16_SIZES:
        pcA, pcB = (jnp.asarray(a) for a in golden_clouds(golden, n))
        for path in NETS:
            cfg, params, state = jax_load(path)
            for mode in BF16_MODES:
                d = jax_distance(params, state, cfg.replace(dtype="bfloat16", fused_gather=mode),
                                 pcA, pcB, per_example=True)
                golden[BF16][mode][f"np{n}"][path] = [float(v) for v in np.asarray(d)]
    golden[BF16_GRAD] = {}
    for n in BF16_SIZES:
        pcA, pcB = (jnp.asarray(a) for a in golden_clouds(golden, n))
        section = {"out_of_grid_penalty": 1.0, "grad_pairs": list(GRAD_PAIRS)}
        for path in NETS:
            cfg, params, state = jax_load(path)
            value, grad = jax_frozen_value_and_grad(
                params, state, cfg.replace(dtype="bfloat16", fused_gather="off"), pcA, pcB, 1.0)
            section[path] = {
                "value": float(value),
                "grad_pcA": [[[float("%.8g" % c) for c in p] for p in np.asarray(grad)[i]]
                             for i in GRAD_PAIRS]}
        golden[BF16_GRAD][f"np{n}"] = section
    if not fp16:
        return golden
    golden[FP16] = {mode: {f"np{n}": {} for n in BF16_SIZES} for mode in FP16_MODES}
    golden[FP16_GRAD] = {}
    for n in BF16_SIZES:
        pcA, pcB = (jnp.asarray(a) for a in golden_clouds(golden, n))
        section = {"out_of_grid_penalty": 1.0, "grad_pairs": list(GRAD_PAIRS)}
        for path in NETS:
            cfg, params, state = jax_load(path)
            cfg16 = cfg.replace(dtype="float16")
            for mode in FP16_MODES:
                d = jax_distance(params, state, cfg16.replace(fused_gather=mode), pcA, pcB,
                                 per_example=True)
                golden[FP16][mode][f"np{n}"][path] = [float(v) for v in np.asarray(d)]
            value, grad = jax_frozen_value_and_grad(
                params, state, cfg16.replace(fused_gather="off"), pcA, pcB, 1.0)
            section[path] = {
                "value": float(value),
                "grad_pcA": [[[float("%.8g" % c) for c in p] for p in np.asarray(grad)[i]]
                             for i in GRAD_PAIRS]}
        golden[FP16_GRAD][f"np{n}"] = section
    return golden


@pytest.fixture(scope="module")
def fresh_golden():
    """What dpdist_tpu computes now, but for the float16 sections: those
    are held as stored (tests/test_torch_fp16.py holds JAX's float16
    kernels against the port's live)."""
    return compute_golden(fp16=False)


def test_golden_file_holds(fresh_golden):
    """The committed golden values are what dpdist_tpu computes now, at 64
    and at 256 points, and the port on the CPU reproduces them (the
    distances and, at 256 points, chamfer and EMD)."""
    stored = load_golden()
    fresh = fresh_golden
    assert stored["pairs"] == fresh["pairs"] and stored["num_point"] == fresh["num_point"]
    assert stored[LARGE]["num_point"] == fresh[LARGE]["num_point"] == NP_LARGE
    for section, n in ((stored, None), (stored[LARGE], NP_LARGE)):
        fresh_section = fresh if n is None else fresh[LARGE]
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(stored, n))
        for path in NETS:
            np.testing.assert_allclose(section["distance"][path], fresh_section["distance"][path],
                                       atol=1e-6, rtol=0)
            model = load_frozen_distance(path, device="cpu")
            with torch.no_grad():
                got = model(pcA, pcB).numpy()
            np.testing.assert_allclose(got, section["distance"][path], atol=TOL, rtol=0)
    large = stored[LARGE]
    np.testing.assert_allclose(large["chamfer"], fresh[LARGE]["chamfer"], atol=1e-7, rtol=0)
    np.testing.assert_allclose(large["emd"], fresh[LARGE]["emd"], atol=1e-7, rtol=0)
    pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(stored, NP_LARGE))
    chamfer = [float(chamfer_distance(pcA[i:i + 1], pcB[i:i + 1])) for i in range(len(pcA))]
    np.testing.assert_allclose(chamfer, large["chamfer"], atol=TOL_CHAMFER, rtol=0)
    np.testing.assert_allclose(sinkhorn_emd(pcA, pcB).numpy(), large["emd"], atol=TOL_EMD,
                               rtol=0)


def test_golden_bf16_holds(fresh_golden):
    """The stored bf16 distances are what dpdist_tpu computes now; the
    port's CPU path ("full": fused_forward's plain version; "auto": the
    composed bf16 path) reproduces them; "full" and "auto" agree, and both
    track the float32 golden values."""
    stored = load_golden()
    for n in BF16_SIZES:
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(stored, n))
        f32 = stored["distance"] if n == stored["num_point"] else stored[LARGE]["distance"]
        for path in NETS:
            vals = {}
            for mode in BF16_MODES:
                want = stored[BF16][mode][f"np{n}"][path]
                np.testing.assert_allclose(want, fresh_golden[BF16][mode][f"np{n}"][path],
                                           atol=1e-6, rtol=0)
                model = load_frozen_distance(path, device="cpu", dtype="bfloat16",
                                             fused_gather=mode)
                with torch.no_grad():
                    got = model(pcA, pcB).numpy()
                np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
                np.testing.assert_allclose(want, f32[path], atol=TOL_BF16_VS_F32, rtol=0)
                vals[mode] = want
            np.testing.assert_allclose(vals["full"], vals["auto"], atol=TOL_FULL_VS_COMPOSED,
                                       rtol=0)


def test_golden_bf16_grad_holds(fresh_golden):
    """The stored bf16 frozen-loss values and pcA gradients are what
    dpdist_tpu computes now, at 64 and 256 points, and the port's CPU path
    meets them by the bf16 criterion."""
    golden = load_golden()
    for n in BF16_SIZES:
        stored, fresh = golden[BF16_GRAD][f"np{n}"], fresh_golden[BF16_GRAD][f"np{n}"]
        assert stored["grad_pairs"] == list(GRAD_PAIRS)
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(golden, n))
        for path in NETS:
            want = stored[path]
            assert abs(want["value"] - fresh[path]["value"]) <= 1e-6
            np.testing.assert_allclose(want["grad_pcA"], fresh[path]["grad_pcA"], rtol=1e-6,
                                       atol=0)
            cfg, params, _ = load_dpdist_checkpoint(path)
            loss_fn = make_frozen_dpdist_loss(params_from_jax(params, "cpu"),
                                              cfg.replace(dtype="bfloat16"),
                                              out_of_grid_penalty=stored["out_of_grid_penalty"])
            a = pcA.clone().requires_grad_(True)
            value = loss_fn(a, pcB)
            (grad,) = torch.autograd.grad(value, a)
            assert abs(float(value.detach()) - want["value"]) <= TOL_BF16_LOSS
            got, ref = grad.numpy()[list(GRAD_PAIRS)], np.asarray(want["grad_pcA"])
            err = np.abs(got - ref).max(axis=-1) / np.abs(ref).max()
            cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref)))
            assert err.max() <= REL_BF16_FEW and np.mean(err > REL_BF16) <= OUTLIERS_BF16
            assert cos >= MIN_COS_BF16


def test_golden_fp16_holds():
    """The stored fp16 distances (JAX's plain composition and its table
    kernels): the port's CPU path in float16 (the wrappers' plain versions
    under "table") reproduces them within TOL_FP16; JAX's two paths agree
    within it, and both track the float32 golden values within
    TOL_FP16_VS_F32."""
    stored = load_golden()
    for n in BF16_SIZES:
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(stored, n))
        f32 = stored["distance"] if n == stored["num_point"] else stored[LARGE]["distance"]
        for path in NETS:
            vals = {}
            for mode in FP16_MODES:
                want = stored[FP16][mode][f"np{n}"][path]
                model = load_frozen_distance(path, device="cpu", dtype="float16",
                                             fused_gather=mode)
                with torch.no_grad():
                    got = model(pcA, pcB).numpy()
                np.testing.assert_allclose(got, want, atol=TOL_FP16, rtol=0)
                np.testing.assert_allclose(want, f32[path], atol=TOL_FP16_VS_F32, rtol=0)
                vals[mode] = want
            np.testing.assert_allclose(vals["off"], vals["table"], atol=TOL_FP16, rtol=0)


def test_golden_fp16_grad_holds():
    """The stored fp16 frozen-loss values and pcA gradients at 64 and 256
    points: the port's CPU path meets them, the loss within TOL_FP16,
    d/dpcA by the bf16 criterion."""
    golden = load_golden()
    for n in BF16_SIZES:
        stored = golden[FP16_GRAD][f"np{n}"]
        assert stored["grad_pairs"] == list(GRAD_PAIRS)
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(golden, n))
        for path in NETS:
            want = stored[path]
            cfg, params, _ = load_dpdist_checkpoint(path)
            loss_fn = make_frozen_dpdist_loss(params_from_jax(params, "cpu"),
                                              cfg.replace(dtype="float16"),
                                              out_of_grid_penalty=stored["out_of_grid_penalty"])
            a = pcA.clone().requires_grad_(True)
            value = loss_fn(a, pcB)
            (grad,) = torch.autograd.grad(value, a)
            assert abs(float(value.detach()) - want["value"]) <= TOL_FP16
            got, ref = grad.numpy()[list(GRAD_PAIRS)], np.asarray(want["grad_pcA"])
            err = np.abs(got - ref).max(axis=-1) / np.abs(ref).max()
            cos = float((got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref)))
            assert err.max() <= REL_BF16_FEW and np.mean(err > REL_BF16) <= OUTLIERS_BF16
            assert cos >= MIN_COS_BF16


def _close_rel(got, want):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    assert err.max() <= REL_GRAD_FEW, err.max()
    assert np.mean(err > REL_GRAD) <= OUTLIERS, np.sort(err.ravel())[-8:]


def test_golden_frozen_loss_holds(fresh_golden):
    """The stored frozen-loss values and pcA gradients are what dpdist_tpu
    computes now, at 64 and at 256 points, and the port's plain path on the
    CPU reproduces them."""
    golden = load_golden()
    for n, stored, fresh in ((None, golden["frozen_loss"], fresh_golden["frozen_loss"]),
                             (NP_LARGE, golden[LARGE]["frozen_loss"],
                              fresh_golden[LARGE]["frozen_loss"])):
        assert stored["grad_pairs"] == list(GRAD_PAIRS)
        pcA, pcB = (torch.as_tensor(a) for a in golden_clouds(golden, n))
        for path in NETS:
            want = stored[path]
            assert abs(want["value"] - fresh[path]["value"]) <= 1e-6
            np.testing.assert_allclose(want["grad_pcA"], fresh[path]["grad_pcA"], rtol=1e-6,
                                       atol=0)
            cfg, params, _ = load_dpdist_checkpoint(path)
            loss_fn = make_frozen_dpdist_loss(params_from_jax(params, "cpu"), cfg,
                                              out_of_grid_penalty=stored["out_of_grid_penalty"])
            a = pcA.clone().requires_grad_(True)
            value = loss_fn(a, pcB)
            (grad,) = torch.autograd.grad(value, a)
            assert abs(float(value.detach()) - want["value"]) <= TOL
            _close_rel(grad.numpy()[list(GRAD_PAIRS)], np.asarray(want["grad_pcA"]))


def test_table_mode_on_cpu_equals_off(net):
    """fused_gather="table" on CPU tensors runs the wrappers' plain
    versions inside their autograd Function: the same predictions as "off",
    the same input gradients to float rounding (the adjoint sums in another
    order), and no kernel launch."""
    _, _, (tcfg, tparams) = net
    pcA, pcB = _inputs(seed=4, B=2)
    co = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 64, 3)).astype(np.float32))
    outs = []
    for mode in ("table", "off"):
        a, b = torch.tensor(pcA, requires_grad=True), torch.tensor(pcB, requires_grad=True)
        pAB, pBA = apply_dpdist(tparams, tcfg.replace(fused_gather=mode), a, b)
        grads = torch.autograd.grad(((pAB + pBA) * co).sum(), (a, b))
        outs.append((pAB.detach(), pBA.detach()) + grads)
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-5)
    assert table_gather_x.launches == 0 and table_gather_bwd.launches == 0


def test_eval_pair_cli_matches_jax(capsys):
    from dpdist_tpu.data.synthetic import synthetic_surface as jax_surface
    from dpdist_tpu_torch.cli.eval_pair import main

    main(["--dpdist_ckpt", NETS[0], "--device", "cpu", "--seed", "3"])
    got = json.loads(capsys.readouterr().out)["dpdist"]
    cfg, params, state = jax_load(NETS[0])
    pcA, pcB = (jnp.asarray(jax_surface("chair", seed=s, n_points=64)[None] * 0.8)
                for s in (3, 4))
    want = float(jax_distance(params, state, cfg, pcA, pcB))
    assert abs(got - want) <= TOL


def test_entry_points_default_to_cuda():
    """Without a card, the entry points raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        load_frozen_distance(NETS[0])
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(load_dpdist_checkpoint(NETS[0])[1])
    from dpdist_tpu_torch.data import gtgen

    q, d = np.zeros((4, 3), np.float32), np.ones((5, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        gtgen.min_distances(q, d)
    with pytest.raises(RuntimeError, match="cuda"):
        gtgen.generate_gt_for_points(d, num_neg_points=4)
    with pytest.raises(RuntimeError, match="cuda"):
        gtgen.generate_synthetic_dataset("unused", n_train=1, n_test=0, n_surface=8,
                                         num_neg_points=4)
    # Registration: the policy, its trainer, the evaluator and the four CLIs.
    from dpdist_tpu_torch.cli import eval_matrix, eval_registration, make_templates, train_pcrnet
    from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
    from dpdist_tpu_torch.eval.registration import evaluate_registration
    from dpdist_tpu_torch.models.pcrnet import init_pcrnet
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    pcfg = PCRNetConfig(num_point=16, out_features=16, head_widths=(16,))
    with pytest.raises(RuntimeError, match="cuda"):
        init_pcrnet(pcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        PCRNetTrainer(pcfg, TrainConfig(), run_dir="unused")
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_registration(init_pcrnet(pcfg, device="cpu"), pcfg, dataset=None)
    for cli, args in ((train_pcrnet, ["--loss_type", "chamfer", "--log_dir", "unused"]),
                      (eval_registration, ["--ckpt", "results/policy_mf_tsn1200clip_dpdist_final",
                                           "--report_dir", "unused"]),
                      (eval_matrix, ["--ckpts", "results/policy_mf_tsn1200clip_dpdist_final",
                                     "--out_dir", "unused"]),
                      (make_templates, ["--out_dir", "unused"])):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(args)
    assert not os.path.exists("unused")


@pytest.mark.parametrize("change", [
    {"encoder": "pointnet", "k": 0},                 # the variants: ported
    {"conv_version": 3},
    {"use_bn": True},
    {"dtype": "bfloat16"},                           # bf16 gradients: ported
    {"fused_gather": "full", "dtype": "bfloat16"},   # the fused serving kernel has no VJP
    {"fused_gather": "on", "dtype": "bfloat16"},     # bf16 gradients: ported
    {"dims": 2, "embedding_size": 64},
    {"k": 0},
    {"full_fv": False},
])
def test_unported_configs_raise(change):
    """Under autograd (pcA needs a gradient) bf16 fused_gather="full"
    raises NotImplementedError, as the reference refuses its gradient.
    Every other config computes the gradient: the bf16 configs that the
    reference differentiates ("auto" and "on"; their parity with JAX:
    tests/test_torch_bf16_grad.py), the DPDist variants (their parity with
    JAX: tests/test_torch_variants.py) and float16 (tests/test_torch_fp16.py
    and the golden fp16 sections)."""
    cfg = DPDistConfig(mlp=(16, 16, 16), pointnet_embedding=16).replace(**change)
    pcA, pcB = (torch.as_tensor(a[..., :cfg.dims].copy()) for a in _inputs(B=1, N=8))
    if change.get("fused_gather") == "full":
        params = {"decoder": {"layers": []}}
        with pytest.raises(NotImplementedError, match="refuses"):
            apply_dpdist(params, cfg, pcA.requires_grad_(True), pcB)
        return
    params, state = init_dpdist(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    a = pcA.requires_grad_(True)
    (grad,) = torch.autograd.grad(dpdist_distance(params, cfg, a, pcB, state=state), a)
    assert grad.shape == a.shape and bool(torch.isfinite(grad).all())


def test_unported_params_raise():
    """Every DPDist tree the JAX package builds converts (the BN decoder and
    the pointnet encoder among them; tests/test_torch_variants.py holds
    each against JAX); a tree without a decoder is not a DPDist tree."""
    layers = [{"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)}]
    bn = [{"scale": np.ones(2, np.float32), "offset": np.zeros(2, np.float32)}]
    got = params_from_jax({"decoder": {"layers": layers, "bn": bn}, "pointnet": {"layers": layers}},
                          "cpu")
    assert torch.equal(got["decoder"]["bn"][0]["scale"], torch.ones(2))
    assert got["pointnet"]["layers"][0]["w"].shape == (3, 2)
    with pytest.raises(ValueError, match="decoder"):
        params_from_jax({"pointnet": {"layers": layers}}, "cpu")


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_dpdist.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    with open(GOLDEN_PATH, "w") as f:
        json.dump(compute_golden(), f, indent=1)
        f.write("\n")
    print("wrote", GOLDEN_PATH)
