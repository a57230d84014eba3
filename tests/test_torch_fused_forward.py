"""bfloat16 serving: the fused gather + decoder (kernels/fused_forward.py,
the plain version of csrc/fused_forward.cu) and the bf16 model paths
against dpdist_tpu, the bf16 outputs of the gather wrappers, the routing
of fused_gather="full", and the bf16 gradient paths, which raise.

JAX runs its fused_forward Pallas kernel in interpret mode on the CPU, as
its own tests do; its composed bf16 path is the XLA composition there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.kernels.fused_forward_pallas import fused_forward as jax_fused_forward
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.models.dpdist import _fused_gather_mode as jax_fused_gather_mode
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.kernels.fused_forward import (
    PackedDecoder,
    fused_forward,
    fused_forward_plain,
    pack_decoder,
)
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_plain,
    table_gather_x,
    table_gather_x_plain,
)
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import apply_direction, apply_dpdist, resolve_for_grad
from dpdist_tpu_torch.models.dpdist import Route, route
from dpdist_tpu_torch.ops.voxel import voxel_assign
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train import params_from_jax
from dpdist_tpu_torch.train.trainer import DPDistTrainer

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
BF16 = torch.bfloat16
# fused_forward's plain version against the Pallas kernel on the same bf16
# inputs: both sum exact bf16 products in float32, in other orders, so a
# hidden activation at a bf16 rounding edge may round the other way (at
# these sizes none did: the outputs were equal).
TOL_FF = 1e-4
# The bf16 model paths, port against JAX: the same reason; measured up to
# 1.8e-5 on the committed nets' golden distances.
TOL_BF16 = 1e-4
# "full" against the composed bf16 path, and bf16 against float32: the
# JAX package's own bounds (tests/test_kernels.py:146-166,
# tests/test_dpdist_model.py:37-56).
TOL_FULL_VS_COMPOSED, TOL_BF16_VS_F32 = 2e-3, 0.03


@pytest.fixture(scope="module")
def small_net():
    jcfg = JaxConfig(**SMALL)
    params, state = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return jcfg, params, state, tparams


def _clouds(seed, B=2, N=16):
    """pcA inside the grid; pcB with its first three points far off it."""
    r = np.random.default_rng(seed)
    pcA = r.uniform(-0.8, 0.8, (B, N, 3)).astype(np.float32)
    pcB = r.uniform(-0.8, 0.8, (B, N, 3)).astype(np.float32)
    pcB[:, :3] = 5.0
    return pcA, pcB


def test_pack_decoder_layout(small_net):
    """W1's rows as [W1[3:]; W1[:3]; zeros up to a multiple of 16], every
    value rounded to bf16 once, the head transposed."""
    _, _, _, tparams = small_net
    layers = tparams["decoder"]["layers"]
    p = pack_decoder(layers)
    w1 = layers[0]["w"]
    in_dim = w1.shape[0]
    assert isinstance(p, PackedDecoder) and p.in_dim == in_dim == 3 + 27 * 20
    assert p.w[0].dtype == BF16 and p.w[0].shape == (-(-in_dim // 16) * 16, 32)
    assert torch.equal(p.w[0][:in_dim - 3], w1[3:].to(BF16))
    assert torch.equal(p.w[0][in_dim - 3:in_dim], w1[:3].to(BF16))
    assert not p.w[0][in_dim:].any()
    assert len(p.w) == len(p.b) == len(layers) - 1
    for i in range(1, len(p.w)):
        assert torch.equal(p.w[i], layers[i]["w"].to(BF16))
    for b, lp in zip(p.b, layers):
        assert b.dtype == torch.float32 and torch.equal(b, lp["b"].to(BF16).float())
    assert torch.equal(p.w_out, layers[-1]["w"].t().to(BF16).float())
    assert torch.equal(p.b_out, layers[-1]["b"].to(BF16).float())


@pytest.mark.parametrize("g,k", [(4, 3), (8, 5)])
def test_plain_matches_pallas_interpret(small_net, g, k):
    """fused_forward_plain against JAX's fused_forward(interpret=True) on
    the same bf16 volumes, voxels and deltas (queries partly off the grid),
    for the small decoder over its window and over the canonical one."""
    jcfg, _, _, _ = small_net
    jcfg = jcfg.replace(embedding_size=g ** 3, k=k)
    params, _ = jax_init(jax.random.PRNGKey(1), jcfg)
    r = np.random.default_rng(2)
    fv = r.normal(0, 0.3, (4, g ** 3, 20)).astype(np.float32)
    q = r.uniform(-1.2, 1.2, (4, 16, 3)).astype(np.float32)
    jfv = jnp.asarray(fv).astype(jnp.bfloat16)
    jv, _, jd = jax_voxel_assign(jnp.asarray(q), g)
    want = np.asarray(jax_fused_forward(jfv, jv, jd, params["decoder"]["layers"], g, k,
                                        interpret=True))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tv, tm, td = voxel_assign(torch.as_tensor(q), g)
    assert float(tm.min()) == 0.0
    before = fused_forward.launches
    got = fused_forward(torch.as_tensor(fv).to(BF16), tv, td,
                        pack_decoder(tparams["decoder"]["layers"]), g, k)
    assert fused_forward.launches == before
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FF, rtol=0)


@pytest.mark.parametrize("N", [16, 150])
def test_bf16_model_paths_match_jax(small_net, N):
    """"full" and the composed bf16 path ("auto", the XLA composition on
    the CPU) against JAX's; off-grid rows exactly 0; "full" against the
    composed path within 2e-3 and both against float32 within 0.03."""
    jcfg, params, state, tparams = small_net
    pcA, pcB = _clouds(3, N=N)
    ja, jb = jnp.asarray(pcA), jnp.asarray(pcB)
    ta, tb = torch.as_tensor(pcA), torch.as_tensor(pcB)
    jf32 = jax_apply(params, state, jcfg, ja, jb)[:2]
    preds = {}
    for mode in ("full", "auto"):
        want = jax_apply(params, state, jcfg.replace(dtype="bfloat16", fused_gather=mode),
                         ja, jb)[:2]
        with torch.no_grad():
            got = apply_dpdist(tparams, DPDistConfig(**SMALL, dtype="bfloat16",
                                                     fused_gather=mode), ta, tb)
        for g_, w_, f_ in zip(got, want, jf32):
            assert g_.dtype == torch.float32
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=TOL_BF16, rtol=0)
            np.testing.assert_allclose(g_.numpy(), np.asarray(f_), atol=TOL_BF16_VS_F32, rtol=0)
        assert not got[0][:, :3].any()   # off-grid queries of B: exactly 0
        preds[mode] = got
    for f_, c_ in zip(preds["full"], preds["auto"]):
        np.testing.assert_allclose(f_.numpy(), c_.numpy(), atol=TOL_FULL_VS_COMPOSED, rtol=0)


def test_bf16_table_on_and_mfv_paths_equal_the_composed_path(small_net):
    """"table", "on" and "mfv" in bf16 (forward): the gather wrappers write
    bf16 ("table", "mfv") or the decoder rounds ("on"); on the CPU each
    equals the composed bf16 path, since every path rounds the same x
    once (off-grid rows differ only before the mask)."""
    _, _, _, tparams = small_net
    ta, tb = (torch.as_tensor(a) for a in _clouds(4))
    cfg = DPDistConfig(**SMALL, dtype="bfloat16")
    with torch.no_grad():
        want = apply_dpdist(tparams, cfg.replace(fused_gather="off"), ta, tb)
        for mode in ("table", "on", "mfv"):
            got = apply_dpdist(tparams, cfg.replace(fused_gather=mode), ta, tb)
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_), mode


def test_full_in_train_mode_runs_table(small_net):
    """train=True keeps bf16 "full" off the eval-only kernel: the table
    path, as the reference's apply_dpdist(train=True)."""
    _, _, _, tparams = small_net
    ta, tb = (torch.as_tensor(a) for a in _clouds(5))
    cfg = DPDistConfig(**SMALL, dtype="bfloat16")
    with torch.no_grad():
        got = apply_dpdist(tparams, cfg.replace(fused_gather="full"), ta, tb, train=True)
        want = apply_dpdist(tparams, cfg.replace(fused_gather="table"), ta, tb)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("n_a,n_b,kw,want", [
    (64, 64, {}, Route("full", ("plain",) * 2, ("fused_forward",) * 2)),
    (256, 256, {}, Route("full", ("threedmfv",) * 2, ("fused_forward",) * 2)),
    (64, 64, {"train": True}, Route("table", ("plain",) * 2, ("table_gather_x",) * 2)),
    (256, 256, {"train": True}, Route("table", ("threedmfv",) * 2, ("table_gather",) * 2)),
    (64, 64, {"dtype": "float32"}, Route("table", ("plain",) * 2, ("table_gather_x",) * 2)),
])
def test_route_full(n_a, n_b, kw, want):
    cfg = DPDistConfig(fused_gather="full", dtype=kw.pop("dtype", "bfloat16"))
    for device in ("cuda", "cpu"):
        assert route(cfg, device, n_a, n_b, **kw) == want


@pytest.mark.parametrize("fused_gather", ["full", "auto", "table", "on"])
def test_route_mode_in_bf16_is_the_reference_mode_on_its_accelerator(monkeypatch, fused_gather):
    """A bf16 forward's mode before the size rules is what the reference
    resolves on its accelerator (its _on_tpu patched to True)."""
    monkeypatch.setattr(importlib.import_module("dpdist_tpu.ops.threedmfv"), "_on_tpu",
                        lambda: True)
    want = jax_fused_gather_mode(JaxConfig(dtype="bfloat16", fused_gather=fused_gather))
    got = route(DPDistConfig(dtype="bfloat16", fused_gather=fused_gather), "cuda", 64, 64)
    assert got.mode == want


def test_route_full_needs_clouds_of_one_size():
    with pytest.raises(ValueError, match="one size"):
        route(DPDistConfig(fused_gather="full", dtype="bfloat16"), "cuda", 64, 100)


@pytest.mark.parametrize("mode", ["auto", "mfv", "table", "on", "full", "off"])
def test_bf16_gradient_paths_raise(small_net, mode, tmp_path):
    """A bf16 config under autograd raises NotImplementedError, whichever
    way the gradient is asked for: an input or a parameter that needs one,
    the frozen loss, resolve_for_grad, route(grad=True), FrozenDistance on
    inputs that need a gradient, and the trainer."""
    _, _, _, tparams = small_net
    cfg = DPDistConfig(**SMALL, dtype="bfloat16", fused_gather=mode)
    pcA, pcB = (torch.as_tensor(a) for a in _clouds(6))
    a = pcA.clone().requires_grad_(True)
    match = "bf16 gradient"
    with pytest.raises(NotImplementedError, match=match):
        apply_dpdist(tparams, cfg, a, pcB)
    with pytest.raises(NotImplementedError, match=match):
        apply_direction(tparams, cfg, pcB, a)
    with pytest.raises(NotImplementedError, match=match):
        make_frozen_dpdist_loss(tparams, cfg)(a, pcB)
    with pytest.raises(NotImplementedError, match=match):
        resolve_for_grad(cfg, "cuda")
    with pytest.raises(NotImplementedError, match=match):
        route(cfg, "cuda", 16, 16, grad=True)
    grad_params = {"decoder": {"layers": [{k: t.clone().requires_grad_(True) for k, t in
                                           lp.items()} for lp in tparams["decoder"]["layers"]]}}
    with pytest.raises(NotImplementedError, match=match):
        apply_dpdist(grad_params, cfg, pcA, pcB)
    with pytest.raises(NotImplementedError, match=match):
        DPDistTrainer(cfg, TrainConfig(batch_size=2), run_dir=str(tmp_path), device="cpu")
    with torch.no_grad():   # no autograd: the forward runs
        out = apply_dpdist(grad_params, cfg, a, pcB)
    assert all(bool(torch.isfinite(t).all()) for t in out)


def test_frozen_distance_full_bf16():
    """load_frozen_distance(dtype="bfloat16", fused_gather="full") on the
    CPU: the module holds the pack, serves under no_grad and on inputs that
    need none, and raises under autograd rather than run another path."""
    model = load_frozen_distance("results/ckpt_best", device="cpu", dtype="bfloat16",
                                 fused_gather="full")
    assert isinstance(model.packed, PackedDecoder)
    assert load_frozen_distance("results/ckpt_best", device="cpu",
                                dtype="bfloat16").packed is None
    pcA, pcB = (torch.as_tensor(a) for a in _clouds(7, N=64))
    before = fused_forward.launches
    d = model(pcA, pcB)
    with torch.no_grad():
        assert torch.equal(model(pcA, pcB), d)
    assert fused_forward.launches == before
    assert d.shape == (2,) and bool(torch.isfinite(d).all())
    with pytest.raises(NotImplementedError, match="bf16 gradient"):
        model(pcA.clone().requires_grad_(True), pcB)


def _fused_args(**change):
    r = np.random.default_rng(8)
    fv = torch.as_tensor(r.normal(size=(2, 64, 20)).astype(np.float32)).to(BF16)
    vox, _, delta = voxel_assign(torch.as_tensor(r.uniform(-1, 1, (2, 8, 3)).astype(np.float32)),
                                 4)
    layers = [{"w": torch.zeros(543, 32), "b": torch.zeros(32)},
              {"w": torch.zeros(32, 3), "b": torch.zeros(3)}]
    args = {"fv": fv, "vox": vox, "delta": delta, "packed": pack_decoder(layers),
            "grid_size": 4, "k": 3}
    args.update(change)
    return args


@pytest.mark.parametrize("case,exc", [
    ({"fv": torch.zeros(2, 64, 20)}, TypeError),                    # float32 volume
    ({"vox": torch.zeros(2, 8, dtype=torch.int64)}, TypeError),
    ({"delta": torch.zeros(2, 8, 3, dtype=torch.float64)}, TypeError),
    ({"packed": {"decoder": {}}}, TypeError),
    ({"delta": torch.zeros(2, 7, 3)}, ValueError),
    ({"grid_size": 5}, ValueError),
    ({"k": 5}, ValueError),                                          # 3 + 125*20 inputs
    ({"fv": torch.zeros(2, 20, 64, dtype=BF16).transpose(1, 2)}, ValueError),
    ({"fv": torch.zeros(2, 64, 20, dtype=BF16, requires_grad=True)}, RuntimeError),
])
def test_fused_forward_rejects_what_the_kernel_does_not_take(case, exc):
    with pytest.raises(exc):
        fused_forward(**_fused_args(**case))


@pytest.mark.parametrize("widths", [(33, 3), (1040, 3), (32,)])
def test_pack_decoder_rejects_widths_the_kernel_does_not_take(widths):
    layers, d = [], 543
    for w in widths:
        layers.append({"w": torch.zeros(d, w), "b": torch.zeros(w)})
        d = w
    with pytest.raises(ValueError):
        pack_decoder(layers)


def test_gather_wrappers_bf16_outputs_on_cpu():
    """Rows 1, 2 and 6 with dtype=bfloat16 on CPU tensors: the plain
    versions rounded once, no launch, and no bf16 backward."""
    r = np.random.default_rng(9)
    pts = torch.as_tensor(r.uniform(-0.9, 0.9, (2, 16, 3)).astype(np.float32))
    q = torch.as_tensor(r.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32))
    fv = torch.as_tensor(r.normal(size=(2, 64, 20)).astype(np.float32))
    counts = (mfv_x.launches, table_gather_x.launches, table_gather.launches)
    x, vox = mfv_x(pts, q, 64, 0.25, 4, 3, dtype=BF16)
    assert x.dtype == BF16 and torch.equal(x, mfv_x_plain(pts, q, 64, 0.25, 4, 3)[0].to(BF16))
    x, vox = table_gather_x(fv, q, 4, 3, dtype=BF16)
    assert x.dtype == BF16 and torch.equal(x, table_gather_x_plain(fv, q, 4, 3)[0].to(BF16))
    out = table_gather(fv, vox, 4, 3, dtype=BF16)
    assert out.dtype == BF16 and torch.equal(out, table_gather_plain(fv, vox, 4, 3).to(BF16))
    assert (mfv_x.launches, table_gather_x.launches, table_gather.launches) == counts
    with pytest.raises(NotImplementedError, match="bf16 gradient"):
        mfv_x(pts.clone().requires_grad_(True), q, 64, 0.25, 4, 3, dtype=BF16)
    with pytest.raises(NotImplementedError, match="bf16 gradient"):
        table_gather_x(fv.clone().requires_grad_(True), q, 4, 3, dtype=BF16)
    with pytest.raises(NotImplementedError, match="bf16 gradient"):
        table_gather(fv.clone().requires_grad_(True), vox, 4, 3, dtype=BF16)
    with pytest.raises(TypeError):
        table_gather(fv, vox, 4, 3, dtype=torch.float16)

