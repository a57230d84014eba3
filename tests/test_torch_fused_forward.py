"""bfloat16 serving: the fused gather + decoder (kernels/fused_forward.py,
the plain version of csrc/fused_forward.cu) and the bf16 model paths
against dpdist_tpu, the bf16 outputs of the gather wrappers, the routing
of fused_gather="full", and the bf16 gradient paths (held against JAX;
"full" raises under autograd, as JAX refuses its gradient).

JAX runs its fused_forward Pallas kernel in interpret mode on the CPU, as
its own tests do; its composed bf16 path is the XLA composition there.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
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
from dpdist_tpu_torch.ops.voxel import extract_patches, gather_patches, voxel_assign
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
# The bf16 gradient paths against JAX's bf16 frozen loss: the criterion of
# tests/test_torch_bf16_grad.py (the loss; d/dpcA per point relative to the
# largest |g|, and its cosine).
TOL_BF16_LOSS, REL_GRAD, OUTLIERS, REL_GRAD_FEW, MIN_COS = 2e-3, 1e-2, 0.05, 5e-2, 0.999


def close_grads(got, want):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert err.max() <= REL_GRAD_FEW and np.mean(err > REL_GRAD) <= OUTLIERS, err.max()
    assert cos >= MIN_COS, cos


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
    """Each W stored K-major (W^T), K and the widths padded with zeros to
    multiples of 64: W1's rows as [W1[3:]; W1[:3]; 0 ...], zero biases and
    zero head columns in the padding; every value rounded to bf16 once."""
    _, _, _, tparams = small_net
    layers = tparams["decoder"]["layers"]
    p = pack_decoder(layers)
    w1 = layers[0]["w"]
    in_dim = w1.shape[0]
    assert isinstance(p, PackedDecoder) and p.in_dim == in_dim == 3 + 27 * 20
    assert p.w[0].dtype == BF16 and p.w[0].shape == (64, -(-in_dim // 64) * 64)
    assert torch.equal(p.w[0][:32, :in_dim - 3], w1[3:].t().to(BF16))
    assert torch.equal(p.w[0][:32, in_dim - 3:in_dim], w1[:3].t().to(BF16))
    assert not p.w[0][:, in_dim:].any() and not p.w[0][32:].any()
    assert len(p.w) == len(p.b) == len(layers) - 1
    for i in range(1, len(p.w)):
        assert p.w[i].shape == (64, 64) and p.w[i].is_contiguous()
        assert torch.equal(p.w[i][:32, :32], layers[i]["w"].t().to(BF16))
        assert not p.w[i][32:].any() and not p.w[i][:, 32:].any()
    for b, lp in zip(p.b, layers):
        assert b.dtype == torch.float32 and b.shape == (64,)
        assert torch.equal(b[:32], lp["b"].to(BF16).float()) and not b[32:].any()
    assert p.w_out.shape == (3, 64)
    assert torch.equal(p.w_out[:, :32], layers[-1]["w"].t().to(BF16).float())
    assert not p.w_out[:, 32:].any()
    assert torch.equal(p.b_out, layers[-1]["b"].to(BF16).float())


@pytest.mark.parametrize("widths", [(32, 32, 32, 3), (48, 96, 1), (1024, 1024, 1024, 3)])
def test_plain_on_the_padded_pack_matches_the_unpadded_decoder(widths):
    """fused_forward_plain over the padded pack against the reference
    kernel's arithmetic written out on the unpadded layers: the padded
    units are relu(0) = 0 and meet zero rows, so only float32 rounding
    (sums of another length) may differ (1e-5 relative)."""
    r = np.random.default_rng(21)
    g, k, C = 4, 3, 20
    in_dim = 3 + k ** 3 * C
    layers, d = [], in_dim
    for w in widths:
        lim = np.sqrt(6.0 / (d + w))
        layers.append({"w": torch.as_tensor(r.uniform(-lim, lim, (d, w)).astype(np.float32)),
                       "b": torch.as_tensor(r.normal(0, 0.1, w).astype(np.float32))})
        d = w
    fv = torch.as_tensor(r.normal(0, 0.3, (3, g ** 3, C)).astype(np.float32)).to(BF16)
    vox, _, delta = voxel_assign(torch.as_tensor(r.uniform(-1.2, 1.2, (3, 40, 3))
                                                 .astype(np.float32)), g)
    got = fused_forward_plain(fv, vox, delta, pack_decoder(layers), g, k)

    def rnd(t):
        return t.to(BF16).float()

    emb = gather_patches(extract_patches(fv.float(), g, k), vox)
    w1 = rnd(layers[0]["w"])
    h = torch.relu(emb @ w1[3:] + rnd(delta) @ w1[:3] + rnd(layers[0]["b"]))
    for lp in layers[1:-1]:
        h = torch.relu(rnd(h) @ rnd(lp["w"]) + rnd(lp["b"]))
    want = rnd(h) @ rnd(layers[-1]["w"]) + rnd(layers[-1]["b"])
    assert got.shape == want.shape == (3, 40, widths[-1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


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


@functools.partial(jax.jit, static_argnums=(2,))
def jax_bf16_loss_and_grad(params, state, cfg, pcA, pcB):
    """JAX's frozen loss and its gradient in pcA, jitted once per config."""
    return jax.value_and_grad(jax_frozen_loss(params, state, cfg))(pcA, pcB)


@pytest.mark.parametrize("mode", ["auto", "mfv", "table", "on", "full", "off"])
def test_bf16_gradient_paths_raise(small_net, mode, tmp_path):
    """bf16 configs under autograd, whichever way the gradient is asked
    for: an input or a parameter that needs one, the frozen loss,
    resolve_for_grad, route(grad=True) and the trainer. Five modes compute
    the gradient, the frozen loss and d/dpcA held against JAX's bf16
    frozen loss (its XLA composition on the CPU) by the criterion of
    tests/test_torch_bf16_grad.py. "full" raises NotImplementedError
    outside training, as JAX refuses a gradient through its fused kernel;
    the trainer (train=True) runs it as "table". (Until the bf16 gradient
    paths were ported, every mode raised.)"""
    jcfg, params, state, tparams = small_net
    cfg = DPDistConfig(**SMALL, dtype="bfloat16", fused_gather=mode)
    pcA, pcB = (torch.as_tensor(a) for a in _clouds(6))
    a = pcA.clone().requires_grad_(True)
    grad_params = {"decoder": {"layers": [{k: t.clone().requires_grad_(True) for k, t in
                                           lp.items()} for lp in tparams["decoder"]["layers"]]}}
    DPDistTrainer(cfg, TrainConfig(batch_size=2), run_dir=str(tmp_path), device="cpu")
    assert resolve_for_grad(cfg, "cuda").fused_gather == ("table" if mode == "auto" else mode)
    if mode == "full":
        match = "refuses"
        with pytest.raises(NotImplementedError, match=match):
            apply_dpdist(tparams, cfg, a, pcB)
        with pytest.raises(NotImplementedError, match=match):
            apply_direction(tparams, cfg, pcB, a)
        with pytest.raises(NotImplementedError, match=match):
            make_frozen_dpdist_loss(tparams, cfg)(a, pcB)
        with pytest.raises(NotImplementedError, match=match):
            route(cfg, "cuda", 16, 16, grad=True)
        with pytest.raises(NotImplementedError, match=match):
            apply_dpdist(grad_params, cfg, pcA, pcB)
        with torch.no_grad():   # no autograd: the forward runs
            out = apply_dpdist(grad_params, cfg, a, pcB)
        assert all(bool(torch.isfinite(t).all()) for t in out)
        return
    assert route(cfg, "cuda", 16, 16, grad=True).mode in ("table", "on", "mfv", "off")
    want, jgrad = jax_bf16_loss_and_grad(params, state,
                                         jcfg.replace(dtype="bfloat16", fused_gather="off"),
                                         jnp.asarray(pcA.numpy()), jnp.asarray(pcB.numpy()))
    value = make_frozen_dpdist_loss(tparams, cfg)(a, pcB)
    (grad,) = torch.autograd.grad(value, a)
    assert abs(float(value.detach()) - float(want)) <= TOL_BF16_LOSS
    close_grads(grad.numpy(), np.asarray(jgrad))
    (g_dir,) = torch.autograd.grad(apply_direction(tparams, cfg, pcB, a).sum(), a)
    pred_AB, pred_BA = apply_dpdist(grad_params, cfg, pcA, pcB)
    leaves = [t for lp in grad_params["decoder"]["layers"] for t in lp.values()]
    g_params = torch.autograd.grad((pred_AB + pred_BA).sum(), leaves)
    assert all(bool(torch.isfinite(t).all()) for t in (g_dir,) + g_params)
    assert all(t.dtype == torch.float32 for t in g_params)


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
    versions rounded once, no launch, and a backward (the bf16 adjoint's
    dfv returned to float32, then the encode's replay for row 1) equal to
    autograd through the plain composition with the same rounding points.
    (Until the bf16 gradient paths were ported, the backward raised.)"""
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
    co = torch.as_tensor(r.normal(size=(2, 16, 3 + 27 * 20)).astype(np.float32)).to(BF16)

    def grads(fn, *inputs):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        y = fn(*leaves).float()
        return torch.autograd.grad((y * co[..., -y.shape[-1]:].float()).sum(), leaves)

    def plain_x(f, qq):   # the same rounding points: x rounded to bf16, dfv too
        return table_gather_x_plain(f.to(BF16).float(), qq, 4, 3)[0].to(BF16)

    def plain_rows(f):
        return table_gather_plain(f.to(BF16).float(), vox, 4, 3).to(BF16)

    for got, want in ((grads(lambda f, qq: table_gather_x(f, qq, 4, 3, dtype=BF16)[0], fv, q),
                       grads(plain_x, fv, q)),
                      (grads(lambda f: table_gather(f, vox, 4, 3, dtype=BF16), fv),
                       grads(plain_rows, fv))):
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=0,
                                       atol=1e-2 * float(w_.abs().max()))
    dp, dq = grads(lambda p_, qq: mfv_x(p_, qq, 64, 0.25, 4, 3, dtype=BF16)[0], pts, q)
    dp_ref, dq_ref = grads(lambda p_, qq: mfv_x_plain(p_, qq, 64, 0.25, 4, 3)[0].to(BF16),
                           pts, q)
    assert torch.equal(dq, dq_ref)
    np.testing.assert_allclose(dp.numpy(), dp_ref.numpy(), rtol=0,
                               atol=1e-2 * float(dp_ref.abs().max()))
    assert (mfv_x.launches, table_gather_x.launches, table_gather.launches) == counts
    with pytest.raises(TypeError):   # float32, bfloat16 and float16 only
        table_gather(fv, vox, 4, 3, dtype=torch.float64)

