"""The bf16 gradient paths against dpdist_tpu, on the CPU: row 3's bf16
adjoint (its plain versions against JAX's table_gather_bwd(dtype=bfloat16)
in interpret mode), the bf16 frozen loss and its gradient in pcA on both
committed nets, the explicit kernel modes against the plain composition,
one bf16 train step against jax.value_and_grad as bench.py:173-190 builds
it, and fused_gather="full", whose gradient both packages refuse.

On the CPU the wrappers run their plain versions inside their autograd
Functions, so the card path's backward logic runs here; the kernels
themselves run in tests/test_torch_kernels_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.kernels.table_gather_pallas import table_gather_bwd as jax_tg_bwd
from dpdist_tpu.losses import l1_sample_loss as jax_l1
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.models.dpdist import resolve_for_grad as jax_resolve_for_grad

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data.golden import golden_clouds, load_golden
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather_bwd,
    table_gather_bwd_ordered,
    table_gather_bwd_plain,
)
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import apply_dpdist
from dpdist_tpu_torch.ops import voxel_assign
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.trainer import DPDistTrainer

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
BF16 = torch.bfloat16
# The bf16 frozen loss, port against JAX bf16 (both on the CPU): the
# decoder's float32 sums run in other orders, so a product at a bf16
# rounding edge may round the other way. The gradient in pcA: within
# REL_GRAD of the largest |g| on all but OUTLIERS of the points, within
# REL_GRAD_FEW on every point, and a cosine of at least MIN_COS. On the
# golden pairs and six seeded inputs the port's plain path reads at most
# 8.7e-3 of the largest |g| and a cosine of at least 0.999995; JAX's own
# bf16 gradient strays from its float32 one by up to 0.19 of the largest
# |g| on the golden pairs (scripts/torch_bf16_parity.py).
TOL_LOSS = 2e-3
REL_GRAD, OUTLIERS, REL_GRAD_FEW, MIN_COS = 1e-2, 0.05, 5e-2, 0.999
# One bf16 train step: each weight leaf within this share of its largest
# entry of JAX's (the bias leaves: see test_bf16_train_step_matches_jax).
REL_TRAIN = 2e-2
SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))


def close_grads(got, want):
    """The criterion above; returns (worst point, share above REL_GRAD,
    cosine)."""
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
    worst, share = float(err.max()), float(np.mean(err > REL_GRAD))
    assert worst <= REL_GRAD_FEW and share <= OUTLIERS and cos >= MIN_COS, (worst, share, cos)
    return worst, share, cos


def _bf16_ulp(x):
    """One bf16 ulp of each value of x (float32 holding bf16 values)."""
    return np.ldexp(np.ones_like(x), np.frexp(x)[1] - 8)


@pytest.mark.parametrize("B,N,g,k", [(2, 16, 4, 3), (2, 64, 8, 5), (1, 200, 8, 5)])
def test_bf16_adjoint_plain_matches_pallas_interpret(B, N, g, k):
    """table_gather_bwd on a bf16 grad (the wrapper's plain version on the
    CPU), table_gather_bwd_plain and the ordered sum: bf16 dfv equal to
    one another, and within one bf16 ulp of JAX's
    table_gather_bwd(dtype=bfloat16) in interpret mode (its one-hot
    products sum tile by tile, then fold; each value rounds once in both)."""
    r = np.random.default_rng(N)
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    vox = voxel_assign(torch.as_tensor(q), g)[0]
    grad = torch.as_tensor(r.normal(size=(B, N, k ** 3 * 20)).astype(np.float32)).to(BF16)
    got = table_gather_bwd(vox, grad, g, k)
    plain = table_gather_bwd_plain(vox, grad, g, k)
    ordered = table_gather_bwd_ordered(vox, grad, g, k)
    assert got.dtype == plain.dtype == ordered.dtype == BF16
    assert torch.equal(got, plain)
    # The ordered float32 sum and autograd's sum differ in order; rounded
    # to bf16 they may differ by an ulp.
    ulp = _bf16_ulp(plain.float().numpy())
    assert np.all(np.abs(ordered.float().numpy() - plain.float().numpy()) <= ulp)
    want = jax_tg_bwd(jnp.asarray(vox.numpy()), jnp.asarray(grad.float().numpy(), jnp.bfloat16),
                      grid_size=g, k=k, dtype=jnp.bfloat16, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(plain.float().numpy() - want) <= _bf16_ulp(want))


@functools.partial(jax.jit, static_argnums=(2,))
def jax_frozen_value_and_grad(params, state, cfg, pcA, pcB):
    """JAX's frozen loss (penalty 1.0) and its gradient in pcA, jitted with
    the parameters as arguments so that both nets share one compile."""
    return jax.value_and_grad(jax_frozen_loss(params, state, cfg, out_of_grid_penalty=1.0))(
        pcA, pcB)


@pytest.fixture(scope="module", params=NETS)
def net(request):
    cfg, params, state = jax_load(request.param)
    tcfg, tparams_np, _ = load_dpdist_checkpoint(request.param)
    return (cfg, params, state), (tcfg, params_from_jax(tparams_np, "cpu"))


def _src_grad(tparams, cfg, pcA, pcB):
    loss_fn = make_frozen_dpdist_loss(tparams, cfg, out_of_grid_penalty=1.0)
    a = torch.tensor(pcA, requires_grad=True)
    value = loss_fn(a, torch.as_tensor(pcB))
    return float(value.detach()), torch.autograd.grad(value, a)[0].numpy()


def test_bf16_frozen_loss_matches_jax(net):
    """The bf16 frozen loss and d/dpcA on the eight golden pairs at 64
    points (two partly off the grid) against JAX bf16 (its XLA
    composition on the CPU, as the port's "auto" is here); the parameters
    receive no gradient."""
    (cfg, params, state), (tcfg, tparams) = net
    pcA, pcB = golden_clouds(load_golden())
    want, jgrad = jax_frozen_value_and_grad(params, state, cfg.replace(dtype="bfloat16"),
                                            jnp.asarray(pcA), jnp.asarray(pcB))
    leaves = [t.requires_grad_(True) for lp in tparams["decoder"]["layers"] for t in lp.values()]
    value, grad = _src_grad(tparams, tcfg.replace(dtype="bfloat16"), pcA, pcB)
    assert abs(value - float(want)) <= TOL_LOSS
    close_grads(grad, np.asarray(jgrad))
    assert all(t.grad is None for t in leaves)


@pytest.mark.parametrize("mode", ["mfv", "table", "on"])
def test_bf16_kernel_modes_match_the_plain_composition(net, mode):
    """Explicit "mfv", "table" and "on" in bf16 (the autograd Functions of
    rows 1, 2 and 10 with row 3's bf16 adjoint, run on their plain
    versions here) against "off", on the golden pairs; the loss within
    TOL_LOSS and d/dpcA by the criterion above."""
    _, (tcfg, tparams) = net
    pcA, pcB = golden_clouds(load_golden())
    cfg = tcfg.replace(dtype="bfloat16")
    want = _src_grad(tparams, cfg.replace(fused_gather="off"), pcA, pcB)
    got = _src_grad(tparams, cfg.replace(fused_gather=mode), pcA, pcB)
    assert abs(got[0] - want[0]) <= TOL_LOSS
    close_grads(got[1], want[1])


def test_bf16_train_step_matches_jax(tmp_path, monkeypatch):
    """One DPDistTrainer step in bf16 (float32 master weights, a bf16
    decoder) against jax.value_and_grad of the l1 loss on
    apply_dpdist(train=True) with resolve_for_grad's bf16 config, as
    bench.py:173-190 builds the bf16 train step: the loss, and every weight
    leaf within REL_TRAIN of its largest entry.

    The bias leaves are held to how each package sums them. A bias's
    gradient is the sum over the B*N rows of its layer's output gradient
    (bf16). JAX on the CPU sums the rows one by one in bf16, rounding at
    every add (XLA:CPU reduces bf16 in bf16); the port sums in float32 and
    rounds once, as a reduction that accumulates in float32 does. So JAX's
    bias gradient is the row-by-row bf16 sum of the port's own row
    gradients, exactly, and the port's is their float32 sum rounded once.
    (The two differ by up to 2.5e-2 of a leaf's largest entry at 32 and 64
    rows; the port's lies within 3.6e-3 of the float64 sum, JAX's within
    2.6e-2: scripts/torch_bf16_parity.py --train.)"""
    from dpdist_tpu_torch.nn import layers

    jcfg = JaxConfig(**SMALL, dtype="bfloat16")
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(3)
    data = r.uniform(-0.9, 0.9, (4, 6 * 16, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (4, 4 * 16)).astype(np.float32)
    trainer = DPDistTrainer(DPDistConfig(**SMALL, dtype="bfloat16"),
                            TrainConfig(batch_size=4, augment=False), run_dir=str(tmp_path),
                            device="cpu", logger=RunLogger(str(tmp_path), echo=False))
    trainer._set_params(params_from_jax(jax.device_get(jparams), "cpu"))
    pcA, pcB, lab, _ = trainer.make_batch(data, labels)
    gcfg16 = jax_resolve_for_grad(jcfg)

    def loss_fn(p):
        pred_AB, _, _ = jax_apply(p, jstate, gcfg16, jnp.asarray(pcA.numpy()),
                                  jnp.asarray(pcB.numpy()), train=True)
        return jax_l1(pred_AB, jnp.asarray(lab.numpy()))

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    products = []   # each layer's x @ w, whose gradient is the bias's rows

    def dense_apply(params, x):
        y = torch.matmul(x, params["w"])
        y.retain_grad()
        products.append(y)
        return y + params["b"]

    monkeypatch.setattr(layers, "dense_apply", dense_apply)
    loss, grads = trainer.loss_and_grads(pcA, pcB, lab)
    monkeypatch.undo()
    assert abs(float(loss) - float(want)) <= TOL_LOSS
    assert all(g.dtype == torch.float32 for g in grads)
    jlayers = jgrads["decoder"]["layers"]
    for i, y in enumerate(products):
        w_got, w_want = grads[2 * i + 1].numpy(), np.asarray(jlayers[i]["w"])
        np.testing.assert_allclose(w_got, w_want, atol=REL_TRAIN * np.abs(w_want).max(), rtol=0)
        rows = y.grad.reshape(-1, y.shape[-1])
        assert rows.dtype == BF16
        running = torch.zeros(rows.shape[1], dtype=BF16)
        for row in rows:
            running = running + row
        assert np.array_equal(np.asarray(jlayers[i]["b"]), running.float().numpy())
        assert torch.equal(grads[2 * i], rows.float().sum(0).to(BF16).float())
    before = trainer.params["decoder"]["layers"][0]["w"].detach().clone()
    assert np.isfinite(float(trainer.train_step(data, labels)["loss"]))
    assert not torch.equal(before, trainer.params["decoder"]["layers"][0]["w"])


def test_full_has_no_gradient_outside_training(tmp_path):
    """bf16 fused_gather="full" under autograd: JAX's gradient through its
    fused kernel fails, and the port raises NotImplementedError naming
    that refusal rather than run another path; in training (train=True)
    both run "table"."""
    jcfg = JaxConfig(**SMALL, dtype="bfloat16", fused_gather="full")
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(4)
    pcA, pcB = (r.uniform(-0.8, 0.8, (2, 16, 3)).astype(np.float32) for _ in range(2))

    def jax_loss(a):
        pred_AB, pred_BA, _ = jax_apply(jparams, jstate, jcfg, a, jnp.asarray(pcB))
        return jnp.mean(pred_AB) + jnp.mean(pred_BA)

    with pytest.raises(Exception):
        jax.grad(jax_loss)(jnp.asarray(pcA))
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    cfg = DPDistConfig(**SMALL, dtype="bfloat16", fused_gather="full")
    a = torch.tensor(pcA, requires_grad=True)
    with pytest.raises(NotImplementedError, match="refuses"):
        apply_dpdist(tparams, cfg, a, torch.as_tensor(pcB))
    with pytest.raises(NotImplementedError, match="refuses"):
        make_frozen_dpdist_loss(tparams, cfg)(a, torch.as_tensor(pcB))
    pred_AB, _ = apply_dpdist(tparams, cfg, a, torch.as_tensor(pcB), train=True)
    assert torch.isfinite(torch.autograd.grad(pred_AB.sum(), a)[0]).all()
    trainer = DPDistTrainer(cfg, TrainConfig(batch_size=2, augment=False), run_dir=str(tmp_path),
                            device="cpu", logger=RunLogger(str(tmp_path), echo=False))
    data = r.uniform(-0.9, 0.9, (2, 6 * 16, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (2, 4 * 16)).astype(np.float32)
    assert np.isfinite(float(trainer.train_step(data, labels)["loss"]))


@pytest.mark.parametrize("act", ["relu", "centered"])
def test_output_activation_gradient_at_the_clip_edges_matches_jax(act):
    """The output activation's value and gradient against JAX's, at inputs
    that land exactly on the clip edges (as bf16 decoder outputs do):
    jnp.clip halves the incoming gradient at a tie, torch.clamp would pass
    all of it."""
    from dpdist_tpu.models.dpdist import _output_activation as jax_act

    from dpdist_tpu_torch.models.dpdist import _output_activation

    x = np.array([-4.0, -3.0, -1.5, 0.0, 1.25, 3.0, 6.0, 7.0], np.float32)
    weights = np.arange(1, 9, dtype=np.float32)
    want_y = np.asarray(jax_act(jnp.asarray(x), act))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jax_act(v, act) * weights))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    y = _output_activation(t, act)
    (g,) = torch.autograd.grad((y * torch.as_tensor(weights)).sum(), t)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-7)
