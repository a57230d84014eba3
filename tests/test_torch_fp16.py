"""float16 in the port against dpdist_tpu, on the CPU: the plain versions of
rows 1, 2, 6 and 3 in float16 against the reference's Pallas kernels in
interpret mode (the volume cast to float16, as its fp16 paths hand it),
float16's edge values through the gathers and the adjoint against the
reference's casts, the explicit kernel modes against the plain composition
under autograd, the routing of "full", three float16 train steps against
jax.value_and_grad + optax, the dense field, and the served programs
(portable and native) against JAX's export.

On the CPU the wrappers run their plain versions inside their autograd
Functions, so the card path's backward logic runs here; the kernels
themselves run in tests/test_torch_kernels_gpu.py. The golden file's fp16
sections (both committed nets at full width) are held in
tests/test_torch_dpdist.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpdist_tpu import serving as jserving
from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.data.batching import assemble_dpdist_batch as jax_assemble
from dpdist_tpu.eval.dense import dense_point_to_surface as jax_dense
from dpdist_tpu.kernels.mfv_gather_pallas import mfv_table_gather_x as jax_mfv_x
from dpdist_tpu.kernels.table_gather_pallas import table_gather as jax_table_gather
from dpdist_tpu.kernels.table_gather_pallas import table_gather_bwd as jax_tg_bwd
from dpdist_tpu.kernels.table_gather_pallas import table_gather_x as jax_tg_x
from dpdist_tpu.losses import l1_sample_loss as jax_l1
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.models.dpdist import _fused_gather_mode as jax_fused_gather_mode
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign
from dpdist_tpu.train.optim import make_optimizer as jax_make_optimizer

from dpdist_tpu_torch import serving
from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data.golden import FP16_EDGES, golden_clouds, half_ulp, load_golden
from dpdist_tpu_torch.eval.dense import dense_point_to_surface
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_bwd_ordered,
    table_gather_bwd_plain,
    table_gather_x,
)
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import apply_dpdist
from dpdist_tpu_torch.models.dpdist import Route, check_ported, resolve_mode, route
from dpdist_tpu_torch.ops import voxel_assign
from dpdist_tpu_torch.serving import FrozenDistance
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.trainer import DPDistTrainer

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
F16 = torch.float16
SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
# Distances and losses in float16, port against JAX (both on the CPU): 8x
# tighter than bf16's 2e-3, for float16's three more mantissa bits. On the
# golden pairs the port read at most 3.2e-6 from JAX's distances and
# 5.5e-7 from its frozen loss.
TOL_FP16 = 2.5e-4
# d/dpcA in float16 by the bf16 criterion (tests/test_torch_bf16_grad.py):
# within REL_GRAD of the largest |g| on all but OUTLIERS of the points,
# within REL_GRAD_FEW on every point, a cosine of at least MIN_COS. On the
# golden pairs the port read at most 9.8e-3 of the largest |g| and a cosine
# of at least 0.9999985 (JAX's own fp16 gradient strays from its float32
# one by up to 0.17 of the largest |g|).
REL_GRAD, OUTLIERS, REL_GRAD_FEW, MIN_COS = 1e-2, 0.05, 5e-2, 0.999
# The DPDist variants' train-step bounds (tests/test_torch_variants.py::
# TOL_STEPS): the first step's loss within 1e-4 relative and its gradient
# norm within 1e-3, the later losses within 5e-3 (Adam moves each weight
# by lr * sign(g), which parts the steps on rounding-sized gradients).
TOL_FIRST, TOL_LATER, TOL_GNORM = 1e-4, 5e-3, 1e-3
TRAIN_STEPS = 3


def _f16_ulp(x):
    """One float16 ulp at each value of x (a numpy array of float16
    values)."""
    return half_ulp(torch.as_tensor(x), F16).numpy()


def _bits(a):
    """The float16 bits of a torch or numpy float16 array."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint16)


def _queries(r, B, N, g):
    """Queries partly off-grid, some exactly on cell edges and at +-1."""
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    pick = r.random(q.shape) < 0.15
    q[pick] = r.choice(edges, pick.sum())
    return q


def close_grads(got, want):
    """The d/dpcA criterion above; returns (worst point, share above
    REL_GRAD, cosine)."""
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
    worst, share = float(err.max()), float(np.mean(err > REL_GRAD))
    assert worst <= REL_GRAD_FEW and share <= OUTLIERS and cos >= MIN_COS, (worst, share, cos)
    return worst, share, cos


# ---------------------------------------------------------------------------
# Rows 1, 2, 6 and 3 in float16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,N,G,g,k,sigma", [(2, 12, 16, 64, 4, 3, 0.25),
                                               (2, 64, 64, 512, 8, 5, 0.125)])
def test_row1_fp16_matches_pallas_interpret(B, M, N, G, g, k, sigma):
    """mfv_x(dtype=float16) (its plain version here) against the
    reference's mfv_table_gather_x(dtype=float16) in interpret mode: x in
    float16 with delta and vox bit for bit, and the patch, which the two
    encodes sum in other orders (2e-5 in float32), within one fp16 ulp; the
    port's fp16 x is its float32 x rounded once."""
    r = np.random.default_rng(M + N)
    pts = r.uniform(-0.9, 0.9, (B, M, 3)).astype(np.float32)
    q = _queries(r, B, N, g)
    want = jax_mfv_x(jnp.asarray(pts), jnp.asarray(q), G, sigma, g, k, dtype=jnp.float16,
                     interpret=True)
    assert want.dtype == jnp.float16
    want = np.asarray(want)
    x, vox = mfv_x(torch.as_tensor(pts), torch.as_tensor(q), G, sigma, g, k, dtype=F16)
    assert x.dtype == F16 and x.shape == want.shape == (B, N, 3 + k ** 3 * 20)
    np.testing.assert_array_equal(_bits(x[..., :3]), _bits(want[..., :3]))
    np.testing.assert_array_equal(vox.numpy(), np.asarray(jax_voxel_assign(jnp.asarray(q), g)[0]))
    got, ref = x[..., 3:].float().numpy(), want[..., 3:].astype(np.float32)
    assert np.all(np.abs(got - ref) <= _f16_ulp(ref))
    x32 = mfv_x(torch.as_tensor(pts), torch.as_tensor(q), G, sigma, g, k)[0]
    assert torch.equal(x, x32.to(F16)) and mfv_x.launches == 0


@pytest.mark.parametrize("B,N,g,k", [(2, 16, 4, 3), (2, 16, 8, 5)])
def test_row2_fp16_matches_pallas_interpret(B, N, g, k):
    """table_gather_x(dtype=float16) against the reference's kernel on the
    volume cast to float16 in interpret mode: x bit for bit; under autograd
    dq exact and dfv (row 3's fp16 adjoint, returned to float32 exactly)
    within one fp16 ulp of the reference's VJP through its cast."""
    r = np.random.default_rng(10 * g + k)
    fv = r.normal(size=(B, g ** 3, 20)).astype(np.float32)
    q = _queries(r, B, N, g)
    co = r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32)

    def jax_x(f, qq):
        return jax_tg_x(f.astype(jnp.float16), qq, g, k, interpret=True)

    want = jax_x(jnp.asarray(fv), jnp.asarray(q))
    assert want.dtype == jnp.float16
    jdfv, jdq = jax.grad(lambda f, qq: jnp.sum(jax_x(f, qq).astype(jnp.float32) * co),
                         (0, 1))(jnp.asarray(fv), jnp.asarray(q))
    tf, tq = torch.tensor(fv, requires_grad=True), torch.tensor(q, requires_grad=True)
    x, vox = table_gather_x(tf, tq, g, k, dtype=F16)
    assert x.dtype == F16
    np.testing.assert_array_equal(_bits(x.detach()), _bits(want))
    dfv, dq = torch.autograd.grad((x.float() * torch.as_tensor(co)).sum(), (tf, tq))
    assert dfv.dtype == dq.dtype == torch.float32
    np.testing.assert_array_equal(dq.numpy(), np.asarray(jdq))
    jdfv = np.asarray(jdfv)
    assert np.all(np.abs(dfv.numpy() - jdfv) <= _f16_ulp(jdfv))


@pytest.mark.parametrize("g,k,C,N", [(8, 5, 20, 150), (4, 3, 7, 12)])
def test_row6_fp16_matches_pallas_interpret(g, k, C, N):
    """table_gather(dtype=float16) against the reference's kernel on the
    volume cast to float16, off-grid queries (vox 0) included: bit for
    bit."""
    r = np.random.default_rng(g * k + 2)
    fv = r.normal(size=(2, g ** 3, C)).astype(np.float32)
    vox, mask, _ = jax_voxel_assign(jnp.asarray(r.uniform(-1.2, 1.2, (2, N, 3)), jnp.float32), g)
    assert float(np.asarray(mask).min()) == 0.0
    want = jax_table_gather(jnp.asarray(fv).astype(jnp.float16), vox, g, k, interpret=True)
    got = table_gather(torch.as_tensor(fv), torch.as_tensor(np.array(vox)), g, k, dtype=F16)
    assert want.dtype == jnp.float16 and got.dtype == F16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert table_gather.launches == 0


@pytest.mark.parametrize("B,N,g,k", [(2, 16, 4, 3), (2, 64, 8, 5), (1, 200, 8, 5)])
def test_row3_fp16_plain_matches_pallas_interpret(B, N, g, k):
    """table_gather_bwd on a float16 grad (the wrapper's plain version),
    table_gather_bwd_plain and the ordered sum: fp16 dfv equal to one
    another within one fp16 ulp (autograd's float32 sum and the ordered one
    run in other orders), the wrapper equal to the plain version, and
    within one fp16 ulp of the reference's table_gather_bwd(dtype=float16)
    in interpret mode (its one-hot products sum tile by tile, then fold;
    each value rounds once in both)."""
    r = np.random.default_rng(N + 1)
    vox = voxel_assign(torch.as_tensor(_queries(r, B, N, g)), g)[0]
    grad = torch.as_tensor(r.normal(size=(B, N, k ** 3 * 20)).astype(np.float32)).to(F16)
    got = table_gather_bwd(vox, grad, g, k)
    plain = table_gather_bwd_plain(vox, grad, g, k)
    ordered = table_gather_bwd_ordered(vox, grad, g, k)
    assert got.dtype == plain.dtype == ordered.dtype == F16
    assert torch.equal(got, plain)
    ulp = _f16_ulp(plain.float().numpy())
    assert np.all(np.abs(ordered.float().numpy() - plain.float().numpy()) <= ulp)
    want = jax_tg_bwd(jnp.asarray(vox.numpy()), jnp.asarray(grad.numpy()), grid_size=g, k=k,
                      dtype=jnp.float16, interpret=True)
    assert want.dtype == jnp.float16
    want = np.asarray(want).astype(np.float32)
    assert np.all(np.abs(plain.float().numpy() - want) <= _f16_ulp(want))
    assert table_gather_bwd.launches == table_gather_bwd.launches_fp16 == 0


def test_fp16_edges_round_as_the_reference_casts():
    """float16's edge values: rows 2 and 6 give the float32 rows rounded
    by numpy's astype(float16) (the reference's cast of its volume) bit for
    bit, infs and subnormals included, and the reference's Pallas kernels
    on the finite edges by value (signed zeros aside); row 3's sums that leave float16's
    range (integers past 65,504 to inf) or land in its subnormals
    (multiples of 2^-24), exact in float32 in any order, equal the
    reference's adjoint rounded once.

    Past 65,504 the two packages part: the reference gathers by a one-hot
    product, so an inf in a cloud's float16 volume meets the zeros of every
    other query's one-hot row (0 * inf = NaN) and that channel reads NaN in
    every row of the cloud; the port gathers by index, so only the rows
    whose window holds the cell read inf. A 3DmFV volume, normalised to
    unit length, never comes near that range."""
    g, k, C, N = 4, 3, 20, 37
    r = np.random.default_rng(60)
    vol = r.choice(np.concatenate([FP16_EDGES, -FP16_EDGES]), (2, g ** 3, C)).astype(np.float32)
    q = _queries(r, 2, N, g)
    jvox = jax_voxel_assign(jnp.asarray(q), g)[0]
    fv, vox = torch.as_tensor(vol), torch.as_tensor(np.array(jvox))
    x = table_gather_x(fv, torch.as_tensor(q), g, k, dtype=F16)[0]
    rows = table_gather(fv, vox, g, k, dtype=F16)
    for got, f32 in ((x, table_gather_x(fv, torch.as_tensor(q), g, k)[0]),
                     (rows, table_gather(fv, vox, g, k))):
        with np.errstate(over="ignore"):   # the edges past 65,504 round to inf
            want = f32.numpy().astype(np.float16)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert bool(torch.isinf(rows).any()) and bool(((rows != 0) & (rows.abs() < 2 ** -14)).any())
    # The reference's kernels on the finite edges: equal values (its
    # one-hot sums of +0 products read a -0 as +0, so zeros by value).
    finite = np.where(np.abs(vol) < 65520.0, vol, np.float32(3.0))
    f16 = jnp.asarray(finite).astype(jnp.float16)
    for got, want in ((table_gather_x(torch.as_tensor(finite), torch.as_tensor(q), g, k,
                                      dtype=F16)[0], jax_tg_x(f16, jnp.asarray(q), g, k,
                                                              interpret=True)),
                      (table_gather(torch.as_tensor(finite), vox, g, k, dtype=F16),
                       jax_table_gather(f16, jvox, g, k, interpret=True))):
        assert want.dtype == jnp.float16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        nonzero = got.numpy() != 0
        np.testing.assert_array_equal(_bits(got)[nonzero], _bits(want)[nonzero])
    for terms, beyond in ((np.float32([30000.0, -30000.0, 4096.0, 1.0, -3.0]), np.isinf),
                          (np.float32([1.0, 3.0, -1.0, 5.0]) * np.float32(2.0 ** -24),
                           lambda d: (d != 0) & (np.abs(d) < 2.0 ** -14))):
        grad = r.choice(terms, (2, N, k ** 3 * C)).astype(np.float32)
        got = table_gather_bwd(vox, torch.as_tensor(grad).to(F16), g, k)
        want = jax_tg_bwd(jvox, jnp.asarray(grad).astype(jnp.float16), grid_size=g, k=k,
                          dtype=jnp.float16, interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        with np.errstate(over="ignore"):
            ordered = table_gather_bwd_ordered(vox, torch.as_tensor(grad), g, k).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(ordered.astype(np.float16)))
        assert beyond(got.float().numpy()).any()


# ---------------------------------------------------------------------------
# The model in float16
# ---------------------------------------------------------------------------

def test_fp16_is_ported_and_full_is_table():
    """check_ported takes float16 and no other new dtype; "full" in float16
    resolves to "table" in both packages (the fused serving kernel is bf16
    only), with no gradient refused; "auto" on the card takes row 1 at
    64 points and rows 7 and 6 at 256, "table" under a gradient."""
    check_ported(DPDistConfig(dtype="float16"))
    with pytest.raises(NotImplementedError, match="float16"):
        check_ported(DPDistConfig(dtype="float64"))
    full = DPDistConfig(dtype="float16", fused_gather="full")
    assert jax_fused_gather_mode(JaxConfig(dtype="float16", fused_gather="full")) == "table"
    assert resolve_mode(full, "cuda") == "table"
    x2, p2 = ("table_gather_x",) * 2, ("plain",) * 2
    assert route(full, "cuda", 64, 64) == route(full, "cuda", 64, 64, grad=True) == Route(
        "table", p2, x2)
    auto = DPDistConfig(dtype="float16")
    assert route(auto, "cuda", 64, 64) == Route("mfv", ("mfv_gather_x",) * 2,
                                                ("mfv_gather_x",) * 2)
    assert route(auto, "cuda", 256, 256) == Route("table", ("threedmfv",) * 2,
                                                  ("table_gather",) * 2)
    assert route(auto, "cuda", 64, 64, grad=True) == Route("table", p2, x2)
    assert route(DPDistConfig(dtype="float16", fused_gather="on"), "cuda", 64, 64,
                 grad=True) == Route("on", p2, ("gather_patches_fused",) * 2)


def _src_grad(tparams, cfg, pcA, pcB):
    loss_fn = make_frozen_dpdist_loss(tparams, cfg, out_of_grid_penalty=1.0)
    a = torch.tensor(pcA, requires_grad=True)
    value = loss_fn(a, torch.as_tensor(pcB))
    return float(value.detach()), torch.autograd.grad(value, a)[0].numpy()


@pytest.fixture(scope="module", params=NETS)
def net(request):
    """A committed net in float16, and its frozen loss and d/dpcA on the
    golden pairs by the plain composition ("off"), computed once."""
    tcfg, tparams_np, _ = load_dpdist_checkpoint(request.param)
    cfg, tparams = tcfg.replace(dtype="float16"), params_from_jax(tparams_np, "cpu")
    pcA, pcB = golden_clouds(load_golden())
    return cfg, tparams, _src_grad(tparams, cfg.replace(fused_gather="off"), pcA, pcB)


@pytest.mark.parametrize("mode", ["mfv", "table", "on", "full"])
def test_fp16_kernel_modes_match_the_plain_composition(net, mode):
    """Explicit "mfv", "table", "on" and "full" (which is "table" in
    float16) under autograd in float16 (the Functions of rows 1, 2 and 10
    with row 3's fp16 adjoint, on their plain versions here) against "off"
    on the golden pairs; the parameters receive no gradient."""
    cfg, tparams, want = net
    pcA, pcB = golden_clouds(load_golden())
    leaves = [t.requires_grad_(True) for lp in tparams["decoder"]["layers"] for t in lp.values()]
    got = _src_grad(tparams, cfg.replace(fused_gather=mode), pcA, pcB)
    assert abs(got[0] - want[0]) <= TOL_FP16
    close_grads(got[1], want[1])
    assert all(t.grad is None for t in leaves)
    for t in leaves:
        t.requires_grad_(False)


def test_fp16_train_steps_match_jax(tmp_path):
    """TRAIN_STEPS DPDistTrainer steps in float16 (float32 master weights,
    a float16 decoder, no loss scaling, as the reference's) against
    jax.value_and_grad of the l1 loss on apply_dpdist(train=True) and the
    reference's optimizer, from the same weights on the same batch, by the
    variants' step bounds; the master weights stay float32."""
    jcfg = JaxConfig(**SMALL, dtype="float16")
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(5)
    data = r.uniform(-0.9, 0.9, (4, 6 * 16, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (4, 4 * 16)).astype(np.float32)
    pcA, pcB, lab = (jnp.asarray(a) for a in jax_assemble(data, labels))
    opt = jax_make_optimizer(JaxTrainConfig(batch_size=4))

    @jax.jit
    def step(p, o):
        def loss_fn(pp):
            return jax_l1(jax_apply(pp, jstate, jcfg, pcA, pcB, train=True)[0], lab)

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, o = opt.update(g, o, p)
        gn = jnp.sqrt(sum(jnp.sum(v * v) for v in jax.tree_util.tree_leaves(g)))
        return optax.apply_updates(p, upd), o, loss, gn

    trainer = DPDistTrainer(DPDistConfig(**SMALL, dtype="float16"),
                            TrainConfig(batch_size=4, augment=False), run_dir=str(tmp_path),
                            device="cpu", logger=RunLogger(str(tmp_path), echo=False))
    trainer._set_params(params_from_jax(jax.device_get(jparams), "cpu"))
    jp, o = jparams, opt.init(jparams)
    want, got = [], []
    for _ in range(TRAIN_STEPS):
        jp, o, loss, gn = step(jp, o)
        want.append((float(loss), float(gn)))
        m = trainer.train_step(data, labels)
        got.append((float(m["loss"]), float(m["grad_norm"])))
    (l0, g0), (w0, wg0) = got[0], want[0]
    assert abs(l0 - w0) <= TOL_FIRST * w0 and abs(g0 - wg0) <= TOL_GNORM * wg0, (got, want)
    for (l_, _), (w_, _) in zip(got[1:], want[1:]):
        assert abs(l_ - w_) <= TOL_LATER * w_, (got, want)
    assert all(t.dtype == torch.float32 for lp in trainer.params["decoder"]["layers"]
               for t in lp.values())


@pytest.mark.parametrize("pretransform", ["on", "off"])
def test_fp16_dense_field_matches_jax(pretransform):
    """dense_point_to_surface in float16 on the committed net (the decoder
    in float32 on the input rounded to float16, as the reference's dense
    path; row 6's fp16 rows on its plain version here at 300 queries)
    against the reference's, within TOL_FP16."""
    cfg, params, state = jax_load(NETS[0])
    cfg = cfg.replace(dtype="float16")
    r = np.random.default_rng(62)
    cloud = r.uniform(-0.8, 0.8, (2, 64, 3)).astype(np.float32)
    q = r.uniform(-1.1, 1.1, (2, 300, 3)).astype(np.float32)
    want = np.asarray(jax_dense(params, state, cfg, jnp.asarray(cloud), jnp.asarray(q),
                                pretransform=pretransform))
    tcfg, tp, _ = load_dpdist_checkpoint(NETS[0])
    with torch.no_grad():
        got = dense_point_to_surface(params_from_jax(tp, "cpu"), tcfg.replace(dtype="float16"),
                                     torch.as_tensor(cloud), torch.as_tensor(q),
                                     pretransform=pretransform).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_FP16, rtol=0)


def _dpdist_ops(ep):
    """The dpdist ops a program's graph holds, by name."""
    return sorted({str(n.target).split(".")[1] for n in ep.graph.nodes
                   if str(n.target).startswith("dpdist.")})


@functools.lru_cache(maxsize=1)
def _small_net():
    jp, js = jax_init(jax.random.PRNGKey(1), JaxConfig(**SMALL))
    return jp, js, params_from_jax(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("portable,over,want_ops", [
    (True, {}, []),
    (False, {}, ["mfv_x"]),
    (False, {"fused_gather": "full"}, ["table_gather_x"]),
], ids=["portable", "native", "native_full"])
def test_fp16_export_matches_jax(portable, over, want_ops):
    """The float16 frozen distance as a torch.export program (symbolic
    batch), portable (plain ops) and native (the kernels as dpdist ops: row
    1 in float16, "full" as "table"), against the eager model and against
    the reference's export of the same weights in float16, within
    TOL_FP16; the native program's gradient export holds row 3."""
    jp, js, p = _small_net()
    cfg = DPDistConfig(**SMALL, dtype="float16", **over)
    ep = serving.export_frozen_distance(p, None, cfg, portable=portable, device="cpu")
    assert _dpdist_ops(ep) == want_ops
    r = np.random.default_rng(63)
    a, b = (r.uniform(-1.1, 1.1, (3, 16, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = ep.module()(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        eager = FrozenDistance(cfg, p).eval()(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, eager, atol=1e-7, rtol=0)
    want = jserving.export_frozen_distance(jp, js, JaxConfig(**SMALL, dtype="float16"),
                                           batch=3).call(a, b)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL_FP16, rtol=0)
    if not portable and not over:
        gep = serving.export_frozen_distance(p, None, cfg, portable=False, with_grad=True,
                                             device="cpu")
        assert _dpdist_ops(gep) == ["table_gather_bwd", "table_gather_x"]
        vals, grads = gep.module()(torch.as_tensor(a), torch.as_tensor(b))
        assert bool(torch.isfinite(vals).all() and torch.isfinite(grads).all())


def test_fp16_forward_off_grid_queries_are_zero():
    """Off-grid queries score exactly 0 in float16, as in the other dtypes
    (the membership mask after the float32 activation)."""
    jp, js, p = _small_net()
    r = np.random.default_rng(64)
    a = torch.as_tensor(r.uniform(-0.9, 0.9, (2, 16, 3)).astype(np.float32))
    b = torch.as_tensor(r.uniform(-1.5, 1.5, (2, 16, 3)).astype(np.float32))
    pred_AB, _ = apply_dpdist(p, DPDistConfig(**SMALL, dtype="float16"), a, b)
    off = voxel_assign(b, 4)[1] == 0
    assert bool(off.any()) and bool((pred_AB[off] == 0).all())
    assert pred_AB.dtype == torch.float32 and bool(torch.isfinite(pred_AB).all())
