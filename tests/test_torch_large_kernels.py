"""The wrappers of the streaming 3DmFV encode (kernels/threedmfv.py), the
patch-only table gather (kernels/table_gather.py:table_gather) and the
NN-min (kernels/chamfer.py), against dpdist_tpu's Pallas kernels.

On the CPU the wrappers run their plain versions; the JAX side runs as its
own tests run it (Pallas in interpret mode). The CUDA kernels themselves
run only on a card (tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.kernels.chamfer_pallas import chamfer_distance_pallas as jax_chamfer_pallas
from dpdist_tpu.kernels.chamfer_pallas import nn_min_sqdist_pallas as jax_nn_min
from dpdist_tpu.kernels.table_gather_pallas import table_gather as jax_table_gather
from dpdist_tpu.kernels.threedmfv_pallas import threedmfv_pallas as jax_threedmfv_pallas
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.kernels.chamfer import (
    MAX_CHUNK,
    TILE_N,
    chamfer_distance_kernel,
    nn_min_sqdist,
    nn_min_sqdist_plain,
    plan_nn_min,
)
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_plain,
)
from dpdist_tpu_torch.kernels.threedmfv import merge_groups, split_plan, threedmfv_kernel
from dpdist_tpu_torch.ops import threedmfv, threedmfv_plain
from dpdist_tpu_torch.ops.threedmfv import threedmfv_grid

# The encode against the Pallas kernel: the JAX package's own kernel
# tolerance (tests/test_kernels.py:14).
TOL_FV = 2e-5
# The adjoint sums in another order where queries share a voxel: the JAX
# package's backward-kernel tolerance.
TOL_BWD = 1e-5
# NN-min against the Pallas kernel: the JAX package's tolerance
# (tests/test_kernels.py:43).
TOL_NN = 1e-4
# Input gradients through the encode, per point and relative to the
# largest entry: within REL_GRAD on all but OUTLIERS of the points and
# within REL_GRAD_FEW on all (the criterion of
# tests/test_torch_losses_optim.py).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05


def _close_rel(got, want):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    assert err.max() <= REL_GRAD_FEW, err.max()
    assert np.mean(err > REL_GRAD) <= OUTLIERS, np.sort(err.ravel())[-8:]


def _clouds(seed, B, N, lo=-0.95, hi=0.95):
    return np.random.default_rng(seed).uniform(lo, hi, (B, N, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# Row 7: the streaming 3DmFV encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N", [(2, 130), (1, 1000)])
def test_threedmfv_plain_matches_pallas_interpret(B, N):
    pts = _clouds(B * N, B, N)
    want = np.asarray(jax_threedmfv_pallas(jnp.asarray(pts), 512, 0.125, interpret=True))
    got = threedmfv_kernel(torch.as_tensor(pts), 512, 0.125)
    assert got.shape == (B, 512, 20)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_FV, rtol=0)
    assert threedmfv_kernel.launches == 0


def test_threedmfv_plain_with_far_points_matches_pallas_interpret():
    """Points far outside the grid underflow Q to 0 for all but their
    nearest Gaussians; the pools tie at the floor and stay finite."""
    r = np.random.default_rng(3)
    pts = np.concatenate([r.uniform(-0.5, 0.5, (1, 60, 3)), np.full((1, 4, 3), 5.0),
                          np.full((1, 2, 3), -7.5)], axis=1).astype(np.float32)
    want = np.asarray(jax_threedmfv_pallas(jnp.asarray(pts), 64, 0.125, interpret=True))
    got = threedmfv_kernel(torch.as_tensor(pts), 64, 0.125).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL_FV, rtol=0)


def test_threedmfv_backward_replay_matches_pallas_vjp():
    """The wrapper's backward (the plain encode replayed under autograd)
    against jax.vjp of threedmfv_pallas, whose backward replays JAX's XLA
    encode. The two encodes form squared distances differently (per
    dimension here, by the matmul identity there), and the signed sqrt's
    slope near 0 magnifies that on a few points: on these inputs the worst
    point is off by 4.0e-2 of the largest entry, and against the same
    encode in float64 JAX's gradient is off by 3.8e-2 there and the
    port's by 2.6e-3. So the per-point criterion applies."""
    r = np.random.default_rng(4)
    pts = r.uniform(-1.05, 1.05, (2, 130, 3)).astype(np.float32)
    co = r.normal(size=(2, 512, 20)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jax_threedmfv_pallas(p, 512, 0.125, interpret=True),
                     jnp.asarray(pts))
    (want,) = vjp(jnp.asarray(co))
    want = np.asarray(want)
    tp = torch.tensor(pts, requires_grad=True)
    before = threedmfv_kernel.replays
    (got,) = torch.autograd.grad((threedmfv_kernel(tp, 512, 0.125) * torch.as_tensor(co)).sum(),
                                 tp)
    assert threedmfv_kernel.replays == before + 1
    _close_rel(got.numpy(), want)


def test_threedmfv_dispatch():
    """impl="auto" on the CPU and "kernel" on a CPU tensor both give the
    plain encode; the wrapper replays only where points need a gradient."""
    pts = torch.as_tensor(_clouds(5, 2, 130))
    ref = threedmfv_plain(pts, 512, 0.125)
    for impl in ("auto", "kernel", "plain"):
        assert torch.equal(threedmfv(pts, 512, 0.125, impl=impl), ref)
    with pytest.raises(ValueError, match="impl"):
        threedmfv(pts, 512, 0.125, impl="pallas")
    before = threedmfv_kernel.replays
    fv = threedmfv_kernel(pts, 512, 0.125)
    assert not fv.requires_grad and threedmfv_kernel.replays == before


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError), ("shape", ValueError), ("noncontiguous", ValueError),
    ("gaussians", ValueError),
])
def test_threedmfv_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    pts, G = torch.zeros(2, 8, 3), 64
    if case == "float64":
        pts = pts.double()
    elif case == "shape":
        pts = torch.zeros(2, 8, 2)
    elif case == "noncontiguous":
        pts = torch.zeros(2, 3, 8).transpose(1, 2)
    elif case == "gaussians":
        G = 100
    with pytest.raises(exc):
        threedmfv_kernel(pts, G, 0.25)


@pytest.mark.parametrize("B,N", [(1, 10000), (1, 1), (2, 1), (3, 129), (4, 1000), (16, 256),
                                 (132, 256), (133, 64), (256, 256), (256, 64), (300, 64),
                                 (512, 64), (1, 33), (7, 5000)])
@pytest.mark.parametrize("sms", [132, 114])
def test_threedmfv_split_plan_covers_every_point_once(B, N, sms):
    """Row 7's split of each cloud over blocks: chunks of `chunk` points
    (a multiple of the kernel's 32-point tile), none empty, every point in
    exactly one; S = 1 once B is more than half the card's two blocks per
    SM; at most about two blocks per SM in all."""
    S, chunk = split_plan(B, N, sms)
    assert S >= 1 and chunk % 32 == 0
    assert (S - 1) * chunk < N <= S * chunk
    owner = np.zeros(N, dtype=int)
    for s in range(S):
        owner[s * chunk:min(N, (s + 1) * chunk)] += 1
    assert (owner == 1).all()
    if B > sms:
        assert S == 1
    assert S == 1 or (chunk >= 32 and B * S <= 2 * sms)
    assert 1 <= merge_groups(B, sms) <= 20


def _split_encode_mirror(points, n_gaussians, sigma, S, chunk):
    """The kernel's structure in plain PyTorch: pools (sum, max, min) per
    chunk of points, merged in chunk order, then the finalisation with the
    whole cloud's N in pi_scale = sqrt(w) * N and in the mean (never the
    chunk's)."""
    B, N, _ = points.shape
    mu = torch.as_tensor(threedmfv_grid(n_gaussians))
    w = 1.0 / mu.shape[0]
    sums, maxs, mins = None, None, None
    for s in range(S):
        p = points[:, s * chunk:(s + 1) * chunk]
        diff = (p[:, :, None, :] - mu) / sigma
        q = torch.softmax(-0.5 * torch.sum(diff * diff, dim=-1), dim=-1)
        d_pi = ((q - w) / (np.sqrt(w) * N))[..., None]
        d_mu = q[..., None] * diff
        d_sig = q[..., None] * (diff * diff - 1.0)
        part = torch.cat([d_pi, d_mu, d_sig], dim=-1)          # (B, n, G, 7)
        ps, pmax, pmin = part.sum(1), part.amax(1), part.amin(1)
        if sums is None:
            sums, maxs, mins = ps, pmax, pmin
        else:
            sums, maxs, mins = sums + ps, torch.maximum(maxs, pmax), torch.minimum(mins, pmin)
    mean = sums / N
    d_pi = torch.cat([mean[..., :1], maxs[..., :1]], dim=-1)
    d_mu = torch.cat([mean[..., 1:4], maxs[..., 1:4], mins[..., 1:4]], dim=-1) / np.sqrt(w)
    d_sig = torch.cat([mean[..., 4:], maxs[..., 4:], mins[..., 4:]], dim=-1) / np.sqrt(2.0 * w)

    def norm(x):
        x = torch.sign(x) * torch.sqrt(torch.clamp(torch.abs(x), min=1e-12))
        return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=1, keepdim=True), min=1e-12))

    return torch.cat([norm(d_pi), norm(d_mu), norm(d_sig)], dim=2)


@pytest.mark.parametrize("B,N,far", [
    (1, 1, False),      # one point, one chunk
    (2, 1, True),       # one far point per cloud
    (1, 150, False),    # chunks of 32 points, the last one ragged (150 = 4 x 32 + 22)
    (3, 129, True),     # ragged, with points far off the grid
    (1, 1000, True),    # many chunks
])
def test_threedmfv_split_mirror_matches_plain_and_pallas(B, N, far):
    """Partial pools over the split plan's chunks, merged, against the
    plain encode and JAX's Pallas encode in interpret mode (within 1e-6):
    splitting a cloud changes only the order of the sums, and only the
    whole cloud's N enters the mean and pi_scale."""
    pts = _clouds(N + B, B, N)
    if far:
        pts[:, : max(1, N // 20)] = np.float32(4.5)
        pts[:, -1] = np.float32(-6.0)
    S, chunk = split_plan(B, N, 132)
    if N > 32:
        assert S > 1
    t = torch.as_tensor(pts)
    got = _split_encode_mirror(t, 512, 0.125, S, chunk).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, threedmfv_plain(t, 512, 0.125).numpy(), atol=1e-6, rtol=0)
    want = np.asarray(jax_threedmfv_pallas(jnp.asarray(pts), 512, 0.125, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Row 6: the patch-only table gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,k,C,N", [(8, 5, 20, 150), (4, 3, 7, 12)])
def test_table_gather_matches_pallas_interpret(g, k, C, N):
    """Forward exact, with off-grid queries (vox 0) included; the VJP
    through the adjoint within TOL_BWD."""
    r = np.random.default_rng(g * k)
    B = 2
    fv = r.normal(size=(B, g ** 3, C)).astype(np.float32)
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    vox, mask, _ = jax_voxel_assign(jnp.asarray(q), g)
    assert float(np.asarray(mask).min()) == 0.0      # some queries are off the grid
    co = r.normal(size=(B, N, k ** 3 * C)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_table_gather(f, vox, g, k, interpret=True),
                        jnp.asarray(fv))
    (jdfv,) = vjp(jnp.asarray(co))

    tf = torch.tensor(fv, requires_grad=True)
    tvox = torch.as_tensor(np.array(vox))
    got = table_gather(tf, tvox, g, k)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert torch.equal(got.detach(), table_gather_plain(tf.detach(), tvox, g, k))
    (dfv,) = torch.autograd.grad((got * torch.as_tensor(co)).sum(), tf)
    np.testing.assert_allclose(dfv.numpy(), np.asarray(jdfv), atol=TOL_BWD, rtol=0)
    assert table_gather.launches == 0 and table_gather_bwd.launches == 0


@pytest.mark.parametrize("g,k,C,N", [(8, 5, 20, 150), (4, 3, 7, 12)])
def test_table_gather_bf16_matches_pallas_interpret(g, k, C, N):
    """The bf16 output: the reference's kernel on the volume cast to
    bfloat16 (as its bf16 paths hand it) equals the port's dtype=bfloat16
    output, each value the float32 one rounded once; off-grid queries
    (vox 0) included."""
    r = np.random.default_rng(g * k + 1)
    B = 2
    fv = r.normal(size=(B, g ** 3, C)).astype(np.float32)
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    vox, mask, _ = jax_voxel_assign(jnp.asarray(q), g)
    assert float(np.asarray(mask).min()) == 0.0
    want = jax_table_gather(jnp.asarray(fv).astype(jnp.bfloat16), vox, g, k, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = table_gather(torch.as_tensor(fv), torch.as_tensor(np.array(vox)), g, k,
                       dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert table_gather.launches == 0


def test_table_gather_backward_skips_the_adjoint_without_fv_grad():
    import dpdist_tpu_torch.kernels.table_gather as tg

    fv = torch.zeros(1, 64, 20, requires_grad=True)
    vox = torch.zeros(1, 8, dtype=torch.int32)
    calls = []
    real = tg.table_gather_bwd
    tg.table_gather_bwd = lambda *a: calls.append(1) or real(*a)
    try:
        out = table_gather(fv.detach(), vox, 4, 3)
        assert not out.requires_grad
        torch.autograd.grad(table_gather(fv, vox, 4, 3).sum(), fv)
    finally:
        tg.table_gather_bwd = real
    assert calls == [1]


@pytest.mark.parametrize("case,exc", [
    ("vox_int64", TypeError), ("fv_float64", TypeError), ("cells", ValueError),
    ("batch", ValueError), ("even_k", ValueError),
])
def test_table_gather_rejects_what_the_kernel_does_not_take(case, exc):
    fv, vox, g, k = torch.zeros(2, 64, 20), torch.zeros(2, 8, dtype=torch.int32), 4, 3
    if case == "vox_int64":
        vox = vox.long()
    elif case == "fv_float64":
        fv = fv.double()
    elif case == "cells":
        g = 8
    elif case == "batch":
        vox = torch.zeros(3, 8, dtype=torch.int32)
    elif case == "even_k":
        k = 4
    with pytest.raises(exc):
        table_gather(fv, vox, g, k)


# ---------------------------------------------------------------------------
# Row 8: the NN-min
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,M", [(2, 100, 180), (3, 37, 261), (1, 1, 5)])
def test_nn_min_sqdist_plain_matches_pallas_interpret(B, N, M):
    r = np.random.default_rng(N + M)
    a = r.normal(size=(B, N, 3)).astype(np.float32)
    p = r.normal(size=(B, M, 3)).astype(np.float32)
    want = np.asarray(jax_nn_min(jnp.asarray(a), jnp.asarray(p), tile_n=32, tile_m=128,
                                 interpret=True))
    got = nn_min_sqdist(torch.as_tensor(a), torch.as_tensor(p))
    assert got.shape == (B, N)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_NN, rtol=0)
    assert nn_min_sqdist.launches == 0


def test_nn_min_sqdist_plain_chunks_rows():
    """The plain version steps over rows of a; chunks of one row give the
    same values as one step."""
    import dpdist_tpu_torch.kernels.chamfer as ch

    r = np.random.default_rng(7)
    a, p = (torch.as_tensor(r.normal(size=(2, n, 3)).astype(np.float32)) for n in (9, 40))
    whole = nn_min_sqdist_plain(a, p)
    old = ch._PLAIN_FLOATS
    ch._PLAIN_FLOATS = 2 * 40 * 3
    try:
        assert torch.equal(nn_min_sqdist_plain(a, p), whole)
    finally:
        ch._PLAIN_FLOATS = old


@pytest.mark.parametrize("sqrt", [True, False])
def test_chamfer_distance_kernel_plain_matches_pallas_interpret(sqrt):
    r = np.random.default_rng(8)
    a = r.normal(size=(2, 100, 3)).astype(np.float32)
    b = r.normal(size=(2, 180, 3)).astype(np.float32)
    want = float(jax_chamfer_pallas(jnp.asarray(a), jnp.asarray(b), sqrt=sqrt, interpret=True))
    got = float(chamfer_distance_kernel(torch.as_tensor(a), torch.as_tensor(b), sqrt=sqrt))
    assert abs(got - want) <= TOL_NN


def test_nn_min_sqdist_has_no_backward():
    a = torch.zeros(1, 4, 3, requires_grad=True)
    p = torch.zeros(1, 5, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        nn_min_sqdist(a, p)
    with torch.no_grad():
        assert nn_min_sqdist(a, p).shape == (1, 4)
    assert nn_min_sqdist(a.detach(), p).shape == (1, 4)


def _units(plan, B, N, M):
    """Each unit's (b, n0, n1, m0, m1) as csrc/chamfer.cu decodes unit u:
    chunk u % splits, tile (u / splits) % tiles, cloud u / splits / tiles."""
    for u in range(plan.units):
        s, t, b = u % plan.splits, u // plan.splits % plan.tiles, u // plan.splits // plan.tiles
        yield b, t * TILE_N, min(N, (t + 1) * TILE_N), s * plan.chunk, min(M, (s + 1) * plan.chunk)


@pytest.mark.parametrize("B,N,M", [
    (1, 10000, 10000),   # eval_pair's clouds
    (2, 1000, 4099),
    (256, 64, 64),
    (3, 37, 5),
    (1, 1, 1),
    (1, 1, 777),
    (2, 500, 1),
    (2, 1025, 1025),
    (3, 10000, 2000),
    (1, 50000, 10000),   # a ground-truth generator's size
])
def test_plan_nn_min_tiles_every_pair_once(B, N, M):
    """For a few cards (SM count, blocks per SM: H100 SXM at two
    occupancies, H100 PCIe, an L4-sized card): the units cover every
    (b, n, m) exactly once; the chunk suits the kernel; the grid is at most
    the blocks the card holds at once; and with units walked by blocks
    i, i + grid, ..., no block's pair count exceeds the mean by more than
    one whole unit."""
    for sms, per_sm in ((132, 8), (132, 3), (114, 6), (58, 6)):
        plan = plan_nn_min(B, N, M, sms, per_sm)
        assert plan.chunk % 4 == 0 and 4 <= plan.chunk <= MAX_CHUNK
        assert plan.tiles == -(-N // TILE_N) and plan.splits == -(-M // plan.chunk)
        assert plan.units == B * plan.tiles * plan.splits
        assert 1 <= plan.grid <= min(plan.units, sms * per_sm)
        units = list(_units(plan, B, N, M))
        cover = np.zeros((B, N, M), np.int32) if B * N * M <= 2 ** 24 else None
        seen = set()
        for b, n0, n1, m0, m1 in units:
            assert 0 <= b < B and 0 <= n0 < n1 <= N and 0 <= m0 < m1 <= M
            seen.add((b, n0, m0))
            if cover is not None:
                cover[b, n0:n1, m0:m1] += 1
        assert len(seen) == len(units)
        # Per cloud, the tiles cut [0, N) and the chunks [0, M) without gaps.
        assert sum(n1 - n0 for b, n0, n1, m0, m1 in units if b == 0 and m0 == 0) == N
        assert sum(m1 - m0 for b, n0, n1, m0, m1 in units if b == 0 and n0 == 0) == M
        if cover is not None:
            assert (cover == 1).all()
        pairs = [(n1 - n0) * (m1 - m0) for _, n0, n1, m0, m1 in units]
        per_block = [sum(pairs[i::plan.grid]) for i in range(plan.grid)]
        unit = min(TILE_N, N) * min(plan.chunk, M)
        assert max(per_block) <= B * N * M / plan.grid + unit


def test_plan_nn_min_at_eval_pair_balances_the_sms():
    """eval_pair's clouds on an H100-sized card (132 SMs, 8 blocks each):
    every SM gets units, and none carries a third of a unit more than the
    mean."""
    plan = plan_nn_min(1, 10000, 10000, 132, 8)
    assert plan.units >= 132 and plan.grid == plan.units <= 132 * 8
    assert -(-plan.units // 132) - plan.units / 132 <= 1 / 3
