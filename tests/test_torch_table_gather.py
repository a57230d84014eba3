"""The table-gather wrappers (kernels/table_gather.py), the backward of the
fused mfv wrapper, and the gradients of the port's ops, against dpdist_tpu.

On the CPU the wrappers run their plain versions; the JAX side runs as its
own tests run it (Pallas in interpret mode, or the XLA oracle). The CUDA
kernels themselves run only on a card (tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.kernels.mfv_gather_pallas import mfv_table_gather_x as jax_mfv_x
from dpdist_tpu.kernels.table_gather_pallas import table_gather_bwd as jax_tg_bwd
from dpdist_tpu.kernels.table_gather_pallas import table_gather_bwd_xla_oracle
from dpdist_tpu.kernels.table_gather_pallas import table_gather_x as jax_tg_x
from dpdist_tpu.ops.threedmfv import threedmfv as jax_threedmfv
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.kernels.mfv_gather import mfv_x
from dpdist_tpu_torch.kernels.table_gather import (
    BWD_BF16_GROUP,
    table_gather_bwd,
    table_gather_bwd_ordered,
    table_gather_bwd_plain,
    table_gather_x,
    table_gather_x_plain,
)
from dpdist_tpu_torch.ops import neighbor_ids, threedmfv, voxel_assign

# The adjoint sums the same products in another order where queries share
# a voxel: the tolerance of the JAX package's own backward-kernel test.
TOL_BWD = 1e-5
# The same, relative to the largest |dfv|: the bound tests/test_torch_kernels_gpu.py
# and chip_smoke.py hold the adjoint kernel to.
REL_BWD = 1e-6


def _queries(r, B, N, g):
    """Queries partly off-grid, some exactly on cell edges and at +-1."""
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    pick = r.random(q.shape) < 0.15
    q[pick] = r.choice(edges, pick.sum())
    return q


@pytest.mark.parametrize("B,N,g,k", [(2, 16, 4, 3), (2, 16, 8, 5)])
def test_table_gather_x_matches_pallas_interpret(B, N, g, k):
    """Forward exact (x and vox), and both VJPs, against the Pallas kernel
    in interpret mode (the sizes of tests/test_kernels.py:170-200)."""
    r = np.random.default_rng(g)
    fv = r.normal(size=(B, g ** 3, 20)).astype(np.float32)
    q = _queries(r, B, N, g)
    co = r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32)
    want = np.asarray(jax_tg_x(jnp.asarray(fv), jnp.asarray(q), g, k, interpret=True))
    jdfv, jdq = jax.grad(lambda f, qq: jnp.sum(jax_tg_x(f, qq, g, k, interpret=True) * co),
                         (0, 1))(jnp.asarray(fv), jnp.asarray(q))

    tf, tq = torch.tensor(fv, requires_grad=True), torch.tensor(q, requires_grad=True)
    x, vox = table_gather_x(tf, tq, g, k)
    np.testing.assert_array_equal(x.detach().numpy(), want)
    np.testing.assert_array_equal(vox.numpy(), np.asarray(jax_voxel_assign(jnp.asarray(q), g)[0]))
    dfv, dq = torch.autograd.grad((x * torch.as_tensor(co)).sum(), (tf, tq))
    np.testing.assert_array_equal(dq.numpy(), co[..., :3])    # d delta / d q = I
    np.testing.assert_array_equal(dq.numpy(), np.asarray(jdq))
    np.testing.assert_allclose(dfv.numpy(), np.asarray(jdfv), atol=TOL_BWD, rtol=0)


@pytest.mark.parametrize("g,k", [(4, 3), (8, 5)])
def test_table_gather_bwd_matches_jax_oracle_and_kernel(g, k):
    """Gradient on every row, off-grid rows included: they carry vox = 0
    and scatter into cell 0's neighbourhood, as the reference does."""
    r = np.random.default_rng(10 + g)
    B, N = 2, 24
    q = _queries(r, B, N, g)
    vox, mask, _ = jax_voxel_assign(jnp.asarray(q), g)
    assert float(np.asarray(mask).min()) == 0.0          # some queries are off the grid
    grad = r.normal(size=(B, N, k ** 3 * 20)).astype(np.float32)
    oracle = np.asarray(table_gather_bwd_xla_oracle(vox, jnp.asarray(grad), grid_size=g, k=k,
                                                    dtype=jnp.float32))
    kernel = np.asarray(jax_tg_bwd(vox, jnp.asarray(grad), grid_size=g, k=k,
                                   dtype=jnp.float32, interpret=True))
    tvox = torch.as_tensor(np.array(vox))
    got = table_gather_bwd(tvox, torch.as_tensor(grad), g, k)
    assert got.shape == (B, g ** 3, 20)
    np.testing.assert_allclose(got.numpy(), oracle, atol=TOL_BWD, rtol=0)
    np.testing.assert_allclose(got.numpy(), kernel, atol=TOL_BWD, rtol=0)
    # A strided grad (the patch part of x's gradient) gives the same.
    wide = np.concatenate([r.normal(size=(B, N, 3)).astype(np.float32), grad], -1)
    strided = table_gather_bwd(tvox, torch.as_tensor(wide)[..., 3:], g, k)
    np.testing.assert_array_equal(strided.numpy(), got.numpy())


def _slab_tiling_mirror(vox, grad, g, k):
    """The adjoint kernel's tiling (csrc/table_gather.cu) in numpy. Block
    (b, slab) owns slots s = cell * C + c of the slab's g^2 cells; its list
    holds, in query order, the queries whose vox lies in [0, g^3) and whose
    window meets the slab, at first-digit offset di; slot (ny, nz, c) takes
    element (dj * k + dl) * C + c of the query's run grad[n, di * k^2 * C:],
    dj = ny - vy + k/2, dl = nz - vz + k/2, when both lie in [0, k).
    Returns each slot's float32 sum in list order, from 0, and how often
    each grad entry (b, n, e) was read."""
    B, N, E = grad.shape
    C, kh, gg = E // k ** 3, k // 2, g * g
    s = np.arange(gg * C)
    ty, tz, c = s // C // g + kh, s // C % g + kh, s % C
    off = (ty * k + tz) * C + c
    dfv = np.zeros((B, gg * g, C), np.float32)
    reads = np.zeros(grad.shape, np.int64)
    for b in range(B):
        for slab in range(g):
            acc = np.zeros(gg * C, np.float32)
            for n in range(N):
                v = int(vox[b, n])
                di = slab - v // gg + kh
                if not (0 <= v < gg * g and 0 <= di < k):
                    continue
                vy, vz = v // g % g, v % g
                inside = (0 <= ty - vy) & (ty - vy < k) & (0 <= tz - vz) & (tz - vz < k)
                e = di * k * k * C + off - (vy * k + vz) * C
                acc = acc + np.where(inside, grad[b, n, np.where(inside, e, 0)], np.float32(0))
                np.add.at(reads[b, n], e[inside], 1)
            dfv[b, slab * gg:(slab + 1) * gg] = acc.reshape(gg, C)
    return dfv, reads


@pytest.mark.parametrize("g,k,C,pallas", [(4, 3, 20, True), (8, 5, 20, False), (4, 3, 7, False)])
def test_table_gather_bwd_slab_tiling_matches_jax(g, k, C, pallas):
    """The kernel's tiling reads every in-grid (n, o, c) entry in exactly
    one (block, slot) and no other; its sums equal the ordered plain sum
    bit for bit; both hold JAX's adjoint (the XLA oracle, and the Pallas
    kernel in interpret mode at the small config) within REL_BWD of the
    largest |dfv|, off-grid rows (vox 0, cell 0's neighbourhood) included."""
    r = np.random.default_rng(20 + g + C)
    B, N = 2, 24
    q = _queries(r, B, N, g)
    vox, mask, _ = jax_voxel_assign(jnp.asarray(q), g)
    assert float(np.asarray(mask).min()) == 0.0
    vox = np.array(vox)
    grad = r.normal(size=(B, N, k ** 3 * C)).astype(np.float32)
    mirror, reads = _slab_tiling_mirror(vox, grad, g, k)
    tvox = torch.as_tensor(vox)
    in_grid = neighbor_ids(tvox, torch.ones(B, N), g, k).numpy() >= 0       # (B, N, k^3)
    np.testing.assert_array_equal(reads, np.repeat(in_grid, C, axis=-1).astype(np.int64))
    ordered = table_gather_bwd_ordered(tvox, torch.as_tensor(grad), g, k).numpy()
    np.testing.assert_array_equal(mirror, ordered)
    wants = [np.asarray(table_gather_bwd_xla_oracle(jnp.asarray(vox), jnp.asarray(grad),
                                                    grid_size=g, k=k, dtype=jnp.float32))]
    if pallas:
        wants.append(np.asarray(jax_tg_bwd(jnp.asarray(vox), jnp.asarray(grad), grid_size=g, k=k,
                                           dtype=jnp.float32, interpret=True)))
    for want in wants:
        tol = REL_BWD * float(np.abs(want).max())
        assert float(np.abs(ordered - want).max()) <= tol


def _bf16_owners(g, C):
    """The bf16 kernel's split of a slab's owners (csrc/table_gather.cu:
    b16_plan): g^2 * ceil(C / 10) owners, at most 8 consumer warps a block,
    parts of `consumers` owners. Returns (consumers, parts)."""
    owners = g * g * -(-C // BWD_BF16_GROUP)
    consumers = 32 * min(8, -(-owners // 32))
    return consumers, -(-owners // consumers)


def _bf16_owner_mirror(vox, bits, offset, stride_n, g, k, C, blocks):
    """The bf16 adjoint kernel's work split (csrc/table_gather.cu:
    table_gather_bwd_bf16_kernel) in numpy, on the bf16 grad (B, N,
    k^3 * C) that starts `offset` elements into the 16-byte-aligned buffer
    `bits` (uint16), rows `stride_n` elements apart, clouds N * stride_n.

    Work items (cloud b, slab, part) go to `blocks` blocks in
    contiguous ranges; each item lists, in query order, the queries whose
    vox lies in [0, g^3) and whose window meets the slab, and stages each
    one's run as the bulk copy does: from the 16-byte boundary at or before
    it, `lead` elements before its first, to the boundary after its last,
    in a slot of the ring (garbage past the span). Owner o of
    part p (cell = (p * consumers + o) // Q, channels j * 10 .. j * 10 + 9,
    Q = ceil(C / 10)) tests each listed query's window once, reads its 6
    words, shifts them by 16 bits where its first channel sits at an odd
    element, and adds the unpacked bf16 values into float32 sums in list
    order. Returns dfv rounded once to bf16 (as float32), how often each
    (b, n, e) grad entry was read, the items each block took, and the
    runs' leads."""
    B, N = vox.shape
    gg, G, kh, run = g * g, g ** 3, k // 2, k * k * C
    Q = -(-C // BWD_BF16_GROUP)
    consumers, parts = _bf16_owners(g, C)
    items = B * g * parts
    slot = (run + 14 + BWD_BF16_GROUP + 2 + 7) // 8 * 8
    garbage = np.random.default_rng(0).integers(0, 2 ** 16, slot, dtype=np.uint16)
    bits = np.concatenate([bits, garbage[:8]])   # a span may end past the last element
    dfv = np.zeros((B, G, C), np.float32)
    reads = np.zeros((B, N, k ** 3 * C), np.int64)
    taken, leads = [], set()
    for blk in range(blocks):
        first, last = items * blk // blocks, items * (blk + 1) // blocks
        taken.append(list(range(first, last)))
        for item in range(first, last):
            b, slab, part = item // parts // g, item // parts % g, item % parts
            listed = []
            for n in range(N):
                v = int(vox[b, n])
                di = slab - v // gg + kh
                if 0 <= v < G and 0 <= di < k:
                    e = offset + (b * N + n) * stride_n + di * run
                    a0, end = e // 8 * 8, -(-(e + run) // 8) * 8
                    staged = garbage.copy()
                    staged[:end - a0] = bits[a0:end]
                    listed.append((n, di, v // g % g, v % g, e - a0, staged.view(np.uint32)))
                    leads.add(e - a0)
            own = part * consumers + np.arange(consumers)
            cell, j = own // Q, own % Q
            mine = cell < gg
            ty, tz = cell // g + kh, cell % g + kh
            acc = np.zeros((consumers, BWD_BF16_GROUP), np.float32)
            for n, di, vy, vz, lead, words in listed:
                dj, dl = ty - vy, tz - vz
                inside = mine & (dj >= 0) & (dj < k) & (dl >= 0) & (dl < k)
                p = lead + (dj * k + dl) * C + j * BWD_BF16_GROUP               # first channel
                w = words[(p[inside] >> 1)[:, None] + np.arange(BWD_BF16_GROUP // 2 + 1)]
                w = w.astype(np.uint64)
                pair = ((w[:, 1:] << np.uint64(32) | w[:, :-1])
                        >> (np.uint64(16) * (p[inside] & 1).astype(np.uint64))[:, None])
                pair = (pair & np.uint64(0xffffffff)).astype(np.uint32)
                lo = (pair << np.uint32(16)).view(np.float32)
                hi = (pair & np.uint32(0xffff0000)).view(np.float32)
                # Channels past C (C = 7) sum whatever lies past the cell's;
                # they are never stored.
                with np.errstate(over="ignore", invalid="ignore"):
                    acc[inside] += np.stack([lo, hi], -1).reshape(-1, BWD_BF16_GROUP)
                for o in np.flatnonzero(inside):
                    c = j[o] * BWD_BF16_GROUP + np.arange(BWD_BF16_GROUP)
                    c = c[c < C]
                    np.add.at(reads[b, n], di * run + (dj[o] * k + dl[o]) * C + c, 1)
            for o in np.flatnonzero(mine):
                c = j[o] * BWD_BF16_GROUP + np.arange(BWD_BF16_GROUP)
                keep = c < C
                dfv[b, slab * gg + cell[o], c[keep]] = acc[o, keep]
    rounded = torch.from_numpy(dfv).to(torch.bfloat16).float().numpy()
    return rounded, reads, taken, leads


@pytest.mark.parametrize("g,k,C", [(4, 3, 20), (4, 5, 20), (8, 3, 20), (8, 5, 20),
                                   (4, 3, 7), (4, 5, 7), (8, 3, 7), (8, 5, 7), (16, 3, 20)])
def test_table_gather_bwd_bf16_owner_tiling_matches_ordered_sum(g, k, C):
    """The bf16 kernel's work split reads every in-grid (n, o, c) entry of a
    strided bf16 grad in exactly one (item, owner) and no other, its blocks
    take every item once, and its float32 sums rounded once equal the
    ordered plain sum bit for bit, for runs at every lead 0-7 (the grad
    starts `base` = 0..7 elements into its buffer; rows of 3 + k^3 * C
    elements as a bf16 x's gradient hands it), off-grid rows (vox 0) and a
    vox outside the grid (adds nothing) included. Four blocks (one SM's
    worth) take the items in contiguous ranges; g = 16 splits a slab in two
    parts."""
    B, N = 2, 24
    W = 3 + k ** 3 * C
    parts = _bf16_owners(g, C)[1]
    assert parts == (2 if g == 16 else 1)
    all_leads = set()
    for base in range(8):
        r = np.random.default_rng(100 * g + 10 * k + C + base)
        vox = np.asarray(jax_voxel_assign(jnp.asarray(_queries(r, B, N, g)), g)[0]).copy()
        vox[:, 5] = np.array([-3, g ** 3 + 1])[:B]
        assert (vox == 0).any()
        x = torch.from_numpy(r.normal(size=base + B * N * W).astype(np.float32)).to(torch.bfloat16)
        grad = x[base:].view(B, N, W)[..., 3:]
        bits = x.view(torch.int16).numpy().view(np.uint16)
        mirror, reads, taken, leads = _bf16_owner_mirror(vox, bits, base + 3, W, g, k, C, blocks=4)
        all_leads |= leads
        assert sorted(i for t in taken for i in t) == list(range(B * g * parts))
        tvox = torch.as_tensor(vox.astype(np.int32))
        in_grid = neighbor_ids(tvox, torch.ones(B, N), g, k).numpy() >= 0
        in_grid[:, 5] = False
        np.testing.assert_array_equal(reads, np.repeat(in_grid, C, axis=-1).astype(np.int64))
        ordered = table_gather_bwd_ordered(tvox, grad, g, k)
        assert ordered.dtype == torch.bfloat16
        np.testing.assert_array_equal(mirror, ordered.float().numpy())
    assert all_leads == set(range(8))


def test_table_gather_bwd_ordered_skips_vox_outside_the_grid():
    """A vox outside [0, g^3) adds nothing, in the tiling and in the ordered
    plain sum alike; the other rows give what they give alone."""
    r = np.random.default_rng(31)
    g, k, B, N = 4, 3, 2, 16
    vox = np.asarray(jax_voxel_assign(jnp.asarray(_queries(r, B, N, g)), g)[0]).copy()
    bad = np.zeros((B, N), bool)
    bad[:, ::5] = True
    vox[bad] = np.where(r.random(int(bad.sum())) < 0.5, -1 - vox[bad], g ** 3 + vox[bad])
    grad = r.normal(size=(B, N, k ** 3 * 20)).astype(np.float32)
    mirror, reads = _slab_tiling_mirror(vox, grad, g, k)
    assert reads[bad].sum() == 0
    ordered = table_gather_bwd_ordered(torch.as_tensor(vox), torch.as_tensor(grad), g, k)
    np.testing.assert_array_equal(mirror, ordered.numpy())
    kept = torch.as_tensor(np.where(bad, 0, vox).astype(np.int32))
    alone = table_gather_bwd_plain(kept, torch.as_tensor(np.where(bad[..., None], 0, grad)), g, k)
    assert float((ordered - alone).abs().max()) <= REL_BWD * float(alone.abs().max())


def test_table_gather_x_backward_skips_the_adjoint_without_fv_grad():
    """Only queries need a gradient: dq flows, the adjoint is never called
    (its plain version would be; count it through a wrapper)."""
    import dpdist_tpu_torch.kernels.table_gather as tg

    r = np.random.default_rng(3)
    fv = torch.as_tensor(r.normal(size=(1, 64, 20)).astype(np.float32))
    q = torch.tensor(_queries(r, 1, 8, 4), requires_grad=True)
    calls = []
    real = tg.table_gather_bwd
    tg.table_gather_bwd = lambda *a: calls.append(1) or real(*a)
    try:
        x, _ = table_gather_x(fv, q, 4, 3)
        (dq,) = torch.autograd.grad(x.sum(), q)
        fvg = fv.clone().requires_grad_(True)
        x, _ = table_gather_x(fvg, q, 4, 3)
        torch.autograd.grad(x.sum(), (fvg, q))
    finally:
        tg.table_gather_bwd = real
    assert calls == [1]
    np.testing.assert_array_equal(dq.numpy(), np.ones((1, 8, 3), np.float32))
    assert table_gather_x.launches == 0 and table_gather_bwd.launches == 0


def test_plain_versions_are_the_cpu_path():
    r = np.random.default_rng(4)
    fv = torch.as_tensor(r.normal(size=(2, 64, 20)).astype(np.float32))
    q = torch.as_tensor(_queries(r, 2, 8, 4))
    x, vox = table_gather_x(fv, q, 4, 3)
    ref, ref_vox = table_gather_x_plain(fv, q, 4, 3)
    assert torch.equal(x, ref) and torch.equal(vox, ref_vox) and vox.dtype == torch.int32
    grad = torch.as_tensor(r.normal(size=(2, 8, 27 * 20)).astype(np.float32))
    assert torch.equal(table_gather_bwd(vox, grad, 4, 3), table_gather_bwd_plain(vox, grad, 4, 3))


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError),
    ("cells", ValueError),
    ("batch", ValueError),
    ("even_k", ValueError),
    ("noncontiguous", ValueError),
    ("vox_int64", TypeError),
    ("grad_width", ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(case, exc):
    fv, q, g, k = torch.zeros(2, 64, 20), torch.zeros(2, 8, 3), 4, 3
    vox, grad = torch.zeros(2, 8, dtype=torch.int32), torch.zeros(2, 8, 540)
    if case == "float64":
        fv = fv.double()
    elif case == "cells":
        g = 8
    elif case == "batch":
        q = torch.zeros(3, 8, 3)
    elif case == "even_k":
        k = 4
    elif case == "noncontiguous":
        q = torch.zeros(2, 3, 8).transpose(1, 2)
    elif case == "vox_int64":
        vox = vox.long()
    elif case == "grad_width":
        grad = torch.zeros(2, 8, 541)
    with pytest.raises(exc):
        if case in ("vox_int64", "grad_width"):
            table_gather_bwd(vox, grad, g, k)
        else:
            table_gather_x(fv, q, g, k)


def test_mfv_x_backward_matches_pallas_vjp():
    """The port's mfv_x VJP (dq = grad[..., :3]; dfv by the adjoint, then
    through the plain encode) against jax.vjp of mfv_table_gather_x in
    interpret mode, at the JAX kernel test's config. The encodes differ by
    up to 2e-5 (matmul identity against per-dimension sums), which moves
    the points' gradient relative to its size."""
    r = np.random.default_rng(0)
    B, M, N, G, g, k, sigma = 2, 12, 16, 64, 4, 3, 0.25
    pts = r.uniform(-0.9, 0.9, (B, M, 3)).astype(np.float32)
    q = _queries(r, B, N, g)
    co = r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, qq: jax_mfv_x(p, qq, G, sigma, g, k, interpret=True),
                     jnp.asarray(pts), jnp.asarray(q))
    jdp, jdq = (np.asarray(a) for a in vjp(jnp.asarray(co)))
    tp, tq = torch.tensor(pts, requires_grad=True), torch.tensor(q, requires_grad=True)
    x, _ = mfv_x(tp, tq, G, sigma, g, k)
    dp, dq = torch.autograd.grad((x * torch.as_tensor(co)).sum(), (tp, tq))
    np.testing.assert_array_equal(dq.numpy(), jdq)
    np.testing.assert_allclose(dp.numpy(), jdp, atol=1e-3 * np.abs(jdp).max(), rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_threedmfv_gradient_matches_jax(seed):
    """d threedmfv / d points against JAX's XLA encode, relative to the
    gradient's size: the two form squared distances differently (per
    dimension here, by the matmul identity there), so the FV values differ
    by up to 2e-5 and the signed sqrt's slope amplifies that where a pooled
    value is small."""
    r = np.random.default_rng(seed)
    pts = r.uniform(-1.05, 1.05, (2, 40, 3)).astype(np.float32)
    co = r.normal(size=(2, 512, 20)).astype(np.float32)
    want = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_threedmfv(p, 512, 0.125, impl="xla") * co))(jnp.asarray(pts)))
    tp = torch.tensor(pts, requires_grad=True)
    (got,) = torch.autograd.grad((threedmfv(tp, 512, 0.125) * torch.as_tensor(co)).sum(), tp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max(), rtol=0)


def test_threedmfv_max_ties_split_gradient_evenly():
    """Two copies of one point tie in every max and min pool; amax/amin
    split the gradient evenly between them, as JAX's max does, so both
    copies get the same gradient, and JAX agrees."""
    r = np.random.default_rng(2)
    pts = r.uniform(-0.8, 0.8, (1, 6, 3)).astype(np.float32)
    pts[0, 5] = pts[0, 4]
    co = r.normal(size=(1, 64, 20)).astype(np.float32)
    tp = torch.tensor(pts, requires_grad=True)
    (got,) = torch.autograd.grad((threedmfv(tp, 64, 0.25) * torch.as_tensor(co)).sum(), tp)
    np.testing.assert_allclose(got[0, 4].numpy(), got[0, 5].numpy(), rtol=1e-5, atol=1e-7)
    want = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_threedmfv(p, 64, 0.25, impl="xla") * co))(jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max(), rtol=0)


def test_voxel_assign_gradient_is_identity_and_cells_are_constant():
    r = np.random.default_rng(3)
    q = torch.tensor(_queries(r, 2, 32, 8), requires_grad=True)
    vox, mask, delta = voxel_assign(q, 8)
    co = torch.as_tensor(r.normal(size=(2, 32, 3)).astype(np.float32))
    (dq,) = torch.autograd.grad((delta * co).sum(), q)
    assert torch.equal(dq, co)
    assert not vox.requires_grad and not mask.requires_grad
    # A nudge inside a cell keeps the cell.
    inner = torch.as_tensor(np.float32([[[0.1, -0.3, 0.6]]]))
    assert torch.equal(voxel_assign(inner, 8)[0], voxel_assign(inner + 1e-3, 8)[0])
