"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import tempfile

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist, nn_min_sqdist_plain
from dpdist_tpu_torch.kernels.fused_forward import fused_forward, fused_forward_plain, pack_decoder
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused, gather_patches_fused_plain
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_bwd_ordered,
    table_gather_bwd_plain,
    table_gather_plain,
    table_gather_x,
    table_gather_x_plain,
)
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
from dpdist_tpu_torch.ops import voxel_assign
from dpdist_tpu_torch.ops.threedmfv import threedmfv_plain

# Kernel vs plain version: both form squared distances per dimension and
# differ only in summation order and in the device's exp.
TOL_X = 2e-5
# Adjoint kernel vs autograd of the plain gather, relative to the largest
# |dfv|: the sums run in another order where queries share a voxel, and
# their rounding grows with their size (cell 0 collects every off-grid
# query, more of them at larger N). On the H100 the error read 2.7e-7 of
# the largest entry at B = 256, N = 64 (7.63e-6 of 28.6) and at N = 200
# (1.14e-5 of 42.6).
REL_BWD = 1e-6
# NN-min kernel vs plain: the kernel sums the per-dimension squares with
# FMAs, so the last bits may differ; within TOL_NN_ABS + TOL_NN_REL * |d|.
TOL_NN_ABS, TOL_NN_REL = 1e-6, 1e-5
# Fused forward kernel vs plain, on pre-activation outputs: both sum exact
# bf16 products in float32, in other orders (the tensor cores' float32
# accumulation does not round to nearest at each add), and a hidden
# activation at a bf16 rounding edge may round the other way. On the H100,
# against float64 sums, the plain version strayed by up to 8.7e-3 and the
# kernel by up to 9.8e-3 on a committed net (chip_smoke.py prints both).
TOL_FF = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _edge_inputs(B, M, N, g, seed=0):
    """Clouds with coordinates on cell edges; queries partly off-grid."""
    r = np.random.default_rng(seed)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    pts = r.uniform(-0.95, 0.95, (B, M, 3)).astype(np.float32)
    pick = r.random(pts.shape) < 0.1
    pts[pick] = r.choice(edges[1:-1], pick.sum())
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    pick = r.random(q.shape) < 0.15
    q[pick] = r.choice(edges, pick.sum())
    return pts, q


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,M,N,G,g,k,sigma", [
    (512, 64, 64, 512, 8, 5, 0.125),   # the main path: 2B = 512 clouds
    (2, 12, 16, 64, 4, 3, 0.25),       # the JAX kernel test's config
    (3, 61, 200, 512, 8, 5, 0.125),    # ragged M, N above one TPU query tile: two runs a cloud
    (3, 61, 13, 512, 8, 5, 0.125),     # clouds 2 and 3 start off the 4- and 8-row groups
    (1, 1, 1, 512, 8, 5, 0.125),       # one point, one query: no whole row group
    (1, 64, 128, 512, 8, 5, 0.125),    # N = 128, the most the route sends
    (3, 1, 128, 512, 8, 5, 0.125),     # M = 1
    (3, 37, 13, 64, 4, 3, 0.25),       # g = 4, k = 3: W = 543
    (2, 20, 13, 729, 9, 5, 0.1),       # 729 encode threads in a block of 1,024, rows by
                                       # per-thread stores; sigma not a power of two
])
def test_mfv_x_kernel_matches_plain(cuda, B, M, N, G, g, k, sigma, dtype):
    """x within TOL_X of the plain version, vox exact, with queries off the
    grid and on cell edges; a bf16 x is the float32 kernel's x rounded once.
    With no input needing a gradient the call records no graph and counts
    one launch."""
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(B, M, N, g))
    before = mfv_x.launches
    x, vox = mfv_x(pts, q, G, sigma, g, k, dtype=dtype)
    torch.cuda.synchronize()
    assert mfv_x.launches == before + 1
    assert x.grad_fn is None and x.dtype == dtype
    ref, ref_vox = mfv_x_plain(pts, q, G, sigma, g, k)
    assert x.shape == ref.shape and vox.dtype == torch.int32
    assert torch.equal(vox, ref_vox)
    if dtype == torch.float32:
        assert float((x - ref).abs().max()) <= TOL_X
    else:
        with torch.no_grad():
            x32 = mfv_x(pts, q, G, sigma, g, k)[0]
        assert torch.equal(x, x32.to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,g,k,C", [
    (256, 64, 8, 5, 20),   # the main path
    (2, 16, 4, 3, 20),     # the JAX kernel test's small config
    (3, 200, 8, 5, 20),    # N not a multiple of the block's 32 rows
    (1, 1, 8, 5, 20),      # one row, shorter than a row group
    (3, 13, 8, 5, 20),     # clouds 2 and 3 start off the 4- and 8-row group boundaries
    (1, 200, 8, 5, 20),    # one cloud split over many work items
    (3, 13, 4, 3, 20),     # W = 543
    (3, 13, 4, 3, 7),      # C = 7: one-element chunks, W = 192
    (2, 13, 3, 3, 7),      # a volume of 756 B: staged by the threads, not one bulk copy
    (2, 13, 8, 7, 20),     # W = 6,863: no room for row groups
    (2, 13, 10, 5, 20),    # an 80 KB volume: one volume buffer, staged after each item
])
def test_table_gather_x_kernel_matches_plain(cuda, B, N, g, k, C, dtype):
    """x and vox exact; a bf16 x is the float32 one rounded once."""
    r = np.random.default_rng(1)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=2)[1], device=cuda)
    before = table_gather_x.launches
    with torch.no_grad():
        x, vox = table_gather_x(fv, q, g, k, dtype=dtype)
    torch.cuda.synchronize()
    assert table_gather_x.launches == before + 1
    ref, ref_vox = table_gather_x_plain(fv, q, g, k)
    assert torch.equal(vox, ref_vox)
    assert x.dtype == dtype and torch.equal(x, ref.to(dtype))   # a copy plus q - centre: exact


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("B,N,g,k", [
    (256, 64, 8, 5),    # the main path
    (2, 16, 4, 3),      # the JAX kernel test's small config
    (3, 200, 8, 5),
    (1, 1, 8, 5),       # one query
    (3, 13, 8, 5),      # a list shorter than one ring stage
])
def test_table_gather_bwd_kernel_matches_plain(cuda, B, N, g, k, strided):
    """Gradient on every row, off-grid ones included (they scatter into
    cell 0's neighbourhood); the grad is the strided patch part of x's
    gradient or a contiguous one (row 6's backward); two runs agree bit for
    bit, and with the ordered plain sum (the kernel sums in query order)."""
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=3)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, 20, device=cuda), q, g, k)
    r = np.random.default_rng(4)
    gx = torch.as_tensor(r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32), device=cuda)
    grad = gx[..., 3:] if strided else gx[..., 3:].contiguous()
    before = table_gather_bwd.launches
    dfv = table_gather_bwd(vox, grad, g, k)
    dfv2 = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    assert table_gather_bwd.launches == before + 2
    assert torch.equal(dfv, dfv2)
    assert torch.equal(dfv, table_gather_bwd_ordered(vox, grad, g, k))
    ref = table_gather_bwd_plain(vox, grad, g, k)
    assert float((dfv - ref).abs().max()) <= REL_BWD * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [True, False])
def test_table_gather_bwd_kernel_at_256_queries(cuda, strided):
    """The np = 256 frozen loss's size (more ring stages than the ring
    holds): bit for bit the ordered plain sum and the same from run to run,
    and within REL_BWD of float64 sums. Against a float32 plain version in
    another order the slots with the most terms (cell 0's neighbourhood)
    differ by up to ~8e-7 of the largest entry, both sides rounding."""
    B, N, g, k = 256, 256, 8, 5
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=26)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, 20, device=cuda), q, g, k)
    gx = torch.as_tensor(np.random.default_rng(27).normal(
        size=(B, N, 3 + k ** 3 * 20)).astype(np.float32), device=cuda)
    grad = gx[..., 3:] if strided else gx[..., 3:].contiguous()
    dfv = table_gather_bwd(vox, grad, g, k)
    assert torch.equal(dfv, table_gather_bwd(vox, grad, g, k))
    assert torch.equal(dfv, table_gather_bwd_ordered(vox, grad, g, k))
    ref = table_gather_bwd_plain(vox, grad.double(), g, k)
    assert float((dfv.double() - ref).abs().max()) <= REL_BWD * float(ref.abs().max())


@pytest.mark.gpu
def test_table_gather_bwd_kernel_vox_outside_the_grid_and_off_grid_rows(cuda):
    """A vox outside [0, V) adds nothing; off-grid rows (vox 0) scatter
    into cell 0's neighbourhood and nowhere else."""
    B, N, g, k = 3, 40, 8, 5
    r = np.random.default_rng(24)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=25)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, 20, device=cuda), q, g, k)
    grad = torch.as_tensor(r.normal(size=(B, N, k ** 3 * 20)).astype(np.float32), device=cuda)
    bad = torch.as_tensor(r.random((B, N)) < 0.2, device=cuda)
    bad[:, 0] = True
    vox_bad = torch.where(bad, torch.where(torch.as_tensor(r.random((B, N)) < 0.5, device=cuda),
                                           -1 - vox, g ** 3 + vox), vox).to(torch.int32)
    dfv = table_gather_bwd(vox_bad, grad, g, k)
    assert torch.equal(dfv, table_gather_bwd_ordered(vox_bad, grad, g, k))
    alone = table_gather_bwd_plain(vox, torch.where(bad[..., None], 0.0, grad), g, k)
    assert float((dfv - alone).abs().max()) <= REL_BWD * float(alone.abs().max())
    # Every query off the grid: only cells within k/2 of cell 0 on each axis.
    zero = torch.zeros(B, N, dtype=torch.int32, device=cuda)
    dfv0 = table_gather_bwd(zero, grad, g, k).view(B, g, g, g, 20)
    assert torch.equal(dfv0.flatten(1), table_gather_bwd_ordered(zero, grad, g, k).flatten(1))
    kh = k // 2
    assert bool((dfv0[:, kh + 1:] == 0).all() and (dfv0[:, :, kh + 1:] == 0).all()
                and (dfv0[:, :, :, kh + 1:] == 0).all())
    assert bool((dfv0[:, :kh + 1, :kh + 1, :kh + 1] != 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [(2, 50, 16, 7, 20), (1, 300, 16, 5, 20)])
def test_table_gather_bwd_kernel_past_the_gathers_volume(cuda, B, N, g, k, C):
    """The float32 adjoint stages grad runs, not the (g^3, C) volume, so it
    takes a g = 16, C = 20 grid (a 320 KB volume, past a block's shared
    memory, which the gathers refuse; four passes of 256 x 5 slots a slab):
    bit for bit the ordered plain sum, the same from run to run, and within
    REL_BWD of float64 sums."""
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=50)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)
    grad = torch.as_tensor(np.random.default_rng(51).normal(
        size=(B, N, 3 + k ** 3 * C)).astype(np.float32), device=cuda)[..., 3:]
    before = table_gather_bwd.launches
    dfv = table_gather_bwd(vox, grad, g, k)
    assert torch.equal(dfv, table_gather_bwd(vox, grad, g, k))
    assert table_gather_bwd.launches == before + 2
    assert torch.equal(dfv, table_gather_bwd_ordered(vox, grad, g, k))
    ref = table_gather_bwd_plain(vox, grad.double(), g, k)
    assert float((dfv.double() - ref).abs().max()) <= REL_BWD * float(ref.abs().max())


def _beyond_one_ulp(dfv, exact):
    """Entries of a bf16 dfv more than one bf16 ulp (of the exact sum
    rounded) from the exact sums (float64, or float32 where they are
    exact)."""
    exact = exact.double()
    ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact.to(torch.bfloat16).double())[1] - 8)
    return int(((dfv.double() - exact).abs() > ulp).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [True, False])
@pytest.mark.parametrize("B,N,g,k,C", [
    (256, 64, 8, 5, 20),    # the bf16 frozen loss at np = 64
    (256, 256, 8, 5, 20),   # and at np = 256
    (2, 16, 4, 3, 20),
    (3, 13, 8, 5, 20),
    (1, 1, 8, 5, 20),
    (3, 40, 8, 5, 7),       # C = 7: owners of 10 channels, 3 of them past the cell's
    (2, 37, 4, 3, 7),
    (2, 50, 16, 7, 20),     # g = 16, k = 7: two parts a slab
    (2, 300, 8, 5, 20),     # N past one producer chunk of 128 queries
    (1, 1000, 2, 5, 7),     # every query's window meets every slab: many stages an item
])
def test_table_gather_bwd_bf16_kernel_matches_ordered_sum(cuda, B, N, g, k, C, strided):
    """Row 3 on a bf16 grad (the strided patch part of a bf16 x's gradient,
    or a contiguous one): a bf16 dfv equal bit for bit to the ordered plain
    sum of the float32 upcast rounded once, the same from run to run, and
    counted as a bf16 launch."""
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=30)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)
    gx = torch.as_tensor(np.random.default_rng(31).normal(
        size=(B, N, 3 + k ** 3 * C)).astype(np.float32), device=cuda).to(torch.bfloat16)
    grad = gx[..., 3:] if strided else gx[..., 3:].contiguous()
    before = (table_gather_bwd.launches, table_gather_bwd.launches_bf16)
    dfv = table_gather_bwd(vox, grad, g, k)
    dfv2 = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    assert (table_gather_bwd.launches, table_gather_bwd.launches_bf16) == (before[0],
                                                                           before[1] + 2)
    assert dfv.dtype == torch.bfloat16 and torch.equal(dfv, dfv2)
    assert torch.equal(dfv, table_gather_bwd_ordered(vox, grad, g, k))
    assert torch.equal(dfv, table_gather_bwd_ordered(vox, grad.float(), g, k).to(torch.bfloat16))
    assert _beyond_one_ulp(dfv, table_gather_bwd_plain(vox, grad.double(), g, k)) == 0


def _leads(grad, vox, g, k):
    """The 2-byte offsets within 16 bytes at which the runs that row 3
    reads start (one run per query and slab its window meets)."""
    C = grad.shape[2] // k ** 3
    v = vox.long().cpu()
    di = torch.arange(g)[None, None] - v[..., None] // g ** 2 + k // 2          # (B, N, g)
    hit = (di >= 0) & (di < k) & (v[..., None] >= 0) & (v[..., None] < g ** 3)
    n = torch.arange(grad.shape[1])[None, :, None]
    b = torch.arange(grad.shape[0])[:, None, None]
    elem = grad.storage_offset() + b * grad.stride(0) + n * grad.stride(1) + di * k * k * C
    return set((elem[hit] % 8).tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [20, 7])
@pytest.mark.parametrize("base", range(8))
def test_table_gather_bwd_bf16_kernel_every_lead(cuda, base, C):
    """Runs of a strided bf16 grad that start at every 2-byte offset within
    16 bytes (the view starts `base` elements into its buffer; rows of
    3 + k^3 * C elements, an odd stride at C = 20, runs of 175 elements at
    C = 7), off-grid rows included: bit for bit the ordered sum, the same
    from run to run."""
    B, N, g, k = 2, 41, 8, 5
    W = 3 + k ** 3 * C
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=40 + base)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)
    flat = torch.as_tensor(np.random.default_rng(41).normal(size=base + B * N * W).astype(
        np.float32), device=cuda).to(torch.bfloat16)
    grad = flat[base:].view(B, N, W)[..., 3:]
    assert _leads(grad, vox, g, k) == set(range(8))
    before = table_gather_bwd.launches_bf16
    dfv = table_gather_bwd(vox, grad, g, k)
    again = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    assert table_gather_bwd.launches_bf16 == before + 2
    assert torch.equal(dfv, again) and torch.equal(dfv, table_gather_bwd_ordered(vox, grad, g, k))
    assert _beyond_one_ulp(dfv, table_gather_bwd_plain(vox, grad.double(), g, k)) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("C", [20, 7])
def test_table_gather_bwd_bf16_kernel_skips_vox_outside_the_grid(cuda, C):
    """A vox outside [0, g^3) adds nothing in the bf16 kernel either; every
    query off the grid (vox 0) fills only cell 0's neighbourhood."""
    B, N, g, k = 3, 40, 8, 5
    r = np.random.default_rng(26)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=27)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)
    grad = torch.as_tensor(r.normal(size=(B, N, k ** 3 * C)).astype(np.float32),
                           device=cuda).to(torch.bfloat16)
    bad = torch.as_tensor(r.random((B, N)) < 0.2, device=cuda)
    bad[:, 0] = True
    vox_bad = torch.where(bad, torch.where(torch.as_tensor(r.random((B, N)) < 0.5, device=cuda),
                                           -1 - vox, g ** 3 + vox), vox).to(torch.int32)
    before = table_gather_bwd.launches_bf16
    dfv = table_gather_bwd(vox_bad, grad, g, k)
    assert torch.equal(dfv, table_gather_bwd(vox_bad, grad, g, k))
    assert table_gather_bwd.launches_bf16 == before + 2
    assert torch.equal(dfv, table_gather_bwd_ordered(vox_bad, grad, g, k))
    kept = torch.where(bad, torch.zeros_like(vox), vox)
    alone = table_gather_bwd_ordered(kept, torch.where(bad[..., None], 0.0, grad.float()), g, k)
    assert torch.equal(dfv, alone.to(torch.bfloat16))
    zero = torch.zeros(B, N, dtype=torch.int32, device=cuda)
    dfv0 = table_gather_bwd(zero, grad, g, k)
    assert torch.equal(dfv0, table_gather_bwd_ordered(zero, grad, g, k))
    dfv0 = dfv0.view(B, g, g, g, C)
    kh = k // 2
    assert bool((dfv0[:, kh + 1:] == 0).all() and (dfv0[:, :, kh + 1:] == 0).all()
                and (dfv0[:, :, :, kh + 1:] == 0).all())
    assert bool((dfv0[:, :kh + 1, :kh + 1, :kh + 1] != 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("g,k,C", [(8, 5, 20), (8, 5, 7), (16, 7, 20), (4, 9, 20), (255, 5, 20),
                                   (16, 33, 26), (16, 33, 27), (256, 5, 20), (8, 19, 20)])
def test_table_gather_bwd_bf16_fits_matches_the_c_plan(cuda, g, k, C):
    """route's table_gather_bwd_fits in bf16 takes what the C entry's
    launch plan takes on this card, and bwd_bf16_smem is the plan's shared
    memory at its runs a stage. (16, 33, 26) is the last C at k = 33 whose
    one run a stage fits a block, (16, 33, 27) the first that does not."""
    import ctypes

    from dpdist_tpu_torch.kernels import build
    from dpdist_tpu_torch.kernels.table_gather import bwd_bf16_smem, table_gather_bwd_fits

    out = (ctypes.c_int64 * 6)()
    rc = build.library().dpdist_table_gather_bwd_bf16_plan(2, g, k, C, cuda.index, out)
    assert (rc == 0) == table_gather_bwd_fits(g, k, C, torch.bfloat16)
    if rc == 0:
        consumers, parts, runs, smem = list(out)[:4]
        assert 1 <= runs <= 8 and smem == bwd_bf16_smem(k, C, runs)
        assert parts * consumers >= g * g * -(-C // 10)


def _bf16_grads(fn, inputs, co):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y = fn(*leaves)
    return y, torch.autograd.grad((y.float() * co[..., -y.shape[-1]:]).sum(), leaves)


@pytest.mark.gpu
def test_bf16_functions_match_the_plain_composition(cuda):
    """The bf16 autograd Functions of rows 1, 2, 6 and 10 on the card
    against autograd through the plain composition with the same rounding
    points (the volume taken in bf16, x rounded to bf16): outputs equal,
    dq equal, dfv and d points within 1e-2 of their largest entry (the
    adjoint's float32 sums run in another order before the one rounding);
    each backward launches the bf16 adjoint once."""
    bf = torch.bfloat16
    B, M, N, g, k = 64, 64, 64, 8, 5
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(B, M, N, g, seed=32))
    fv = torch.as_tensor(np.random.default_rng(33).normal(size=(B, g ** 3, 20)).astype(np.float32),
                         device=cuda)
    co = torch.as_tensor(np.random.default_rng(34).normal(
        size=(B, N, 3 + k ** 3 * 20)).astype(np.float32), device=cuda).to(bf).float()
    vox, mask, _ = voxel_assign(q, g)
    cases = (
        ("row 1", lambda p_, q_: mfv_x(p_, q_, 512, 0.125, g, k, dtype=bf)[0],
         lambda p_, q_: mfv_x_plain(p_, q_, 512, 0.125, g, k)[0].to(bf), (pts, q)),
        ("row 2", lambda f, q_: table_gather_x(f, q_, g, k, dtype=bf)[0],
         lambda f, q_: table_gather_x_plain(f.to(bf).float(), q_, g, k)[0].to(bf), (fv, q)),
        ("row 6", lambda f: table_gather(f, vox, g, k, dtype=bf),
         lambda f: table_gather_plain(f.to(bf).float(), vox, g, k).to(bf), (fv,)),
        ("row 10", lambda f: gather_patches_fused(f, vox, mask, g, k, dtype=bf),
         lambda f: gather_patches_fused_plain(f.to(bf).float(), vox, mask, g, k), (fv,)),
    )
    for name, fn, plain, inputs in cases:
        before = table_gather_bwd.launches_bf16
        y, got = _bf16_grads(fn, inputs, co)
        torch.cuda.synchronize()
        assert table_gather_bwd.launches_bf16 == before + 1, name
        y_ref, want = _bf16_grads(plain, inputs, co)
        assert y.dtype == y_ref.dtype, name
        if name == "row 1":   # the encode sums in another order (TOL_X): a rounding may flip
            assert torch.allclose(y.float(), y_ref.float(), atol=TOL_X, rtol=2 ** -7), name
        else:
            assert torch.equal(y, y_ref), name
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32, name
            err = float((g_ - w_).abs().max())
            assert err <= 1e-2 * float(w_.abs().max()), (name, err)


@pytest.mark.gpu
def test_mfv_x_backward_matches_plain_composition(cuda):
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(64, 64, 64, 8, seed=5))
    co = torch.as_tensor(np.random.default_rng(6).normal(
        size=(64, 64, 2503)).astype(np.float32), device=cuda)
    grads = []
    for fn in (mfv_x, mfv_x_plain):
        p, qq = pts.clone().requires_grad_(), q.clone().requires_grad_()
        x = fn(p, qq, 512, 0.125, 8, 5)[0]
        grads.append(torch.autograd.grad((x * co).sum(), (p, qq)))
    (dp, dq), (dp_ref, dq_ref) = grads
    assert torch.equal(dq, dq_ref)
    # Relative to the largest entry: the encode's backward runs on fv
    # values that differ by the kernel's 2e-5.
    assert float((dp - dp_ref).abs().max()) <= 1e-3 * float(dp_ref.abs().max())


@pytest.mark.gpu
def test_frozen_loss_launch_counts(cuda):
    """loss_fn(pcA, pcB) differentiated in pcA: two forward launches (one
    per direction) and one adjoint launch (only surface(A) needs dfv)."""
    from dpdist_tpu_torch.configs import DPDistConfig
    from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
    from dpdist_tpu_torch.models import init_dpdist

    cfg = DPDistConfig(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
    params, _ = init_dpdist(cfg, torch.Generator().manual_seed(0), cuda)
    pcA, pcB = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(4, 16, 16, 4, seed=7))
    pcA.requires_grad_(True)
    loss_fn = make_frozen_dpdist_loss(params, cfg)
    counts = (table_gather_x.launches, table_gather_bwd.launches, mfv_x.launches)
    (dA,) = torch.autograd.grad(loss_fn(pcA, pcB), pcA)
    torch.cuda.synchronize()
    got = (table_gather_x.launches - counts[0], table_gather_bwd.launches - counts[1],
           mfv_x.launches - counts[2])
    assert got == (2, 1, 0)
    assert bool(torch.isfinite(dA).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,G,sigma", [
    (4, 256, 512, 0.125),     # the np = 256 path
    (3, 1000, 512, 0.125),    # a ragged last tile
    (2, 130, 64, 0.25),       # a small grid
    (2, 1, 512, 0.125),       # one point
    (3, 300, 64, 0.3),        # a sigma that is no power of two: true divisions
])
def test_threedmfv_kernel_matches_plain(cuda, B, N, G, sigma):
    """With coordinates on cell edges and a few points far outside the grid."""
    pts = _edge_inputs(B, N, 1, 8, seed=8)[0]
    pts[:, : max(1, N // 50)] = np.float32(4.5)
    pts = torch.as_tensor(pts, device=cuda)
    before = threedmfv_kernel.launches
    fv = threedmfv_kernel(pts, G, sigma)
    torch.cuda.synchronize()
    assert threedmfv_kernel.launches == before + 1
    ref = threedmfv_plain(pts, G, sigma)
    assert fv.shape == ref.shape and bool(torch.isfinite(fv).all())
    assert float((fv - ref).abs().max()) <= TOL_X


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [
    (1, 10000),   # eval_pair: one cloud split over about 160 blocks
    (3, 129),     # chunks of 32 points, the last one ragged
    (256, 256),   # the np = 256 path: one block per cloud, no merge
    (300, 64),    # the batch fills the card alone
    (2, 1),       # one point, one chunk
])
def test_threedmfv_split_kernel_matches_plain(cuda, B, N):
    """The encode split over blocks (partial pools, then the merge)
    against the plain encode, with coordinates on cell edges and about 1 %
    of the points (the first one at least) far outside the grid."""
    from dpdist_tpu_torch.kernels.threedmfv import split_plan

    S, chunk = split_plan(B, N, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert (S - 1) * chunk < N <= S * chunk
    r = np.random.default_rng(B * N)
    pts = _edge_inputs(B, N, 1, 8, seed=B + N)[0]
    far = r.random((B, N)) < 0.01
    far[:, 0] = True
    pts[far] = (r.choice([-1.0, 1.0], (int(far.sum()), 3)) * 4.5).astype(np.float32)
    pts = torch.as_tensor(pts, device=cuda)
    before = threedmfv_kernel.launches
    fv = threedmfv_kernel(pts, 512, 0.125)
    torch.cuda.synchronize()
    assert threedmfv_kernel.launches == before + 1
    ref = threedmfv_plain(pts, 512, 0.125)
    assert fv.shape == ref.shape == (B, 512, 20) and bool(torch.isfinite(fv).all())
    assert float((fv - ref).abs().max()) <= TOL_X
    assert torch.equal(threedmfv_kernel(pts, 512, 0.125), fv)   # the same from run to run


@pytest.mark.gpu
def test_threedmfv_kernel_backward_replays_the_plain_encode(cuda):
    pts = torch.as_tensor(_edge_inputs(4, 256, 1, 8, seed=9)[0], device=cuda)
    co = torch.as_tensor(np.random.default_rng(10).normal(size=(4, 512, 20)).astype(np.float32),
                         device=cuda)
    grads = []
    for fn in (threedmfv_kernel, threedmfv_plain):
        p = pts.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(p, 512, 0.125) * co).sum(), p)[0])
    # The replay is the plain encode's own backward: equal.
    assert torch.equal(grads[0], grads[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,g,k,C", [
    (256, 256, 8, 5, 20),   # the main path's shape
    (2, 16, 4, 3, 7),       # chunks of 1 element (C = 7)
    (3, 200, 8, 5, 20),     # runs of 128 and 72 rows
    (2, 13, 8, 5, 20),      # a run's tail past its groups (4 f32, 8 bf16 rows)
    (2, 200, 8, 5, 7),      # C = 7: groups of 8 f32 or 16 bf16 rows
    (1, 3000, 8, 5, 20),    # one cloud over many runs (dense evaluation)
    (2, 100, 2, 1, 1),      # rows of one element
])
def test_table_gather_kernel_matches_plain(cuda, B, N, g, k, C, dtype):
    """Exact, off-grid queries (vox 0) included: float32, and bfloat16 equal
    to the float32 values rounded once; one launch a call."""
    r = np.random.default_rng(11)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=12)[1], device=cuda)
    vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)[1]
    before = table_gather.launches
    out = table_gather(fv, vox, g, k, dtype=dtype)
    torch.cuda.synchronize()
    assert table_gather.launches == before + 1
    assert out.dtype == dtype and torch.equal(out, table_gather_plain(fv, vox, g, k).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_gather_kernel_vox_outside_the_grid(cuda, dtype):
    """A vox outside [0, V) (never made by voxel_assign) gives a zero row;
    the other rows are the plain version's."""
    B, N, g, k, C = 3, 150, 8, 5, 20
    G = g ** 3
    r = np.random.default_rng(15)
    fv = torch.as_tensor(r.normal(size=(B, G, C)).astype(np.float32), device=cuda)
    vox = torch.as_tensor(r.integers(-3, G + 3, (B, N)).astype(np.int32), device=cuda)
    vox[:, :2] = torch.tensor([-1, G], dtype=torch.int32, device=cuda)
    inside = (vox >= 0) & (vox < G)
    out = table_gather(fv, vox, g, k, dtype=dtype)
    torch.cuda.synchronize()
    want = table_gather_plain(fv, torch.where(inside, vox, torch.zeros_like(vox)), g, k)
    want = torch.where(inside[..., None], want, torch.zeros_like(want)).to(dtype)
    assert bool((~inside).sum() >= 2 * B) and torch.equal(out, want)


@pytest.mark.gpu
def test_table_gather_c_entry_refuses_past_the_shared_memory_limit(cuda):
    """table_gather_fits holds exactly where the persistent gathers' plan
    finds a layout: at g = 8, 112 channels fit (the kernel runs, exact) and
    113 do not (the C entry refuses the launch, as table_gather_fits
    does)."""
    from dpdist_tpu_torch.kernels import build
    from dpdist_tpu_torch.kernels.table_gather import table_gather_fits

    g, k = 8, 1
    assert table_gather_fits(g, k, 112) and not table_gather_fits(g, k, 113)
    r = np.random.default_rng(16)
    fv = torch.as_tensor(r.normal(size=(2, g ** 3, 112)).astype(np.float32), device=cuda)
    vox = torch.as_tensor(r.integers(0, g ** 3, (2, 40)).astype(np.int32), device=cuda)
    assert torch.equal(table_gather(fv, vox, g, k), table_gather_plain(fv, vox, g, k))
    fv = torch.zeros(2, g ** 3, 113, device=cuda)
    out = torch.empty(2, 40, 113, device=cuda)
    err = build.library().dpdist_table_gather(
        fv.data_ptr(), vox.data_ptr(), out.data_ptr(), 2, 40, g, k, 113, 0, cuda.index,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert err != 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_gather_kernel_past_65535_query_tiles(cuda, dtype):
    """Fault 5: 2,097,152 queries a cloud (a 128^3 field) was 65,536 tiles
    of 32 under the old one-block-a-tile grid, one past the grid's y limit;
    the persistent gather walks the cloud's runs of 128 rows (16,384 of
    them) whatever N. A small window (g = 2, k = 1, C = 1: an 8 MB
    output), exact, with the vox of every query distinct from its
    neighbours'."""
    B, N, g, k, C = 2, 128 ** 3, 2, 1, 1
    r = np.random.default_rng(13)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    vox = torch.as_tensor(r.integers(0, g ** 3, (B, N)).astype(np.int32), device=cuda)
    before = table_gather.launches
    out = table_gather(fv, vox, g, k, dtype=dtype)
    torch.cuda.synchronize()
    assert table_gather.launches == before + 1
    assert torch.equal(out, table_gather_plain(fv, vox, g, k).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_gather_bwd_kernel_past_32_bit_cloud_offsets(cuda, dtype):
    """Fault 5: row 3 addressed a cloud's grad rows with 32-bit offsets, so
    it refused (N - 1) * 2,500 + 2,500 > 2^31 - 1 at k = 5, C = 20; such a
    cloud now takes its 64-bit-offset instantiation, in float32 and in
    bfloat16. N = 860,000 (8.6 GB of float32 grad) against autograd of the
    plain gather, exactly: the grad holds small integers, whose sums (below
    2^24) are exact in any order, and a bf16 dfv is that sum rounded once,
    so within one bf16 ulp of it."""
    B, N, g, k, C = 1, 860_000, 8, 5, 20
    assert (N - 1) * k ** 3 * C + k ** 3 * C > 2 ** 31 - 1
    r = np.random.default_rng(14)
    vox = torch.as_tensor(r.integers(0, g ** 3, (B, N)).astype(np.int32), device=cuda)
    grad = torch.randint(-4, 5, (B, N, k ** 3 * C), dtype=torch.int8, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(14)).to(dtype)
    before = (table_gather_bwd.launches, table_gather_bwd.launches_bf16)
    dfv = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (table_gather_bwd.launches, table_gather_bwd.launches_bf16) == (
        before[0] + (not bf16), before[1] + bf16)
    exact = table_gather_bwd_plain(vox, grad.float(), g, k)
    assert dfv.dtype == dtype and torch.equal(dfv, exact.to(dtype))
    assert not bf16 or _beyond_one_ulp(dfv, exact) == 0


def _cuda_kernels(fn, calls):
    """Names of the CUDA kernels that `calls` calls of fn launch, as
    torch.profiler records them (memsets and copies are not kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memset", "Memcpy"))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,scale,dup", [
    (1, 10000, 10000, 1, False),   # eval_pair's clouds
    (2, 1000, 4099, 1, False),
    (3, 37, 5, 1, False),
    (256, 64, 64, 1, False),
    (1, 1, 777, 1, False),         # N = 1
    (2, 500, 1, 1, False),         # M = 1
    (2, 3000, 3, 1, False),        # M below one float4 group of p
    (2, 1025, 1025, 1, False),     # N and M one past a tile of a and a chunk of p
    (3, 10000, 2000, 1, False),    # B = 3, N = 10,000
    (1, 4000, 3000, 100.0, False),  # coordinates x100
    (2, 2000, 2500, 1, True),      # points of a duplicated in p: d = 0 exactly
])
def test_nn_min_sqdist_kernel_matches_plain(cuda, B, N, M, scale, dup):
    """Within TOL_NN of the plain version, one CUDA kernel per call (the
    fill of dist is a memset), the same bits from run to run. The profiler
    may drop a record of a short run, so it shows that a call launches
    nn_min_kernel and nothing else, at most once; that it launches it at
    least once shows in dist, which the memset fills with NaN bits."""
    r = np.random.default_rng(N + M)
    a, p = (r.uniform(-1, 1, (B, n, 3)).astype(np.float32) * np.float32(scale) for n in (N, M))
    if dup:
        p[:, :min(N, M):2] = a[:, :min(N, M):2]
    a, p = (torch.as_tensor(t, device=cuda) for t in (a, p))
    before = nn_min_sqdist.launches
    d = nn_min_sqdist(a, p)
    torch.cuda.synchronize()
    assert nn_min_sqdist.launches == before + 1
    ref = nn_min_sqdist_plain(a, p)
    assert bool(((d - ref).abs() <= TOL_NN_ABS + TOL_NN_REL * ref.abs()).all())
    if dup:
        assert bool((d[:, :min(N, M):2] == 0).all())
    names = _cuda_kernels(lambda: nn_min_sqdist(a, p), calls=5)
    assert 1 <= len(names) <= 5 and all("nn_min_kernel" in n for n in names), names
    assert torch.equal(nn_min_sqdist(a, p), d)


@pytest.mark.gpu
def test_served_forward_on_large_clouds(cuda):
    """M = N = 5,083 points, where the fused kernel's shared memory used to
    run out: the forward takes the table path, rows 7 and 6, twice each."""
    from dpdist_tpu_torch.serving import load_frozen_distance

    model = load_frozen_distance("results/ckpt_best", device=cuda)
    r = np.random.default_rng(13)
    pcA, pcB = (torch.as_tensor(r.uniform(-0.9, 0.9, (1, 5083, 3)).astype(np.float32),
                                device=cuda) for _ in range(2))
    counts = (threedmfv_kernel.launches, table_gather.launches, mfv_x.launches,
              table_gather_x.launches)
    with torch.no_grad():
        d = model(pcA, pcB)
    torch.cuda.synchronize()
    got = (threedmfv_kernel.launches - counts[0], table_gather.launches - counts[1],
           mfv_x.launches - counts[2], table_gather_x.launches - counts[3])
    assert got == (2, 2, 0, 0)
    assert d.shape == (1,) and bool(torch.isfinite(d).all())


def _decoder_layers(r, in_dim, widths, device):
    """Random decoder layers {"w": (in, out), "b": (out,)} at xavier scale."""
    layers, d = [], in_dim
    for w in widths:
        lim = np.sqrt(6.0 / (d + w))
        layers.append({"w": torch.as_tensor(r.uniform(-lim, lim, (d, w)).astype(np.float32),
                                            device=device),
                       "b": torch.as_tensor(r.normal(0, 0.1, w).astype(np.float32),
                                            device=device)})
        d = w
    return layers


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,widths", [
    (512, 64, 8, 5, (1024, 1024, 1024, 3)),   # the main path: 2B = 512 clouds, np = 64
    (4, 256, 8, 5, (1024, 1024, 1024, 3)),    # np = 256
    (2, 16, 4, 3, (32, 32, 32, 3)),           # the JAX kernel test's small config
    (3, 50, 8, 5, (48, 96, 1)),               # ragged N, other widths and depth
    (7, 100, 8, 5, (1024, 1024, 1024, 3)),    # 128-row tiles that span clouds at N = 100
    (5, 200, 8, 5, (1024, 1024, 1024, 3)),    # ... and at N = 200
    (9, 64, 8, 5, (1024, 1024, 1024, 3)),     # two clouds per tile, the last tile ragged
])
def test_fused_forward_kernel_matches_plain(cuda, B, N, g, k, widths):
    """Off-grid queries (vox 0, cell 0's row) included; no NaN or Inf."""
    r = np.random.default_rng(14)
    fv = torch.as_tensor(r.normal(0, 0.3, (B, g ** 3, 20)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=15)[1], device=cuda)
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    vox, _, delta = voxel_assign(q, g)
    packed = pack_decoder(_decoder_layers(r, 3 + k ** 3 * 20, widths, cuda))
    before = fused_forward.launches
    with torch.no_grad():
        y = fused_forward(fv, vox, delta, packed, g, k)
        torch.cuda.synchronize()
        assert fused_forward.launches == before + 1
        ref = fused_forward_plain(fv, vox, delta, packed, g, k)
    assert y.shape == ref.shape == (B, N, widths[-1]) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= TOL_FF


@pytest.mark.gpu
def test_fused_forward_kernel_vox_outside_the_grid(cuda):
    """A vox outside [0, V) (never made by voxel_assign) gathers a zero
    patch and keeps its delta: such rows equal the plain version's rows on
    an all-zero volume."""
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    B, N, g, k = 6, 100, 8, 5
    r = np.random.default_rng(22)
    fv = torch.as_tensor(r.normal(0, 0.3, (B, g ** 3, 20)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=23)[1], device=cuda)
    vox, _, delta = voxel_assign(q, g)
    bad = torch.as_tensor(r.random((B, N)) < 0.1, device=cuda)
    bad[:, 0] = True
    vox_bad = torch.where(bad, torch.where(torch.as_tensor(r.random((B, N)) < 0.5, device=cuda),
                                           -1 - vox, g ** 3 + vox), vox).to(torch.int32)
    packed = pack_decoder(_decoder_layers(r, 3 + k ** 3 * 20, (1024, 1024, 1024, 3), cuda))
    with torch.no_grad():
        y = fused_forward(fv, vox_bad, delta, packed, g, k)
        ref = fused_forward_plain(fv, vox, delta, packed, g, k)
        ref_zero = fused_forward_plain(torch.zeros_like(fv), vox, delta, packed, g, k)
    ref = torch.where(bad[..., None], ref_zero, ref)
    assert bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= TOL_FF


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [(256, 64, 8, 5, 20), (2, 16, 4, 3, 7), (3, 200, 8, 5, 20)])
def test_gather_fused_kernel_matches_plain(cuda, B, N, g, k, C):
    """Exact, with zero rows for off-grid queries; the backward (the
    adjoint kernel on the masked gradient) against autograd through the
    plain version."""
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    r = np.random.default_rng(16)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=17)[1], device=cuda)
    vox, mask, _ = voxel_assign(q, g)
    assert float(mask.min()) == 0.0
    before = gather_patches_fused.launches
    with torch.no_grad():
        out = gather_patches_fused(fv, vox, mask, g, k)
        torch.cuda.synchronize()
    assert gather_patches_fused.launches == before + 1
    assert torch.equal(out, gather_patches_fused_plain(fv, vox, mask, g, k))
    grad = torch.as_tensor(r.normal(size=out.shape).astype(np.float32), device=cuda)
    dfvs = []
    for fn in (gather_patches_fused, gather_patches_fused_plain):
        f = fv.clone().requires_grad_()
        dfvs.append(torch.autograd.grad(fn(f, vox, mask, g, k), f, grad)[0])
    assert float((dfvs[0] - dfvs[1]).abs().max()) <= REL_BWD * float(dfvs[1].abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind", ["all", "none", "some"])
@pytest.mark.parametrize("B,N,g,k,C", [
    (1, 1, 8, 5, 20),      # one row
    (3, 13, 8, 5, 20),     # runs that do not fill a 4-row group
    (1, 64, 8, 5, 20),
    (3, 200, 8, 5, 20),    # two runs a cloud
    (3, 13, 4, 3, 7),      # C = 7: one-element chunks, groups of 52 rows
    (2, 64, 4, 3, 20),     # g = 4, k = 3
])
def test_gather_fused_kernel_masks_and_vox_outside_the_grid(cuda, B, N, g, k, C, mask_kind):
    """Every query masked, none, or some, with some vox outside [0, G)
    (never made by voxel_assign): a zero row wherever the mask is 0 or the
    vox is outside, the plain gather elsewhere; two runs equal bit for bit;
    under no_grad no graph and one launch."""
    r = np.random.default_rng(21)
    G = g ** 3
    fv = torch.as_tensor(r.normal(size=(B, G, C)).astype(np.float32), device=cuda)
    vox_np = r.integers(0, G, (B, N)).astype(np.int32)
    mask_np = {"all": np.zeros((B, N)), "none": np.ones((B, N)),
               "some": (r.random((B, N)) < 0.7)}[mask_kind].astype(np.float32)
    if mask_kind == "some":
        vox_np.flat[::5] = r.choice([-1, G, G + 7], vox_np.flat[::5].shape)
    vox, mask = torch.as_tensor(vox_np, device=cuda), torch.as_tensor(mask_np, device=cuda)
    before = gather_patches_fused.launches
    with torch.no_grad():
        out = gather_patches_fused(fv, vox, mask, g, k)
        again = gather_patches_fused(fv, vox, mask, g, k)
    torch.cuda.synchronize()
    assert gather_patches_fused.launches == before + 2
    assert out.grad_fn is None
    inside = (vox >= 0) & (vox < G)
    want = gather_patches_fused_plain(fv, torch.where(inside, vox, torch.zeros_like(vox)),
                                      ((mask > 0) & inside).float(), g, k)
    assert torch.equal(out, want)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_bf16_outputs_are_the_float32_kernels_rounded(cuda):
    """Rows 1, 2 and 6 with a bfloat16 output: the float32 kernel's values
    rounded once (to nearest even), so equal to them rounded."""
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(64, 64, 64, 8, seed=18))
    r = np.random.default_rng(19)
    fv = torch.as_tensor(r.normal(size=(64, 512, 20)).astype(np.float32), device=cuda)
    bf = torch.bfloat16
    with torch.no_grad():
        pairs = [(mfv_x(pts, q, 512, 0.125, 8, 5, dtype=bf)[0], mfv_x(pts, q, 512, 0.125, 8, 5)[0]),
                 (table_gather_x(fv, q, 8, 5, dtype=bf)[0], table_gather_x(fv, q, 8, 5)[0])]
        vox = table_gather_x(fv, q, 8, 5)[1]
        pairs.append((table_gather(fv, vox, 8, 5, dtype=bf), table_gather(fv, vox, 8, 5)))
    for got, f32 in pairs:
        assert got.dtype == bf and torch.equal(got, f32.to(bf))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,np_,want", [
    ("full", 64, {"fused_forward": 1}),
    ("full", 256, {"fused_forward": 1, "threedmfv": 2}),
    ("auto", 64, {"mfv_x": 1}),
    ("auto", 256, {"threedmfv": 2, "table_gather": 2}),
])
def test_served_bf16_launch_counts(cuda, mode, np_, want):
    """bf16 serving from a committed net: the kernels each path launches
    per request, finite distances in [0, 2]; a bf16 input gradient refused
    under "full" (the reference refuses it) and computed under "auto"
    (the table path with row 3's bf16 adjoint)."""
    from dpdist_tpu_torch.serving import load_frozen_distance

    wrappers = {"fused_forward": fused_forward, "threedmfv": threedmfv_kernel, "mfv_x": mfv_x,
                "table_gather": table_gather, "table_gather_x": table_gather_x,
                "gather_patches_fused": gather_patches_fused}
    model = load_frozen_distance("results/ckpt_best", device=cuda, dtype="bfloat16",
                                 fused_gather=mode)
    r = np.random.default_rng(20)
    pcA, pcB = (torch.as_tensor(r.uniform(-0.9, 0.9, (8, np_, 3)).astype(np.float32),
                                device=cuda) for _ in range(2))
    before = {k: w.launches for k, w in wrappers.items()}
    with torch.no_grad():
        d = model(pcA, pcB)
    torch.cuda.synchronize()
    got = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert got == {k: want.get(k, 0) for k in wrappers}
    assert d.shape == (8,) and bool(torch.isfinite(d).all())
    assert float(d.min()) >= 0.0 and float(d.max()) <= 2.0
    a = pcA.clone().requires_grad_()
    if mode == "full":
        with pytest.raises(NotImplementedError, match="bf16 gradient"):
            model(a, pcB)
        return
    before = table_gather_bwd.launches_bf16
    (grad,) = torch.autograd.grad(model(a, pcB).sum(), a)
    torch.cuda.synchronize()
    assert table_gather_bwd.launches_bf16 == before + 1 and bool(torch.isfinite(grad).all())


# ---------------------------------------------------------------------------
# The kernels' limits as the route reads them (models.dpdist.route)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_limit_constants_equal_the_c_entries(cuda):
    """The Python limits the route reads without loading the library equal
    the C entries they mirror, over a sweep of grids, windows and widths."""
    from dpdist_tpu_torch.kernels import build, chamfer
    from dpdist_tpu_torch.kernels import fused_forward as ff
    from dpdist_tpu_torch.kernels import mfv_gather, table_gather, threedmfv

    lib = build.library()
    assert mfv_gather.MAX_GAUSSIANS == lib.dpdist_mfv_gather_x_max_gaussians()
    assert chamfer.TILE_N == lib.dpdist_nn_min_tile_points()
    assert chamfer.MAX_CHUNK == lib.dpdist_nn_min_max_chunk()
    for g in range(2, 13):
        G = g ** 3
        if G <= threedmfv.MAX_GAUSSIANS:
            for threads in {threedmfv._threads(G), 256, 512, 1024}:
                if threads >= G:
                    want = lib.dpdist_threedmfv_smem(G, threads)
                    assert threedmfv.encode_smem(G, threads) == want
        for k in (1, 3, 5):
            for C in (20, 7):
                assert table_gather.gather_smem(g, k, C) == lib.dpdist_table_gather_smem(g, k, C)
    for k in (1, 3, 5, 7):
        assert ff.fused_forward_smem(k) == lib.dpdist_fused_forward_smem(k)


@pytest.mark.gpu
def test_fused_forward_c_entry_refuses_what_the_limits_refuse(cuda):
    """The grid, depth and width limits of fused_forward_fits are the C
    entry's: one past each, the launch is refused (a RuntimeError from the
    wrapper); at the grid limit it runs."""
    import dataclasses

    from dpdist_tpu_torch.kernels.fused_forward import (
        MAX_GRID,
        MAX_HIDDEN,
        MAX_WIDTH,
        PackedDecoder,
    )
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    r = np.random.default_rng(30)
    k = 3
    packed = pack_decoder(_decoder_layers(r, 3 + k ** 3 * 20, (64, 64, 3), cuda))
    q = torch.as_tensor(r.uniform(-0.9, 0.9, (1, 8, 3)).astype(np.float32), device=cuda)

    def run(g, pk):
        vox, _, delta = voxel_assign(q, g)
        fv = torch.zeros((1, g ** 3, 20), dtype=torch.bfloat16, device=cuda)
        with torch.no_grad():
            y = fused_forward(fv, vox, delta, pk, g, k)
        torch.cuda.synchronize()
        return y

    assert bool(torch.isfinite(run(MAX_GRID, packed)).all())
    with pytest.raises(RuntimeError, match="launch failed"):
        run(MAX_GRID + 1, packed)
    deep = dataclasses.replace(packed, w=packed.w + (packed.w[1],) * MAX_HIDDEN,
                               b=packed.b + (packed.b[1],) * MAX_HIDDEN)
    with pytest.raises(RuntimeError, match="launch failed"):
        run(4, deep)
    wide = MAX_WIDTH + 64
    wide_pack = PackedDecoder(
        w=(torch.zeros((wide, packed.w[0].shape[1]), dtype=torch.bfloat16, device=cuda),),
        b=(torch.zeros(wide, device=cuda),), w_out=torch.zeros((3, wide), device=cuda),
        b_out=torch.zeros(3, device=cuda), in_dim=packed.in_dim)
    with pytest.raises(RuntimeError, match="launch failed"):
        run(4, wide_pack)


_SERVED_WRAPPERS = ("mfv_x", "threedmfv", "table_gather_x", "table_gather", "fused_forward",
                    "gather_patches_fused")


def _served_launches():
    return {"mfv_x": mfv_x.launches, "threedmfv": threedmfv_kernel.launches,
            "table_gather_x": table_gather_x.launches, "table_gather": table_gather.launches,
            "fused_forward": fused_forward.launches,
            "gather_patches_fused": gather_patches_fused.launches}


@pytest.mark.gpu
@pytest.mark.parametrize("net,over,want,tol", [
    ("results/ckpt_best", {}, {"table_gather_x": 2}, 1e-4),
    ("results/ckpt_best", {"dtype": "bfloat16"}, {"table_gather_x": 2}, 2e-3),
    ("results/ckpt_best", {"dtype": "bfloat16", "fused_gather": "full"}, {"fused_forward": 1},
     2e-3),
    ("results/dpdist_multi_r4_ckpt_best", {}, {"table_gather_x": 2}, 1e-4),
    (None, {"dtype": "bfloat16", "fused_gather": "full"}, {"table_gather_x": 2}, 2e-3),
])
def test_served_past_the_fused_kernels_limits(cuda, net, over, want, tol):
    """The committed decoder at embedding_size=1000 (past the mfv kernel's
    992 Gaussians) and a random bf16 "full" net with hidden widths 40 (not
    a multiple of 16) serve through the route's kernels, np = 64, and
    match the plain path (fused_gather="off")."""
    from dpdist_tpu_torch.configs import DPDistConfig
    from dpdist_tpu_torch.models import init_dpdist
    from dpdist_tpu_torch.serving import FrozenDistance, load_frozen_distance

    if net is None:
        cfg = DPDistConfig(mlp=(40, 40, 40))
        params, _ = init_dpdist(cfg, generator=torch.Generator().manual_seed(40), device=cuda)
        model = FrozenDistance(cfg.replace(**over), params).eval()
        plain = FrozenDistance(cfg.replace(**{**over, "fused_gather": "off"}), params).eval()
    else:
        over = {"embedding_size": 1000, **over}
        model = load_frozen_distance(net, device=cuda, **over)
        plain = load_frozen_distance(net, device=cuda, **{**over, "fused_gather": "off"})
    r = np.random.default_rng(1000)
    pcA, pcB = (torch.as_tensor(r.uniform(-0.9, 0.9, (16, 64, 3)).astype(np.float32),
                                device=cuda) for _ in range(2))
    before = _served_launches()
    with torch.no_grad():
        d = model(pcA, pcB)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _served_launches().items()}
        ref = plain(pcA, pcB)
    assert got == {k: want.get(k, 0) for k in _SERVED_WRAPPERS}
    assert d.shape == (16,) and bool(torch.isfinite(d).all())
    assert float((d - ref).abs().max()) <= tol


@pytest.mark.gpu
def test_gtgen_min_distances_on_cuda_match_the_native_library(cuda):
    """The ground-truth generator's distances on the card (row 8, then a
    square root) against the native host library, at the generator's size
    (50,000 candidates against a 10,000-point surface): within row 8's
    tolerance, taken through the square root."""
    from dpdist_tpu_torch.data import gtgen
    from dpdist_tpu_torch.data.synthetic import synthetic_surface
    from dpdist_tpu_torch.native import min_distances_native

    surface = (synthetic_surface("chair", seed=3, n_points=10000) * 0.8).astype(np.float32)
    cand = gtgen.uniform_sampling(np.random.default_rng(4), gtgen.CANDIDATES)
    before = nn_min_sqdist.launches
    got = gtgen.min_distances(cand, surface, device=cuda)
    assert nn_min_sqdist.launches == before + 1
    want = min_distances_native(cand, surface)
    assert want is not None and got.dtype == np.float32 and got.shape == want.shape
    # |d - d'| <= (TOL_NN_ABS + TOL_NN_REL d^2) / (d + d') on the squares.
    bound = (TOL_NN_ABS + TOL_NN_REL * want ** 2) / np.maximum(got + want, 1e-3) + 1e-7
    assert np.all(np.abs(got - want) <= bound)


# ---------------------------------------------------------------------------
# Registration: PCRNet training on the frozen DPDist loss, the evaluator
# ---------------------------------------------------------------------------

def _pcrnet_batch(B=4, N=64):
    from dpdist_tpu_torch.data.registration import RegistrationDataset

    ds = RegistrationDataset(num_point=N, n_templates=5, sparse=1, s_rand_points=1.0,
                             centroid_sub=False, seed=0,
                             families=("chair", "sphere", "box", "cylinder", "torus"))
    return ds.sample_batch(B, random_points_prob=1.0, noise_prob=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("train_single", [False, True], ids=["last", "bptt"])
def test_pcrnet_train_step_launches_rows_2_and_3(cuda, train_single):
    """One PCRNet step on the frozen DPDist loss (committed multi-family net)
    launches row 2 twice and row 3 once, in either mode: full BPTT puts the
    max_loops iterations through one loss call; the evaluator launches no
    kernel."""
    from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
    from dpdist_tpu_torch.data.registration import RegistrationDataset
    from dpdist_tpu_torch.eval.registration import evaluate_registration
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    wrappers = {"table_gather_x": table_gather_x, "table_gather_bwd": table_gather_bwd,
                "mfv_x": mfv_x, "threedmfv": threedmfv_kernel, "table_gather": table_gather}
    pcfg = PCRNetConfig(num_point=64, out_features=64, head_widths=(64, 32), max_loops=4)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = PCRNetTrainer(pcfg, TrainConfig(batch_size=4, grad_clip=1.0),
                                loss_type="dpdist",
                                dpdist=load_dpdist_checkpoint("results/dpdist_multi_r4_ckpt_best"),
                                train_single=train_single, run_dir=tmp,
                                logger=RunLogger(tmp, echo=False))
        assert trainer.device.type == "cuda"
        batch = _pcrnet_batch()
        before = {k: w.launches for k, w in wrappers.items()}
        m = trainer.train_step(*batch)
        torch.cuda.synchronize()
        got = {k: w.launches - before[k] for k, w in wrappers.items()}
        assert got == {"table_gather_x": 2, "table_gather_bwd": 1, "mfv_x": 0, "threedmfv": 0,
                       "table_gather": 0}
        assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))

        before = {k: w.launches for k, w in wrappers.items()}
        rep = evaluate_registration(trainer.params, pcfg, RegistrationDataset(num_point=64),
                                    num_cases=8, iterations=4, stop_threshold=1e-3,
                                    stop_period=2, stop_select="period0")
        torch.cuda.synchronize()
        assert {k: w.launches - before[k] for k, w in wrappers.items()} == dict.fromkeys(
            wrappers, 0)
        assert np.isfinite(rep["rot_err_mean_deg"])


@pytest.mark.gpu
def test_registration_entry_points_default_to_cuda(cuda):
    """Without a device argument the registration entry points run on the
    card: the policy's parameters, the trainer and the evaluator."""
    from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
    from dpdist_tpu_torch.models.pcrnet import init_pcrnet, pcrnet_refine
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    pcfg = PCRNetConfig(num_point=32, out_features=32, head_widths=(32, 16), max_loops=2)
    params = init_pcrnet(pcfg, torch.Generator().manual_seed(0))
    assert all(t.is_cuda for lp in params["encoder"] for t in lp.values())
    with tempfile.TemporaryDirectory() as tmp:
        trainer = PCRNetTrainer(pcfg, TrainConfig(batch_size=2), run_dir=tmp,
                                logger=RunLogger(tmp, echo=False))
        assert trainer.params["out"]["w"].is_cuda
        tmpl, src, _ = _pcrnet_batch(B=2, N=32)
        m = trainer.train_step(tmpl, src)
        assert m["loss"].is_cuda
    out, T, poses = pcrnet_refine(params, pcfg, torch.as_tensor(src, device=cuda),
                                  torch.as_tensor(tmpl, device=cuda), iterations=2)
    assert out.is_cuda and T.is_cuda and poses.shape == (2, 2, 7)


def _aue_data(B=16, N=64):
    from dpdist_tpu_torch.data.golden import aue_batch

    return aue_batch({"families": ["chair", "box", "sphere", "torus"], "seed0": 900, "scale": 0.8,
                      "batch_size": B, "num_point": N})


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["pn", "3dmfv"])
def test_aue_ours_step_launches_rows_2_and_3(cuda, encoder):
    """Each AUETrainer step on the frozen DPDist loss launches the
    table-gather kernel twice (both directions) and its adjoint once, at
    full width (the 3dmfv AUE: 512 Gaussians, 402.7 M decoder weights);
    a chamfer step launches none. The step's loss on the kernel path equals
    the plain path's (fused_gather="off") within 1e-5 relative, and its
    gradient in the reconstruction by the per-point criterion."""
    from dpdist_tpu_torch.configs import AUEConfig, TrainConfig
    from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
    from dpdist_tpu_torch.models.aue import apply_aue
    from dpdist_tpu_torch.train.aue_trainer import AUETrainer, split_same_surface
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax
    from dpdist_tpu_torch.train.logging import RunLogger

    dcfg, dparams, _ = load_dpdist_checkpoint("results/ckpt_best")
    data = _aue_data()
    wrappers = {"table_gather_x": table_gather_x, "table_gather_bwd": table_gather_bwd,
                "mfv_x": mfv_x, "threedmfv": threedmfv_kernel}
    with tempfile.TemporaryDirectory() as tmp:
        for opt_type, want in (("ours", (2, 1)), ("chamfer", (0, 0))):
            tr = AUETrainer(AUEConfig(encoder=encoder), TrainConfig(batch_size=16), dcfg,
                            dparams, opt_type=opt_type, run_dir=tmp, device=cuda,
                            logger=RunLogger(tmp, echo=False))
            for _ in range(2):
                before = {k: w.launches for k, w in wrappers.items()}
                m = tr.train_step(data)
                torch.cuda.synchronize()
                got = {k: w.launches - before[k] for k, w in wrappers.items()}
                assert got == {"table_gather_x": want[0], "table_gather_bwd": want[1],
                               "mfv_x": 0, "threedmfv": 0}
                assert bool(torch.isfinite(m["loss"])) and float(m["grad_norm"]) > 0
            if opt_type == "ours":
                x1, x2 = (torch.as_tensor(a, device=cuda) for a in split_same_surface(data))
                with torch.no_grad():
                    rec = apply_aue(tr.params, tr.state, tr.acfg, x1, train=True)[0]
                out = []
                for mode in ("auto", "off"):
                    loss_fn = make_frozen_dpdist_loss(params_from_jax(dparams, cuda),
                                                      dcfg.replace(fused_gather=mode))
                    r = rec.clone().requires_grad_(True)
                    loss = loss_fn(r, x2)
                    out.append((float(loss), torch.autograd.grad(loss, r)[0]))
                (lk, gk), (lp, gp) = out
                assert abs(lk - lp) <= 1e-5 * lp
                # Per point, relative to the largest entry: the encode's
                # signed sqrt magnifies the adjoint's summation order on a
                # few points (tests/test_torch_losses_optim.py).
                err = (gk - gp).abs().amax(-1).flatten() / float(gp.abs().max())
                assert float(err.max()) <= 5e-2 and float((err > 1e-3).float().mean()) <= 0.05
            del tr
            torch.cuda.empty_cache()


@pytest.mark.gpu
def test_aue_entry_points_default_to_cuda(cuda):
    """Without a device argument the AUE and the blocked EMD run on the card."""
    from dpdist_tpu_torch.configs import AUEConfig
    from dpdist_tpu_torch.models.aue import apply_aue, init_aue
    from dpdist_tpu_torch.ops import sinkhorn_emd_blocked

    params, state = init_aue(AUEConfig(encoder="pn", num_point=16))
    assert params["decoder"]["layers"][0]["w"].is_cuda and state["decoder"]["bn"][0]["var"].is_cuda
    x = torch.as_tensor(_aue_data(B=4, N=16)[:, :16], device=cuda)
    rec, _ = apply_aue(params, state, AUEConfig(encoder="pn", num_point=16), x)
    assert rec.is_cuda and rec.shape == (4, 16, 3)
    d = sinkhorn_emd_blocked(x, x.flip(1), tile=8)
    assert d.is_cuda and bool(torch.isfinite(d).all())


# ---------------------------------------------------------------------------
# The DPDist variants: the kernels at C = 7 and the variants' routes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("row", ["2", "3", "6", "9", "10"])
def test_kernels_at_c7_on_the_main_path_shapes(cuda, row):
    """Rows 2, 3, 6, 9 and 10 on 7-channel volumes (full_fv=False) at the
    main path's sizes (B = 256, N = 64; row 6 at N = 256; row 9 over the 2B
    stack), each against its plain version: copies exact, the adjoint equal
    to the ordered plain sum, row 9 within TOL_FF."""
    B, g, k, C = 256, 8, 5, 7
    r = np.random.default_rng(70 + int(row))
    fv = torch.as_tensor(r.normal(0, 0.3, (B, g ** 3, C)).astype(np.float32), device=cuda)
    N = 256 if row == "6" else 64
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=71)[1], device=cuda)
    vox, mask, delta = voxel_assign(q, g)
    with torch.no_grad():
        if row == "2":
            x, v = table_gather_x(fv, q, g, k)
            ref, ref_v = table_gather_x_plain(fv, q, g, k)
            assert torch.equal(x, ref) and torch.equal(v, ref_v)
        elif row == "3":
            gx = torch.as_tensor(r.normal(size=(B, N, 3 + k ** 3 * C)).astype(np.float32),
                                 device=cuda)[..., 3:]
            dfv = table_gather_bwd(vox, gx, g, k)
            assert torch.equal(dfv, table_gather_bwd_ordered(vox, gx, g, k))
            ref = table_gather_bwd_plain(vox, gx, g, k)
            assert float((dfv - ref).abs().max()) <= REL_BWD * float(ref.abs().max())
        elif row == "6":
            assert torch.equal(table_gather(fv, vox, g, k), table_gather_plain(fv, vox, g, k))
        elif row == "10":
            assert torch.equal(gather_patches_fused(fv, vox, mask, g, k),
                               gather_patches_fused_plain(fv, vox, mask, g, k))
        else:
            packed = pack_decoder(_decoder_layers(r, 3 + k ** 3 * C, (1024, 1024, 1024, 3), cuda))
            f16 = torch.cat([fv, fv.flip(0)]).to(torch.bfloat16)
            v2, d2 = torch.cat([vox, vox]), torch.cat([delta, delta])
            y = fused_forward(f16, v2, d2, packed, g, k)
            ref = fused_forward_plain(f16, v2, d2, packed, g, k)
            assert bool(torch.isfinite(y).all()) and float((y - ref).abs().max()) <= TOL_FF


_VARIANTS = {
    "bn": dict(use_bn=True),
    "conv3": dict(conv_version=3),
    "small_fv": dict(full_fv=False),
    "k0": dict(k=0),
    "pointnet": dict(encoder="pointnet", k=0, use_bn=True, pointnet_embedding=64),
    "dims2": dict(dims=2, output_channels=2),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_VARIANTS))
def test_variant_routes_match_the_plain_path(cuda, name):
    """Each variant at a small width on the card: the default forward
    ("auto"), and "table" where a gather kernel serves the config, against
    the plain path within 1e-5, each launching the kernels `route` names;
    a train step launches row 2 twice with BN (both directions), once
    without, and none where no gather kernel serves the config."""
    from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
    from dpdist_tpu_torch.models.dpdist import forward_dpdist, init_dpdist, route
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    cfg = DPDistConfig(**{**dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32)),
                          **_VARIANTS[name]})
    params, state = init_dpdist(cfg, torch.Generator().manual_seed(0), cuda)
    r = np.random.default_rng(3)
    for n in (16, 200):
        a, b = (torch.as_tensor(r.uniform(-0.95, 0.95, (4, n, cfg.dims)).astype(np.float32),
                                device=cuda) for _ in range(2))
        with torch.no_grad():
            want = forward_dpdist(params, state, cfg.replace(fused_gather="off"), a, b)
            for mode in ("auto", "table"):
                c = cfg.replace(fused_gather=mode)
                rt = route(c, "cuda", n, n)
                names = [x for x in rt.encode + rt.gather if x != "plain"]
                wrappers = {"mfv_gather_x": mfv_x, "table_gather_x": table_gather_x,
                            "table_gather": table_gather, "threedmfv": threedmfv_kernel}
                before = {x: wrappers[x].launches for x in set(names)}
                got = forward_dpdist(params, state, c, a, b)
                torch.cuda.synchronize()
                for x in set(names):
                    assert wrappers[x].launches - before[x] == (1 if x == "mfv_gather_x"
                                                                else names.count(x)), (mode, x)
                for gp, wp in zip(got[:2], want[:2]):
                    assert float((gp - wp).abs().max()) <= 1e-5
    data = np.random.default_rng(4).uniform(-0.9, 0.9, (2, 96, 3)).astype(np.float32)
    if cfg.dims == 2:
        data = np.ascontiguousarray(data[..., :2])
    labels = np.random.default_rng(5).uniform(0, 0.3, (2, 64)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        tr = DPDistTrainer(cfg, TrainConfig(batch_size=2, augment=False), run_dir=tmp,
                           device=cuda, logger=RunLogger(tmp, echo=False))
        before = table_gather_x.launches
        m = tr.train_step(data, labels)
        torch.cuda.synchronize()
        gathering = cfg.k > 0 and cfg.dims == 3
        assert table_gather_x.launches - before == (2 if cfg.use_bn else 1) * gathering
        assert bool(torch.isfinite(m["loss"]))


@pytest.mark.gpu
def test_dense_on_the_card_launches_rows_7_and_6(cuda):
    """dense_point_to_surface on a committed net: the cloud's encode by row
    7 and, without the pretransform, the rows by row 6; both paths against
    the plain composition within 1e-5."""
    from dpdist_tpu_torch.eval.dense import dense_point_to_surface
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax

    cfg, p, s = load_dpdist_checkpoint("results/ckpt_best")
    params, state = params_from_jax(p, cuda), params_from_jax(s, cuda)
    r = np.random.default_rng(6)
    cloud = torch.as_tensor(r.uniform(-0.8, 0.8, (2, 300, 3)).astype(np.float32), device=cuda)
    q = torch.as_tensor(r.uniform(-1.1, 1.1, (2, 3000, 3)).astype(np.float32), device=cuda)
    with torch.no_grad():
        want = dense_point_to_surface(params, cfg.replace(fused_gather="off"), cloud, q,
                                      state=state, pretransform="off")
        for pre, row6 in (("on", 0), ("off", 1)):
            before = (threedmfv_kernel.launches, table_gather.launches)
            got = dense_point_to_surface(params, cfg, cloud, q, state=state, pretransform=pre)
            torch.cuda.synchronize()
            assert threedmfv_kernel.launches - before[0] == 1
            assert table_gather.launches - before[1] == row6
            assert float((got - want).abs().max()) <= 1e-5
