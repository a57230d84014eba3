"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist, nn_min_sqdist_plain
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_bwd_plain,
    table_gather_plain,
    table_gather_x,
    table_gather_x_plain,
)
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
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
# NN-min kernel vs plain: nvcc contracts the per-dimension sum to FMA, so
# the last bits may differ; within TOL_NN_ABS + TOL_NN_REL * |d|.
TOL_NN_ABS, TOL_NN_REL = 1e-6, 1e-5


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
@pytest.mark.parametrize("B,M,N,G,g,k,sigma", [
    (512, 64, 64, 512, 8, 5, 0.125),   # the main path: 2B = 512 clouds
    (2, 12, 16, 64, 4, 3, 0.25),       # the JAX kernel test's config
    (3, 61, 200, 512, 8, 5, 0.125),    # ragged M, N above one TPU query tile
])
def test_mfv_x_kernel_matches_plain(cuda, B, M, N, G, g, k, sigma):
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(B, M, N, g))
    before = mfv_x.launches
    x, vox = mfv_x(pts, q, G, sigma, g, k)
    torch.cuda.synchronize()
    assert mfv_x.launches == before + 1
    ref, ref_vox = mfv_x_plain(pts, q, G, sigma, g, k)
    assert x.shape == ref.shape and vox.dtype == torch.int32
    assert torch.equal(vox, ref_vox)
    assert float((x - ref).abs().max()) <= TOL_X


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [
    (256, 64, 8, 5, 20),   # the main path
    (2, 16, 4, 3, 20),     # the JAX kernel test's small config
    (3, 200, 8, 5, 20),    # N not a multiple of the block's 32 rows
])
def test_table_gather_x_kernel_matches_plain(cuda, B, N, g, k, C):
    r = np.random.default_rng(1)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=2)[1], device=cuda)
    before = table_gather_x.launches
    x, vox = table_gather_x(fv, q, g, k)
    torch.cuda.synchronize()
    assert table_gather_x.launches == before + 1
    ref, ref_vox = table_gather_x_plain(fv, q, g, k)
    assert torch.equal(vox, ref_vox)
    assert torch.equal(x, ref)      # a copy plus q - centre: exact


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k", [(256, 64, 8, 5), (2, 16, 4, 3), (3, 200, 8, 5)])
def test_table_gather_bwd_kernel_matches_plain(cuda, B, N, g, k):
    """Gradient on every row, off-grid ones included (they scatter into
    cell 0's neighbourhood); the grad is the strided patch part of x's
    gradient; two runs agree bit for bit (no atomics)."""
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=3)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, 20, device=cuda), q, g, k)
    r = np.random.default_rng(4)
    gx = torch.as_tensor(r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32), device=cuda)
    grad = gx[..., 3:]
    before = table_gather_bwd.launches
    dfv = table_gather_bwd(vox, grad, g, k)
    dfv2 = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    assert table_gather_bwd.launches == before + 2
    assert torch.equal(dfv, dfv2)
    ref = table_gather_bwd_plain(vox, grad, g, k)
    assert float((dfv - ref).abs().max()) <= REL_BWD * float(ref.abs().max())


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
    params = init_dpdist(cfg, torch.Generator().manual_seed(0), cuda)
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
@pytest.mark.parametrize("B,N,g,k,C", [(256, 256, 8, 5, 20), (2, 16, 4, 3, 7), (3, 200, 8, 5, 20)])
def test_table_gather_kernel_matches_plain(cuda, B, N, g, k, C):
    """Exact, off-grid queries (vox 0) included."""
    r = np.random.default_rng(11)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=12)[1], device=cuda)
    vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)[1]
    before = table_gather.launches
    out = table_gather(fv, vox, g, k)
    torch.cuda.synchronize()
    assert table_gather.launches == before + 1
    assert torch.equal(out, table_gather_plain(fv, vox, g, k))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(1, 10000, 10000), (2, 1000, 4099), (3, 37, 5), (256, 64, 64)])
def test_nn_min_sqdist_kernel_matches_plain(cuda, B, N, M):
    r = np.random.default_rng(N + M)
    a, p = (torch.as_tensor(r.uniform(-1, 1, (B, n, 3)).astype(np.float32), device=cuda)
            for n in (N, M))
    before = nn_min_sqdist.launches
    d = nn_min_sqdist(a, p)
    torch.cuda.synchronize()
    assert nn_min_sqdist.launches == before + 1
    ref = nn_min_sqdist_plain(a, p)
    assert bool(((d - ref).abs() <= TOL_NN_ABS + TOL_NN_REL * ref.abs()).all())


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
