"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather_bwd,
    table_gather_bwd_plain,
    table_gather_x,
    table_gather_x_plain,
)

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
