"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain

# Kernel vs plain version: both form squared distances per dimension and
# differ only in summation order and in the device's exp.
TOL_X = 2e-5


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
