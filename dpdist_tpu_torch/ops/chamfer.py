"""Chamfer / nearest-neighbour distance (port of dpdist_tpu/ops/chamfer.py).

The plain path forms the (B, N, M) squared distances by the matmul
identity, clamped at 0 against its negative round-off, as the reference
does; the matmul runs in float32 with TF32 off (importing the package
turns it off), the counterpart of the reference's Precision.HIGHEST.
chamfer_distance(impl="auto") streams through the NN-min kernel
(kernels/chamfer.py) instead for CUDA tensors once the matrix would hold
KERNEL_MIN_PAIRS entries (dpdist_tpu/ops/chamfer.py:55).
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.kernels.chamfer import chamfer_distance_kernel

KERNEL_MIN_PAIRS = 64 * 10 ** 6


def pairwise_sqdist(x, y):
    """(B, N, D), (B, M, D) -> (B, N, M) squared euclidean distances."""
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp(x2 + y2 - 2.0 * xy, min=0.0)


def nn_distance(pc1, pc2):
    """Bidirectional squared NN distances and indices, the interface of the
    reference's CUDA op: (dist1, idx1, dist2, idx2), where
    dist1[b, n] = min_m ||pc1[b, n] - pc2[b, m]||^2; indices are int32 and
    name the first minimum."""
    d = pairwise_sqdist(pc1, pc2)
    dist1, idx1 = torch.min(d, dim=2)
    dist2, idx2 = torch.min(d, dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)


def chamfer_distance(pc1, pc2, *, sqrt: bool = True, impl: str = "auto"):
    """Scalar chamfer distance over a batch: the mean of the two
    directions' mean NN distances (euclidean with sqrt=True, as
    sqrt(max(d, 1e-12)); squared otherwise).

    impl: "auto" (the kernel for CUDA tensors when N * M >=
    KERNEL_MIN_PAIRS, else the plain path) or "plain". The kernel has no
    backward.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    from dpdist_tpu_torch.kernels.ops import dispatch, route_device

    N, M = pc1.shape[1], pc2.shape[1]
    if impl == "auto" and route_device(pc1) == "cuda" and N * M >= KERNEL_MIN_PAIRS:
        return dispatch(chamfer_distance_kernel)(pc1.to(torch.float32).contiguous(),
                                                 pc2.to(torch.float32).contiguous(), sqrt=sqrt)
    d = pairwise_sqdist(pc1, pc2)
    d1 = torch.amin(d, dim=2)
    d2 = torch.amin(d, dim=1)
    if sqrt:
        d1 = torch.sqrt(torch.clamp(d1, min=1e-12))
        d2 = torch.sqrt(torch.clamp(d2, min=1e-12))
    return (torch.mean(d1) + torch.mean(d2)) / 2.0
