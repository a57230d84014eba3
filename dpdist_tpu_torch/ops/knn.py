"""k-nearest neighbours (port of dpdist_tpu/ops/knn.py; the reference's
tf_util.pairwise_distance and knn): squared distances by the matmul
identity, then the k smallest per point.

Ties break by the lower index, as lax.top_k breaks them: the indices come
from a stable ascending sort (torch.topk does not promise an order among
equal values). Duplicated points give exact ties.
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.ops.chamfer import pairwise_sqdist


def pairwise_distance(points):
    """(B, N, D) -> (B, N, N) squared distances (self pairs included)."""
    return pairwise_sqdist(points, points)


def knn(points, k: int, *, exclude_self: bool = False):
    """Indices (B, N, k) of each point's k nearest neighbours, nearest
    first; exclude_self adds 1e10 to the diagonal first, as the reference."""
    d = pairwise_distance(points)
    if exclude_self:
        n = d.shape[-1]
        d = d + torch.eye(n, dtype=d.dtype, device=d.device)[None] * 1e10
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]
