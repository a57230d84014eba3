"""Approximate Earth Mover's Distance, entropic (Sinkhorn) formulation, plain
PyTorch (port of sinkhorn_emd and earth_mover_distance from
dpdist_tpu/ops/emd.py).

Log-domain Sinkhorn with uniform marginals over a fixed number of
iterations, on the reference's temperature schedule: eps anneals
geometrically from eps_start to eps_end over the first 2/3 of the
iterations and then holds at eps_end. Gradients hold the transport plan
fixed (the envelope theorem), as the reference's custom VJP does:
d cost / d x_n = sum_m P[n, m] (x_n - y_m) / ||x_n - y_m||.

The (B, N, M) cost matrix is formed by the matmul identity in float32 with
TF32 off. sinkhorn_emd_blocked (O(N * tile) memory) is not ported yet.
"""

from __future__ import annotations

import math

import torch


def _eps_schedule(iters: int, eps_start: float, eps_end: float):
    n_anneal = max(iters * 2 // 3, 1)
    t = torch.linspace(0.0, 1.0, n_anneal)
    anneal = eps_start * (eps_end / eps_start) ** t
    hold = torch.full((iters - n_anneal,), eps_end)
    return torch.cat([anneal, hold]).tolist()


def _sinkhorn_plan(cost, eps_schedule):
    """(B, N, M) cost -> transport plan with rows summing to about 1/N and
    columns to about 1/M."""
    B, N, M = cost.shape
    log_a = torch.full((B, N), -math.log(N), dtype=cost.dtype, device=cost.device)
    log_b = torch.full((B, M), -math.log(M), dtype=cost.dtype, device=cost.device)
    f = torch.zeros((B, N), dtype=cost.dtype, device=cost.device)
    g = torch.zeros((B, M), dtype=cost.dtype, device=cost.device)
    for eps in eps_schedule:
        f = eps * (log_a - torch.logsumexp((g[:, None, :] - cost) / eps, dim=2))
        g = eps * (log_b - torch.logsumexp((f[:, :, None] - cost) / eps, dim=1))
    return torch.exp((f[:, :, None] + g[:, None, :] - cost) / eps_schedule[-1])


def _emd_forward(x, y, iters, eps_start, eps_end):
    d2 = (torch.sum(x * x, -1)[:, :, None] + torch.sum(y * y, -1)[:, None, :]
          - 2.0 * torch.matmul(x, y.transpose(1, 2)))
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    P = _sinkhorn_plan(d, _eps_schedule(iters, eps_start, eps_end))
    # Unit plan mass per cloud, so Sinkhorn's truncation leaves the scale.
    P = P / torch.clamp(torch.sum(P, dim=(1, 2), keepdim=True), min=1e-12)
    return torch.sum(P * d, dim=(1, 2)), P


class _SinkhornEMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, iters, eps_start, eps_end):
        cost, P = _emd_forward(x, y, iters, eps_start, eps_end)
        ctx.save_for_backward(x, y, P)
        return cost

    @staticmethod
    def backward(ctx, g):
        x, y, P = ctx.saved_tensors
        diff = x[:, :, None, :] - y[:, None, :, :]
        dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-12))
        Pu = P[..., None] * (diff / dist[..., None])
        gx = g[:, None, None] * torch.sum(Pu, dim=2)
        gy = -g[:, None, None] * torch.sum(Pu, dim=1)
        return gx, gy, None, None, None


def sinkhorn_emd(x, y, iters: int = 50, eps_start: float = 0.5, eps_end: float = 0.002):
    """(B, N, D), (B, M, D) -> (B,) approximate EMD: the total euclidean
    cost of a unit-mass transport plan (the reference's CUDA match_cost
    divided by the number of points). Differentiable in x and y with the
    plan held fixed."""
    return _SinkhornEMD.apply(x, y, iters, eps_start, eps_end)


def earth_mover_distance(pc1, pc2, *, iters: int = 50):
    """Scalar EMD loss: the batch mean of sinkhorn_emd, for clouds of equal
    size (tf_util_loss.earth_mover's scale)."""
    if pc1.shape[1] != pc2.shape[1]:
        raise ValueError(f"clouds of unequal size: {pc1.shape[1]} and {pc2.shape[1]} points")
    return torch.mean(sinkhorn_emd(pc1, pc2, iters))
