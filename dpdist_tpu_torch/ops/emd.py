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
TF32 off. sinkhorn_emd_blocked runs the same iterations in O(N * tile)
memory for clouds too large for the dense plan: the distances are
recomputed tile by tile each iteration and reduced with an online
logsumexp; it has no gradient.
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


def _sqrt_dist(x, y):
    """(B, N, M) euclidean distances by the matmul identity, floored at 1e-6."""
    d2 = (torch.sum(x * x, -1)[..., :, None] + torch.sum(y * y, -1)[..., None, :]
          - 2.0 * torch.matmul(x, y.transpose(-1, -2)))
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _blocked_lse(x_pts, y_pts, pot_y, eps: float, tile: int):
    """For every x point, logsumexp over y of (pot_y - ||x - y||) / eps,
    streamed over y tiles with an online logsumexp (never the N x M matrix)."""
    B, N, _ = x_pts.shape
    m_run = torch.full((B, N), float("-inf"), dtype=x_pts.dtype, device=x_pts.device)
    s_run = torch.zeros((B, N), dtype=x_pts.dtype, device=x_pts.device)
    for t in range(0, y_pts.shape[1], tile):
        z = (pot_y[:, None, t:t + tile] - _sqrt_dist(x_pts, y_pts[:, t:t + tile])) / eps
        m_new = torch.maximum(m_run, torch.amax(z, -1))
        s_run = s_run * torch.exp(m_run - m_new) + torch.sum(torch.exp(z - m_new[..., None]), -1)
        m_run = m_new
    return m_run + torch.log(s_run)


def _pad_to_tile(pts, tile: int):
    """Pad the point axis to a tile multiple with sentinels at 1e4, far from
    everything; their log-masses are set to -1e30 by the caller."""
    B, N, D = pts.shape
    Np = -(-N // tile) * tile
    if Np == N:
        return pts
    return torch.cat([pts, pts.new_full((B, Np - N, D), 1e4)], 1)


@torch.no_grad()
def sinkhorn_emd_blocked(x, y, *, iters: int = 30, eps_start: float = 0.5,
                         eps_end: float = 0.01, tile: int = 1024):
    """(B, N, 3), (B, M, 3) -> (B,) approximate EMD on sinkhorn_emd's scale,
    in O(B * N * tile) memory, for clouds too large for the dense plan (the
    reference's sinkhorn_emd_blocked, dpdist_tpu/ops/emd.py:116-215). Both
    clouds are padded to a tile multiple with sentinel points whose
    log-masses are -1e30, so they carry no mass. The cost is the plan's
    sum(P * d) over its mass, streamed over the tiles as the iterations
    are. No gradient (an evaluation metric)."""
    B, N0, _ = x.shape
    M0 = y.shape[1]
    x = _pad_to_tile(x.to(torch.float32), tile)
    y = _pad_to_tile(y.to(torch.float32), tile)
    N, M = x.shape[1], y.shape[1]
    dev = x.device

    def log_mass(n, n0):
        lm = torch.full((B, n), -math.log(n0), dtype=torch.float32, device=dev)
        lm[:, n0:] = -1e30
        return lm

    log_a, log_b = log_mass(N, N0), log_mass(M, M0)
    schedule = _eps_schedule(iters, eps_start, eps_end)
    f = torch.zeros((B, N), dtype=torch.float32, device=dev)
    g = torch.zeros((B, M), dtype=torch.float32, device=dev)
    for eps in schedule:
        f = eps * (log_a - _blocked_lse(x, y, g, eps, tile))
        g = eps * (log_b - _blocked_lse(y, x, f, eps, tile))
    eps_last = schedule[-1]
    num = torch.zeros(B, dtype=torch.float32, device=dev)
    den = torch.zeros(B, dtype=torch.float32, device=dev)
    for t in range(0, M, tile):
        d = _sqrt_dist(x, y[:, t:t + tile])
        P = torch.exp(torch.clamp((f[..., None] + g[:, None, t:t + tile] - d) / eps_last,
                                  max=30.0))
        num = num + torch.sum(P * d, (1, 2))
        den = den + torch.sum(P, (1, 2))
    return num / torch.clamp(den, min=1e-12)


def earth_mover_distance(pc1, pc2, *, iters: int = 50):
    """Scalar EMD loss: the batch mean of sinkhorn_emd, for clouds of equal
    size (tf_util_loss.earth_mover's scale)."""
    if pc1.shape[1] != pc2.shape[1]:
        raise ValueError(f"clouds of unequal size: {pc1.shape[1]} and {pc2.shape[1]} points")
    return torch.mean(sinkhorn_emd(pc1, pc2, iters))
