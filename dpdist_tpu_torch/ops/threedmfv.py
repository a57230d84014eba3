"""3D modified Fisher Vector (3DmFV) encoder (port of
dpdist_tpu/ops/threedmfv.py).

`threedmfv(points, G, sigma, impl="auto")` dispatches as the reference
does (dpdist_tpu/ops/threedmfv.py:111-113): "auto" takes the streaming
encode kernel (kernels/threedmfv.py) for CUDA tensors of at least
KERNEL_MIN_POINTS points, and the plain encode otherwise; "kernel" and
"plain" force one or the other ("kernel" on a CPU tensor runs the plain
version, as every wrapper does).

`threedmfv_plain` is the plain PyTorch encode: the reference's impl="xla"
math but for how the squared distances are formed.

Gaussian responsibilities are a softmax over -||x - mu_g||^2 / (2 sigma^2)
for a uniform-weight isotropic GMM on a grid. The squared distance is
summed from per-dimension differences (x - mu_g) / sigma, as the TPU
kernels form it; the reference's XLA path uses the matmul identity
||x||^2 + ||mu||^2 - 2 x.mu_g^T instead, which loses accuracy to
cancellation (see threedmfv). No matmul is involved, so TF32 cannot
touch it.

Channel layout of the output (B, G, 20):
  [ d_pi_mean, d_pi_max,
    d_mu_mean(3), d_mu_max(3), d_mu_min(3),
    d_sig_mean(3), d_sig_max(3), d_sig_min(3) ]
"""

from __future__ import annotations

import numpy as np
import torch


def threedmfv_grid(n_gaussians: int) -> np.ndarray:
    """(G, 3) Gaussian centers on the uniform grid, in the reference's flat order.

    l = linspace(-1, 1, g, endpoint=False) + 1/g on np.meshgrid's default
    'xy' indexing: flat index v = iy*g^2 + ix*g + iz carries center
    (l[ix], l[iy], l[iz]).
    """
    g = int(np.ceil(n_gaussians ** (1.0 / 3.0)))
    l = np.linspace(-1, 1, g, False) + 1.0 / g
    x, y, z = np.meshgrid(l, l, l)
    return np.stack([x.flatten(), y.flatten(), z.flatten()], -1).astype(np.float32)


def _l2_normalize_over_gaussians(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each (b, :, c) vector over the Gaussian axis."""
    sq = torch.sum(x * x, dim=1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def _power_normalize(x: torch.Tensor, alpha: float = 0.5, eps: float = 1e-12) -> torch.Tensor:
    """sign(x) * max(|x|, eps)^alpha (sign(0) = 0)."""
    return torch.sign(x) * torch.pow(torch.clamp(torch.abs(x), min=eps), alpha)


# The reference's crossover (a v5e measurement) for impl="auto".
KERNEL_MIN_POINTS = 128


def threedmfv(points: torch.Tensor, n_gaussians: int = 512, sigma: float = 0.125,
              impl: str = "auto") -> torch.Tensor:
    """Normalized full 3DmFV of (B, N, 3) clouds, (B, G, 20) float32, by
    the kernel or the plain encode (see the module docstring)."""
    if impl == "auto":
        impl = ("kernel" if points.device.type == "cuda" and points.shape[1] >= KERNEL_MIN_POINTS
                else "plain")
    if impl == "plain":
        return threedmfv_plain(points, n_gaussians, sigma)
    if impl == "kernel":
        from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel

        return threedmfv_kernel(points.to(torch.float32).contiguous(), n_gaussians, sigma)
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def threedmfv_plain(points: torch.Tensor, n_gaussians: int = 512,
                    sigma: float = 0.125) -> torch.Tensor:
    """Normalized full 3DmFV (mean, max and min pools) of 3-D point clouds.

    Args:
      points: (B, N, 3) point clouds.
      n_gaussians: G, a perfect cube.
      sigma: isotropic Gaussian stddev.

    Returns:
      (B, G, 20) float32 Fisher vectors.
    """
    B, N, D = points.shape
    if D != 3:
        raise NotImplementedError(f"only 3-D clouds are ported, got D={D}")
    mu = torch.as_tensor(threedmfv_grid(n_gaussians), device=points.device)
    G = mu.shape[0]
    w = 1.0 / G

    pts = points.to(torch.float32)
    diff = (pts[:, :, None, :] - mu[None, None, :, :]) / sigma   # (B, N, G, D)
    # Responsibilities: softmax over Gaussians of -||diff||^2 / 2, with the
    # squared distance summed from per-dimension differences (the form of
    # the TPU kernels) rather than the reference's matmul identity, whose
    # cancellation costs up to ~2e-5 after normalization in the mean
    # channels (tests/test_torch_ops.py::test_threedmfv_accuracy_vs_float64).
    Q = torch.softmax(-0.5 * torch.sum(diff * diff, dim=-1), dim=-1)  # (B, N, G)
    Qd = Q[..., None]

    d_pi_all = (Q - w) / (np.sqrt(w) * N)                        # (B, N, G)
    d_mu_all = Qd * diff                                         # (B, N, G, D)
    d_sig_all = Qd * (diff * diff - 1.0)                         # (B, N, G, D)

    # Pool over the point axis: mean, max and min (amax/amin, as JAX).
    d_pi = torch.stack([torch.mean(d_pi_all, dim=1), torch.amax(d_pi_all, dim=1)], dim=2)
    d_mu = torch.cat([torch.mean(d_mu_all, dim=1), torch.amax(d_mu_all, dim=1),
                      torch.amin(d_mu_all, dim=1)], dim=2) / np.sqrt(w)
    d_sig = torch.cat([torch.mean(d_sig_all, dim=1), torch.amax(d_sig_all, dim=1),
                       torch.amin(d_sig_all, dim=1)], dim=2) / np.sqrt(2.0 * w)

    d_pi = _l2_normalize_over_gaussians(_power_normalize(d_pi))
    d_mu = _l2_normalize_over_gaussians(_power_normalize(d_mu))
    d_sig = _l2_normalize_over_gaussians(_power_normalize(d_sig))
    return torch.cat([d_pi, d_mu, d_sig], dim=2)
