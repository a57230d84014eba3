"""3D modified Fisher Vector (3DmFV) encoder (port of
dpdist_tpu/ops/threedmfv.py).

`threedmfv(points, G, sigma, impl="auto")` dispatches as the reference
does (dpdist_tpu/ops/threedmfv.py:103-113): "auto" takes the streaming
encode kernel (kernels/threedmfv.py) for CUDA tensors of at least
KERNEL_MIN_POINTS points when the kernel computes the asked encode (3-D,
full_fv, normalized), and the plain encode otherwise; "kernel" and
"plain" force one or the other ("kernel" on a CPU tensor runs the plain
version, as every wrapper does; "kernel" for an encode the kernel does not
compute raises, as the reference's impl="pallas").

`threedmfv_plain` is the plain PyTorch encode: the reference's impl="xla"
math but for how the squared distances are formed.

Gaussian responsibilities are a softmax over -||x - mu_g||^2 / (2 sigma^2)
for a uniform-weight isotropic GMM on a grid (2-D or 3-D). The squared
distance is summed from per-dimension differences (x - mu_g) / sigma, as
the TPU kernels form it; the reference's XLA path uses the matmul identity
||x||^2 + ||mu||^2 - 2 x.mu_g^T instead, which loses accuracy to
cancellation (see threedmfv). No matmul is involved, so TF32 cannot
touch it.

Channel layout of the output (B, G, C), full_fv (C = 2 + 6 D, 20 in 3-D):
  [ d_pi_mean, d_pi_max,
    d_mu_mean(D), d_mu_max(D), d_mu_min(D),
    d_sig_mean(D), d_sig_max(D), d_sig_min(D) ]
and with full_fv=False the mean pools only (C = 1 + 2 D: 7 in 3-D, 5 in
2-D): [ d_pi_mean, d_mu_mean(D), d_sig_mean(D) ]. flatten=True gives the
reference's channel-major (B, C*G): each group's channels transposed to
(C, G) and flattened, the groups in the order above
(dpdist_tpu/ops/threedmfv.py:121-122, :178-184).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def threedmfv_centers(n_gaussians: int, dims: int = 3, device=None) -> torch.Tensor:
    """(G, D) float32 Gaussian centers on the uniform grid, in the reference's
    flat order, built by torch ops (so they trace inside a while_loop).

    l = linspace(-1, 1, g, endpoint=False) + 1/g on np.meshgrid's default
    'xy' indexing: in 3-D flat index v = iy*g^2 + ix*g + iz carries center
    (l[ix], l[iy], l[iz]); in 2-D v = iy*g + ix carries (l[ix], l[iy]).
    l is formed in float64 as np.linspace forms it (i * (2 / g) - 1, then
    + 1/g) and rounded to float32 once, so the centers equal the numpy
    construction's bit for bit.
    """
    g = math.isqrt(n_gaussians) if dims == 2 else math.ceil(n_gaussians ** (1.0 / 3.0))
    l = torch.arange(g, dtype=torch.float64, device=device) * (2.0 / g) + (-1.0) + 1.0 / g
    axes = torch.meshgrid(*([l] * dims), indexing="xy")
    return torch.stack([a.flatten() for a in axes], -1).to(torch.float32)


def threedmfv_grid(n_gaussians: int, dims: int = 3) -> np.ndarray:
    """threedmfv_centers as a numpy array."""
    return threedmfv_centers(n_gaussians, dims).numpy()


def _l2_normalize_over_gaussians(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize each (b, :, c) vector over the Gaussian axis."""
    sq = torch.sum(x * x, dim=1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def _power_normalize(x: torch.Tensor, alpha: float = 0.5, eps: float = 1e-12) -> torch.Tensor:
    """sign(x) * max(|x|, eps)^alpha (sign(0) = 0)."""
    return torch.sign(x) * torch.pow(torch.clamp(torch.abs(x), min=eps), alpha)


# The reference's crossover (a v5e measurement) for impl="auto".
KERNEL_MIN_POINTS = 128


def kernel_computes(dims: int, full_fv: bool = True, normalize: bool = True) -> bool:
    """Whether the streaming kernel computes this encode: the reference's
    kernel_ok, D == 3, full_fv and normalize."""
    return dims == 3 and full_fv and normalize


def _flatten(groups):
    """Channel-major flatten: each (B, G, c) group to (B, c*G), concatenated."""
    return torch.cat([g.transpose(1, 2).reshape(g.shape[0], -1) for g in groups], dim=1)


def threedmfv(points: torch.Tensor, n_gaussians: int = 512, sigma: float = 0.125,
              impl: str = "auto", *, flatten: bool = False, normalize: bool = True,
              full_fv: bool = True) -> torch.Tensor:
    """The 3DmFV of (B, N, D) clouds, (B, G, C) float32 (or (B, C*G) with
    flatten), by the kernel or the plain encode (see the module docstring)."""
    from dpdist_tpu_torch.kernels.ops import dispatch, route_device

    ok = kernel_computes(points.shape[-1], full_fv, normalize)
    if impl == "auto":
        impl = ("kernel" if ok and route_device(points) == "cuda"
                and points.shape[1] >= KERNEL_MIN_POINTS else "plain")
    if impl == "plain":
        return threedmfv_plain(points, n_gaussians, sigma, flatten=flatten, normalize=normalize,
                               full_fv=full_fv)
    if impl == "kernel":
        if not ok:
            raise ValueError("impl='kernel' computes the 3-D full_fv normalized encode only (got "
                             f"D={points.shape[-1]}, full_fv={full_fv}, normalize={normalize})")
        from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel

        fv = dispatch(threedmfv_kernel)(points.to(torch.float32).contiguous(), n_gaussians,
                                        sigma)
        return _flatten([fv]) if flatten else fv
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def threedmfv_plain(points: torch.Tensor, n_gaussians: int = 512, sigma: float = 0.125, *,
                    flatten: bool = False, normalize: bool = True,
                    full_fv: bool = True) -> torch.Tensor:
    """The 3DmFV of (B, N, D) clouds, D in {2, 3}, in plain PyTorch.

    Args:
      points: (B, N, D) point clouds.
      n_gaussians: G, a perfect square (2-D) or cube (3-D).
      sigma: isotropic Gaussian stddev.
      flatten: (B, C*G) channel-major instead of (B, G, C).
      normalize: the power and l2 normalizations.
      full_fv: mean, max and min pools (C = 2 + 6 D), else the means only
        (C = 1 + 2 D).

    Returns:
      (B, G, C) or (B, C*G) float32 Fisher vectors.
    """
    B, N, D = points.shape
    if D not in (2, 3):
        raise ValueError(f"clouds must be 2-D or 3-D, got D={D}")
    mu = threedmfv_centers(n_gaussians, D, points.device)
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

    d_pi_all = (Q - w) / (math.sqrt(w) * N)                      # (B, N, G)
    d_mu_all = Qd * diff                                         # (B, N, G, D)
    d_sig_all = Qd * (diff * diff - 1.0)                         # (B, N, G, D)

    # Pool over the point axis: mean, and with full_fv max and min
    # (amax/amin, as JAX).
    if full_fv:
        d_pi = torch.stack([torch.mean(d_pi_all, dim=1), torch.amax(d_pi_all, dim=1)], dim=2)
        d_mu = torch.cat([torch.mean(d_mu_all, dim=1), torch.amax(d_mu_all, dim=1),
                          torch.amin(d_mu_all, dim=1)], dim=2)
        d_sig = torch.cat([torch.mean(d_sig_all, dim=1), torch.amax(d_sig_all, dim=1),
                           torch.amin(d_sig_all, dim=1)], dim=2)
    else:
        d_pi = torch.mean(d_pi_all, dim=1)[..., None]
        d_mu = torch.mean(d_mu_all, dim=1)
        d_sig = torch.mean(d_sig_all, dim=1)
    d_mu = d_mu / math.sqrt(w)
    d_sig = d_sig / math.sqrt(2.0 * w)

    if normalize:
        d_pi = _l2_normalize_over_gaussians(_power_normalize(d_pi))
        d_mu = _l2_normalize_over_gaussians(_power_normalize(d_mu))
        d_sig = _l2_normalize_over_gaussians(_power_normalize(d_sig))
    if flatten:
        return _flatten([d_pi, d_mu, d_sig])
    return torch.cat([d_pi, d_mu, d_sig], dim=2)
