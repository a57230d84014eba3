"""Streaming 3DmFV encode: (B, N, 3) points -> (B, G, 20) normalised full
Fisher vectors, for any N.

Port of dpdist_tpu/kernels/threedmfv_pallas.py (`threedmfv_pallas`, TPU
kernel `_kernel` with its XLA finalisation, and its VJP). The CUDA kernel
is dpdist_tpu_torch/csrc/threedmfv.cu, over the encode of
csrc/fv_encode.cuh; its header says what bounds it on an H100.

`threedmfv_kernel` is the wrapper. On a CPU tensor it runs the plain
encode (ops.threedmfv.threedmfv_plain), which is also the kernel's oracle
on the card. On a CUDA tensor it launches the kernel or raises; it never
falls back. `threedmfv_kernel.launches` counts kernel launches, and
nothing else.

The kernel has no backward of its own, as on the TPU: the max and min
pools must split their gradient evenly over ties (points far outside the
grid underflow Q to 0 and tie at the floor), which autograd's amax/amin
do. So the backward replays the plain encode under autograd and takes its
VJP (dpdist_tpu/kernels/threedmfv_pallas.py:147-157), only where the
points need a gradient; `threedmfv_kernel.replays` counts those replays.
"""

from __future__ import annotations

import functools
import math

import torch

from dpdist_tpu_torch.ops.threedmfv import threedmfv_grid, threedmfv_plain


@functools.lru_cache(maxsize=8)
def _mu(G: int, device: torch.device):
    return torch.as_tensor(threedmfv_grid(G), device=device).contiguous()


def _threads(G: int) -> int:
    return min(1024, max(256, -(-G // 32) * 32))


def _check(points, n_gaussians):
    if not isinstance(points, torch.Tensor):
        raise TypeError(f"points must be a torch.Tensor, got {type(points).__name__}")
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32, got {points.dtype}")
    if points.dim() != 3 or points.shape[-1] != 3 or points.shape[1] < 1:
        raise ValueError(f"points must be (B, N, 3) with N >= 1, got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("points must be contiguous")
    g = round(n_gaussians ** (1.0 / 3.0))
    if g ** 3 != n_gaussians or n_gaussians > 1024:
        raise ValueError(f"n_gaussians must be a cube of at most 1024, got {n_gaussians}")
    if points.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the encode runs on cpu or cuda tensors, got {points.device}")


def _threedmfv_impl(points, n_gaussians, sigma):
    dev = points.device
    if dev.type == "cpu":
        return threedmfv_plain(points, n_gaussians, sigma)

    from dpdist_tpu_torch.kernels import build

    lib = build.library()
    B, N, _ = points.shape
    G = n_gaussians
    threads = _threads(G)
    smem = lib.dpdist_threedmfv_smem(G, threads)
    if smem > build.MAX_SMEM:
        raise ValueError(f"G={G} needs {smem} B of shared memory, more than the "
                         f"{build.MAX_SMEM} B a block has")
    out = torch.empty((B, G, 20), dtype=torch.float32, device=dev)
    w = 1.0 / G
    err = lib.dpdist_threedmfv(
        points.data_ptr(), _mu(G, dev).data_ptr(), out.data_ptr(), B, N, G, float(sigma), w,
        math.sqrt(w) * N, math.sqrt(w), math.sqrt(2.0 * w), 1.0 / N, threads, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "threedmfv")
    threedmfv_kernel.launches += 1
    return out


class _ThreeDmFV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, n_gaussians, sigma):
        ctx.save_for_backward(points)
        ctx.args = (n_gaussians, sigma)
        return _threedmfv_impl(points, n_gaussians, sigma)

    @staticmethod
    def backward(ctx, grad_fv):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (points,) = ctx.saved_tensors
        threedmfv_kernel.replays += 1
        with torch.enable_grad():
            p = points.detach().requires_grad_(True)
            fv = threedmfv_plain(p, *ctx.args)
            (dpoints,) = torch.autograd.grad(fv, p, grad_fv)
        return dpoints, None, None


def threedmfv_kernel(points, n_gaussians: int = 512, sigma: float = 0.125):
    """(B, N, 3) float32 contiguous points -> (B, G, 20) float32 normalised
    full 3DmFV; differentiable in points (see the module docstring)."""
    _check(points, n_gaussians)
    return _ThreeDmFV.apply(points, n_gaussians, sigma)


threedmfv_kernel.launches = 0
threedmfv_kernel.replays = 0
