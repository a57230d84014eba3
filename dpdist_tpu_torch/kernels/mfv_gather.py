"""Fused 3DmFV encode + patch gather: points and queries -> decoder input.

Port of dpdist_tpu/kernels/mfv_gather_pallas.py (`mfv_table_gather_x`,
TPU kernel `_mfv_x_kernel`, and its VJP `_mfv_x_bwd`). The CUDA kernel is
dpdist_tpu_torch/csrc/mfv_gather.cu; its header says what bounds it on an
H100 (the write of x) and how the design meets that: one persistent block
per SM with warps specialised for the encode and for the rows. The encode
warps pool the next cloud while the row warps write the rows of the one
before, in 16-byte-aligned groups of 4 float32 or 8 bfloat16 rows that
leave by bulk stores (csrc/row_groups.cuh), so the encode hides behind the
stores.

`mfv_x` is the wrapper. On a CPU tensor it runs `mfv_x_plain`, the same
function in plain PyTorch (threedmfv -> extract_patches -> voxel_assign
-> gather -> concat), which is also the kernel's oracle on the card. On
a CUDA tensor it launches the kernel or raises; it never falls back.
`mfv_x.launches` counts kernel launches, and nothing else.

With dtype=torch.bfloat16 x is written in bfloat16, each value the float32
one rounded once, as the reference's `dtype=` (the bf16 paths).

Gradients follow the reference's VJP (mfv_gather_pallas.py:_mfv_x_bwd):
dq = grad[..., :3] in float32; for the points, dfv =
table_gather_bwd(vox, grad[..., 3:]) (the row-3 kernel on the card, in
bfloat16 for a bf16 x, its values returned to float32 exactly) and then
autograd through the plain threedmfv of the points, whose forward is
replayed there, since the kernel keeps the FV volume on chip and saves
none. Where no gradient is recorded (grad mode off, or neither input needs
one) the autograd Function is skipped.
"""

from __future__ import annotations

import functools
import math

import torch

from dpdist_tpu_torch.kernels.table_gather import check_dtype, dfv_of, needs_grad, window_fits
from dpdist_tpu_torch.ops.threedmfv import threedmfv_centers, threedmfv_plain
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    gather_patches,
    grid_centers,
    voxel_assign,
)

C = 20                      # FV channels of the full-FV 3-D encode
# The kernel's limit (csrc/mfv_gather.cu, the C entry
# dpdist_mfv_gather_x_max_gaussians): one encode thread per Gaussian and at
# least one warp of row threads in a block of 1,024. Every cube up to that
# (9^3 = 729) fits the kernel's shared memory in its layout without
# row-group buffers (157 KB at 729).
MAX_GAUSSIANS = 1024 - 32


def mfv_x_fits(grid_size: int, k: int) -> bool:
    """Whether the kernel takes a grid_size^3 grid and a k^3 window."""
    return grid_size ** 3 <= MAX_GAUSSIANS and window_fits(grid_size, k)


def mfv_x_plain(points, queries, n_gaussians: int, sigma: float,
                grid_size: int, k: int):
    """Plain PyTorch version: (B, M, 3), (B, N, 3) -> x (B, N, 3 + k^3*20)
    float32 and vox (B, N) int32."""
    fv = threedmfv_plain(points, n_gaussians, sigma)
    table = extract_patches(fv, grid_size, k)
    vox, _, delta = voxel_assign(queries, grid_size)
    x = torch.cat([delta, gather_patches(table, vox)], dim=-1)
    return x, vox


@functools.lru_cache(maxsize=8)
def _grid_tables(G: int, device: torch.device):
    """(G, 3) Gaussian centres and (G, 3) cell centres on `device`."""
    mu = threedmfv_centers(G, device=device)
    centers = torch.as_tensor(grid_centers(G), device=device).contiguous()
    return mu, centers


def _check(points, queries, n_gaussians, grid_size, k):
    for name, t in (("points", points), ("queries", queries)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, n, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[1] < 1:
            raise ValueError(f"{name} holds no points")
    if points.shape[0] != queries.shape[0]:
        raise ValueError(f"batch mismatch: points {tuple(points.shape)}, "
                         f"queries {tuple(queries.shape)}")
    if points.device != queries.device:
        raise ValueError(f"device mismatch: {points.device} vs {queries.device}")
    if n_gaussians != grid_size ** 3:
        raise ValueError(f"n_gaussians={n_gaussians} must equal grid_size^3 "
                         f"= {grid_size ** 3}")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")


def _mfv_x_impl(points, queries, n_gaussians, sigma, grid_size, k, dtype):
    dev = points.device
    if dev.type == "cpu":
        x, vox = mfv_x_plain(points, queries, n_gaussians, sigma, grid_size, k)
        return x.to(dtype), vox
    if dev.type != "cuda":
        raise ValueError(f"mfv_x runs on cpu or cuda tensors, got {dev}")

    from dpdist_tpu_torch.kernels import build

    lib = build.library()
    B, M, _ = points.shape
    N = queries.shape[1]
    G = n_gaussians
    if G > MAX_GAUSSIANS:
        raise ValueError(f"the kernel takes at most {MAX_GAUSSIANS} Gaussians, got {G}")
    mu, centers = _grid_tables(G, dev)
    x = torch.empty((B, N, 3 + k ** 3 * C), dtype=dtype, device=dev)
    vox = torch.empty((B, N), dtype=torch.int32, device=dev)
    w = 1.0 / G
    err = lib.dpdist_mfv_gather_x(
        points.data_ptr(), queries.data_ptr(), mu.data_ptr(), centers.data_ptr(),
        x.data_ptr(), vox.data_ptr(), B, M, N, grid_size, k, float(sigma),
        w, math.sqrt(w) * M, math.sqrt(w), math.sqrt(2.0 * w), 1.0 / M,
        int(dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "mfv_gather_x")
    mfv_x.launches += 1
    return x, vox


class _MfvX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, queries, n_gaussians, sigma, grid_size, k, dtype):
        x, vox = _mfv_x_impl(points, queries, n_gaussians, sigma, grid_size, k, dtype)
        ctx.save_for_backward(points, vox)
        ctx.args = (n_gaussians, sigma, grid_size, k)
        ctx.mark_non_differentiable(vox)
        return x, vox

    @staticmethod
    def backward(ctx, grad_x, _grad_vox):
        points, vox = ctx.saved_tensors
        n_gaussians, sigma, grid_size, k = ctx.args
        dpoints = dq = None
        if ctx.needs_input_grad[0]:
            dfv = dfv_of(vox, grad_x[..., 3:], grid_size, k)
            with torch.enable_grad():
                p = points.detach().requires_grad_(True)
                fv = threedmfv_plain(p, n_gaussians, sigma)
                (dpoints,) = torch.autograd.grad(fv, p, dfv)
        if ctx.needs_input_grad[1]:
            dq = grad_x[..., :3].float()
        return dpoints, dq, None, None, None, None, None


def mfv_x(points, queries, n_gaussians: int, sigma: float, grid_size: int,
          k: int, dtype: torch.dtype = torch.float32):
    """(B, M, 3) encoded clouds + (B, N, 3) queries -> (x, vox).

    x = [delta, patch] (B, N, 3 + k^3*20) in `dtype` (float32 or
    bfloat16), the decoder input, and vox (B, N) int32, each query's flat
    cell (0 outside the grid). Differentiable in points and queries (see
    the module docstring).
    """
    _check(points, queries, n_gaussians, grid_size, k)
    check_dtype(dtype)
    if needs_grad(points, queries):
        return _MfvX.apply(points, queries, n_gaussians, sigma, grid_size, k, dtype)
    return _mfv_x_impl(points, queries, n_gaussians, sigma, grid_size, k, dtype)


mfv_x.launches = 0


def mfv_table_gather_x(points, queries, n_gaussians: int, sigma: float,
                       grid_size: int, k: int, dtype: torch.dtype = torch.float32):
    """The decoder input x of `mfv_x` alone, as the JAX function returns it."""
    return mfv_x(points, queries, n_gaussians, sigma, grid_size, k, dtype)[0]
