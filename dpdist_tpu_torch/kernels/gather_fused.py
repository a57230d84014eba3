"""Per-query patch gather with the query mask: the decoder's patch rows
for fused_gather="on".

Port of dpdist_tpu/kernels/gather_pallas.py (`gather_patches_fused`, TPU
kernel `_kernel` over the ids of `neighbor_ids`, and its custom VJP). The
CUDA kernel is dpdist_tpu_torch/csrc/gather_fused.cu; its header says what
bounds it on an H100 and how the design meets that: the persistent gather
of `table_gather_x` (csrc/row_groups.cuh) without delta. One block per SM
walks runs of a cloud's rows; each run's volume arrives in shared memory by
one bulk copy while the previous run is written, and rows leave in groups
of up to 40 KB by bulk stores from a double buffer. A row whose query is
masked out is built as zeros without reading the volume.

    patches = gather_patches_fused(fv, vox, mask, grid_size, k)
        (B, V, C) float32 volume + (B, N) int32 voxel ids + (B, N) mask ->
        (B, N, k^3*C) float32: for each (query, offset) the C channels of
        the neighbour cell, zero where the neighbour is off the grid or the
        query is (mask 0). Differentiable in fv: the backward is the adjoint
        gather (kernels.table_gather.table_gather_bwd) on grad * mask, the
        VJP of the reference's oracle gather_patches(extract_patches(fv),
        vox) * mask (gather_pallas.py:94-116), called only where fv needs a
        gradient. Where no gradient is recorded (grad mode off, or fv
        needs none) the autograd Function is skipped.
    patches = gather_patches_fused(fv, vox, mask, grid_size, k, dtype)
        with dtype torch.bfloat16 or torch.float16: the same on the volume
        rounded to dtype, as the reference's bf16 or fp16 "on" path hands
        its kernel fv.astype(dtype) (its output stays float32,
        dpdist_tpu/models/dpdist.py:421-437). The kernel itself reads and
        writes float32: the wrapper rounds the volume first. The backward
        is the VJP of that cast too: the masked gradient rounded to dtype
        (the reference's VJP runs its oracle on the rounded volume), row
        3's two-byte adjoint, and dfv back in float32.

On CPU tensors it runs `gather_patches_fused_plain`, which is also the
kernel's oracle on the card. On CUDA tensors it launches the kernel or
raises; it never falls back. `gather_patches_fused.launches` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.kernels.build import MAX_SMEM
from dpdist_tpu_torch.kernels.table_gather import check_dtype, dfv_of, gather_smem, needs_grad
from dpdist_tpu_torch.ops.voxel import extract_patches, gather_patches


def gather_patches_fused_plain(fv, vox, mask, grid_size: int, k: int):
    """Plain PyTorch version:
    gather_patches(extract_patches(fv), vox) * mask[..., None]."""
    return gather_patches(extract_patches(fv, grid_size, k), vox) * mask[..., None]


def _check(fv, vox, mask, grid_size, k):
    if not isinstance(fv, torch.Tensor) or fv.dtype != torch.float32 or fv.dim() != 3:
        raise TypeError("fv must be a (B, V, C) float32 tensor")
    if not isinstance(vox, torch.Tensor) or vox.dtype != torch.int32 or vox.dim() != 2:
        raise TypeError("vox must be a (B, N) int32 tensor")
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.float32:
        raise TypeError("mask must be a (B, N) float32 tensor")
    if mask.shape != vox.shape:
        raise ValueError(f"mask {tuple(mask.shape)} and vox {tuple(vox.shape)} differ in shape")
    if not (fv.is_contiguous() and vox.is_contiguous() and mask.is_contiguous()):
        raise ValueError("fv, vox and mask must be contiguous")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")
    if fv.shape[1] != grid_size ** 3:
        raise ValueError(f"fv has {fv.shape[1]} cells, expected grid_size^3 = {grid_size ** 3}")
    if fv.shape[0] != vox.shape[0] or vox.shape[1] < 1:
        raise ValueError(f"fv {tuple(fv.shape)} and vox {tuple(vox.shape)} do not match")
    if not fv.device == vox.device == mask.device:
        raise ValueError(f"device mismatch: {fv.device}, {vox.device}, {mask.device}")
    if fv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gather runs on cpu or cuda tensors, got {fv.device}")


def _gather_fused_impl(fv, vox, mask, grid_size, k):
    dev = fv.device
    if dev.type == "cpu":
        return gather_patches_fused_plain(fv, vox, mask, grid_size, k)

    from dpdist_tpu_torch.kernels import build

    B, V, C = fv.shape
    N = vox.shape[1]
    smem = gather_smem(grid_size, k, C)
    if smem > MAX_SMEM:
        raise ValueError(f"a ({V}, {C}) volume needs {smem} B of shared memory, more than "
                         f"the {MAX_SMEM} B a block has")
    out = torch.empty((B, N, k ** 3 * C), dtype=torch.float32, device=dev)
    err = build.library().dpdist_gather_patches_fused(
        fv.data_ptr(), vox.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N, grid_size, k, C,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "gather_patches_fused")
    gather_patches_fused.launches += 1
    return out


class _GatherFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fv, vox, mask, grid_size, k, dtype):
        ctx.save_for_backward(vox, mask)
        ctx.window = (grid_size, k)
        ctx.dtype = dtype
        return _gather_fused_impl(_volume(fv, dtype), vox, mask, grid_size, k)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        vox, mask = ctx.saved_tensors
        dfv = dfv_of(vox, (grad * mask[..., None]).to(ctx.dtype), *ctx.window)
        return dfv, None, None, None, None, None


def _volume(fv, dtype):
    """The volume the gather reads: fv, or fv's values rounded to dtype."""
    return fv if dtype == torch.float32 else fv.to(dtype).to(torch.float32)


def gather_patches_fused(fv, vox, mask, grid_size: int, k: int,
                         dtype: torch.dtype = torch.float32):
    """(B, V, C) float32 volume, (B, N) int32 voxel ids in [0, grid_size^3)
    and (B, N) float32 mask -> (B, N, k^3*C) float32 patches of the volume
    taken in `dtype`; see the module docstring. vox and mask carry no
    gradient."""
    _check(fv, vox, mask, grid_size, k)
    check_dtype(dtype)
    if needs_grad(fv):
        return _GatherFused.apply(fv, vox, mask.detach(), grid_size, k, dtype)
    return _gather_fused_impl(_volume(fv, dtype), vox, mask.detach(), grid_size,
                              k)   # no graph to record


gather_patches_fused.launches = 0
