"""Patch gather from a Fisher-vector volume, and its adjoint.

Port of dpdist_tpu/kernels/table_gather_pallas.py: `table_gather_x`
(TPU kernel `_x_kernel`), `table_gather` (TPU kernel `_kernel`) and
`table_gather_bwd` (TPU kernels `_bwd_kernel` + `_fold_and_emit`, and the
two V-in-lanes layouts of the same adjoint,
`_table_gather_bwd_transposed_ng` and `_table_gather_bwd_transposed`). The
CUDA kernels are dpdist_tpu_torch/csrc/table_gather.cu; its header says
what bounds each on an H100 and how its design meets that:

- table_gather_x: persistent blocks, one per SM, walk runs of a cloud's
  rows; each run's volume arrives in shared memory by one bulk copy while
  the previous run is written, and rows leave in 16-byte-aligned groups
  (4 float32 or 8 bfloat16 rows) by bulk stores from a double buffer.
- table_gather: one block per (cloud, tile of queries), one warp per row.
- table_gather_bwd: owner-computes. One block per (cloud, slab of g^2
  cells); each thread owns a few dfv slots in registers and pulls the grad
  entries of the queries whose window meets its slab, in query order: no
  atomics, no barrier per query. Each slot is summed from 0 in query
  order, so the kernel equals `table_gather_bwd_ordered` (one index_add_
  per query, in query order) bit for bit and is the same from run to run.

    x, vox = table_gather_x(fv, queries, grid_size, k)
        (B, V, C) volume + (B, N, 3) queries -> x = [delta, patch]
        (B, N, 3 + k^3*C) float32 and vox (B, N) int32 (0 off the grid).
        Differentiable in fv and queries, as the reference's custom VJP:
        dq = grad[..., :3] (the cell is piecewise constant) and
        dfv = table_gather_bwd(vox, grad[..., 3:]); where autograd says fv
        needs no gradient, table_gather_bwd is not called.
    patches = table_gather(fv, vox, grid_size, k)
        (B, V, C) volume + (B, N) int32 voxel ids -> the patch rows
        (B, N, k^3*C) float32, x without delta, for given ids (off-grid
        queries carry 0). Differentiable in fv: dfv = table_gather_bwd(vox,
        grad), called only where fv needs a gradient.
    dfv = table_gather_bwd(vox, grad, grid_size, k)
        (B, N) voxel ids + (B, N, k^3*C) grad -> (B, V, C), the adjoint of
        the patch gather in fv.

`table_gather_x` and `table_gather` take dtype=torch.bfloat16 for the
bf16 serving paths: x or the patch rows are then written in bfloat16, each
value the float32 one rounded once, as the reference's .astype(dtype).
That output is forward only; asking for it on inputs that need a gradient
raises.

On CPU tensors all three run their plain versions (`table_gather_x_plain`,
`table_gather_plain`, `table_gather_bwd_plain`), which are also the
kernels' oracles on the card, with `table_gather_bwd_ordered` for the
adjoint's order of sums. On CUDA tensors they launch the kernel or
raise; they never fall back. `table_gather_x.launches`,
`table_gather.launches` and `table_gather_bwd.launches` count kernel
launches, and nothing else.
"""

from __future__ import annotations

import functools

import torch

from dpdist_tpu_torch.kernels.build import MAX_SMEM
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    gather_patches,
    grid_centers,
    neighbor_ids,
    voxel_assign,
)

X_ROWS_PER_BLOCK = 32       # queries per block of the patch-only gather
X_THREADS = 256


def window_fits(grid_size: int, k: int) -> bool:
    """Whether the kernels take a k^3 window on a grid_size^3 grid: k odd
    and at most 2 grid_size + 1 (every kernel's window check)."""
    return k % 2 == 1 and 1 <= k <= 2 * grid_size + 1


def gather_smem(grid_size: int, k: int, C: int) -> int:
    """Shared memory bytes of the gathers of rows 2, 3, 6 and 10: the
    (G, C) volume and the window's two offset tables (the C entry
    dpdist_table_gather_smem)."""
    return 4 * (grid_size ** 3 * C + 2 * k ** 3)


def table_gather_fits(grid_size: int, k: int, C: int) -> bool:
    """Whether the gather kernels (rows 2, 3 and 6 here, row 10 in
    kernels/gather_fused.py) take this volume and window. For C = 20 the
    persistent gathers' smallest layout (the volume and a run's row
    descriptions, csrc/row_groups.cuh:plan_rows) fits wherever
    gather_smem does."""
    return window_fits(grid_size, k) and gather_smem(grid_size, k, C) <= MAX_SMEM


def table_gather_x_plain(fv, queries, grid_size: int, k: int):
    """Plain PyTorch version: voxel_assign -> extract_patches ->
    gather_patches -> concat. Returns (x, vox)."""
    vox, _, delta = voxel_assign(queries, grid_size)
    patches = gather_patches(extract_patches(fv, grid_size, k), vox)
    return torch.cat([delta, patches], dim=-1), vox


def table_gather_plain(fv, vox, grid_size: int, k: int):
    """Plain PyTorch version: gather_patches(extract_patches(fv), vox)."""
    return gather_patches(extract_patches(fv, grid_size, k), vox)


def table_gather_bwd_plain(vox, grad, grid_size: int, k: int):
    """Plain PyTorch version: the gradient in fv of
    gather_patches(extract_patches(fv)), by autograd (the port's copy of
    the reference's table_gather_bwd_xla_oracle)."""
    B, N, E = grad.shape
    with torch.enable_grad():
        fv = torch.zeros((B, grid_size ** 3, E // k ** 3), dtype=grad.dtype,
                         device=grad.device, requires_grad=True)
        patches = gather_patches(extract_patches(fv, grid_size, k), vox)
        return torch.autograd.grad(patches, fv, grad)[0]


def table_gather_bwd_ordered(vox, grad, grid_size: int, k: int):
    """The adjoint as an ordered plain sum: from zeros, one index_add_ per
    query, in query order. Within one query every dfv slot takes at most
    one term, so the sums run in table_gather_bwd's kernel's order and the
    two agree bit for bit. A vox outside [0, grid_size^3) adds nothing."""
    B, N, E = grad.shape
    V, K3 = grid_size ** 3, k ** 3
    C = E // K3
    valid = ((vox >= 0) & (vox < V)).to(grad.dtype)
    nid = neighbor_ids(vox, valid, grid_size, k).long()              # (B, N, K3), -1: no cell
    base = (torch.arange(B, device=grad.device) * (V + 1))[:, None, None]
    rows = base + torch.where(nid >= 0, nid, torch.full_like(nid, V))   # row V: a sink
    terms = grad.reshape(B, N, K3, C)
    out = torch.zeros(B * (V + 1), C, dtype=grad.dtype, device=grad.device)
    for n in range(N):
        out.index_add_(0, rows[:, n].reshape(-1), terms[:, n].reshape(-1, C))
    return out.view(B, V + 1, C)[:, :V].contiguous()


def check_forward_only(dtype, *inputs):
    """Raise for a bfloat16 output asked for on inputs that need a
    gradient: the bf16 backward is not ported."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the output dtype must be float32 or bfloat16, got {dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError("not ported yet: the bf16 gradient paths (a bfloat16 "
                                  "gather output has no backward)")


@functools.lru_cache(maxsize=8)
def _centers(G: int, device: torch.device):
    return torch.as_tensor(grid_centers(G), device=device).contiguous()


def _check_window(grid_size, k, C, device):
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")
    if device.type == "cuda":
        smem = gather_smem(grid_size, k, C)
        if smem > MAX_SMEM:
            raise ValueError(f"a ({grid_size}^3, {C}) volume needs {smem} B of shared "
                             f"memory, more than the {MAX_SMEM} B a block has")
    elif device.type != "cpu":
        raise ValueError(f"the table gather runs on cpu or cuda tensors, got {device}")


def _check_x(fv, queries, grid_size, k):
    for name, t, ndim in (("fv", fv, 3), ("queries", queries, 3)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.shape[-1] != 3 or queries.shape[1] < 1:
        raise ValueError(f"queries must be (B, N, 3), got {tuple(queries.shape)}")
    if fv.shape[1] != grid_size ** 3:
        raise ValueError(f"fv has {fv.shape[1]} cells, expected grid_size^3 = {grid_size ** 3}")
    if fv.shape[0] != queries.shape[0]:
        raise ValueError(f"batch mismatch: fv {tuple(fv.shape)}, queries {tuple(queries.shape)}")
    if fv.device != queries.device:
        raise ValueError(f"device mismatch: {fv.device} vs {queries.device}")
    _check_window(grid_size, k, fv.shape[2], fv.device)


def _table_gather_x_impl(fv, queries, grid_size, k, dtype=torch.float32):
    dev = fv.device
    if dev.type == "cpu":
        x, vox = table_gather_x_plain(fv, queries, grid_size, k)
        return x.to(dtype), vox

    from dpdist_tpu_torch.kernels import build

    B, V, C = fv.shape
    N = queries.shape[1]
    x = torch.empty((B, N, 3 + k ** 3 * C), dtype=dtype, device=dev)
    vox = torch.empty((B, N), dtype=torch.int32, device=dev)
    err = build.library().dpdist_table_gather_x(
        fv.data_ptr(), queries.data_ptr(), _centers(V, dev).data_ptr(), x.data_ptr(),
        vox.data_ptr(), B, N, grid_size, k, C, int(dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather_x")
    table_gather_x.launches += 1
    return x, vox


class _TableGatherX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fv, queries, grid_size, k):
        x, vox = _table_gather_x_impl(fv, queries, grid_size, k)
        ctx.save_for_backward(vox)
        ctx.window = (grid_size, k)
        ctx.mark_non_differentiable(vox)
        return x, vox

    @staticmethod
    def backward(ctx, grad_x, _grad_vox):
        (vox,) = ctx.saved_tensors
        dfv = dq = None
        if ctx.needs_input_grad[0]:
            dfv = table_gather_bwd(vox, grad_x[..., 3:], *ctx.window)
        if ctx.needs_input_grad[1]:
            dq = grad_x[..., :3]
        return dfv, dq, None, None


def table_gather_x(fv, queries, grid_size: int, k: int, dtype: torch.dtype = torch.float32):
    """(B, V, C) volume + (B, N, 3) queries -> (x, vox), x in `dtype`; see
    the module docstring."""
    _check_x(fv, queries, grid_size, k)
    if dtype == torch.float32:
        if torch.is_grad_enabled() and (fv.requires_grad or queries.requires_grad):
            return _TableGatherX.apply(fv, queries, grid_size, k)
        return _table_gather_x_impl(fv, queries, grid_size, k)   # no graph to record
    check_forward_only(dtype, fv, queries)
    return _table_gather_x_impl(fv, queries, grid_size, k, dtype)


table_gather_x.launches = 0


def _check_vox(vox):
    if not isinstance(vox, torch.Tensor) or vox.dtype != torch.int32 or vox.dim() != 2:
        raise TypeError("vox must be a (B, N) int32 tensor")


def _table_gather_impl(fv, vox, grid_size, k, dtype=torch.float32):
    dev = fv.device
    if dev.type == "cpu":
        return table_gather_plain(fv, vox, grid_size, k).to(dtype)

    from dpdist_tpu_torch.kernels import build

    B, V, C = fv.shape
    N = vox.shape[1]
    out = torch.empty((B, N, k ** 3 * C), dtype=dtype, device=dev)
    err = build.library().dpdist_table_gather(
        fv.data_ptr(), vox.data_ptr(), out.data_ptr(), B, N, grid_size, k, C, X_ROWS_PER_BLOCK,
        X_THREADS, int(dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather")
    table_gather.launches += 1
    return out


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fv, vox, grid_size, k):
        ctx.save_for_backward(vox)
        ctx.window = (grid_size, k)
        return _table_gather_impl(fv, vox, grid_size, k)

    @staticmethod
    def backward(ctx, grad):
        (vox,) = ctx.saved_tensors
        dfv = table_gather_bwd(vox, grad, *ctx.window) if ctx.needs_input_grad[0] else None
        return dfv, None, None, None


def table_gather(fv, vox, grid_size: int, k: int, dtype: torch.dtype = torch.float32):
    """(B, V, C) volume + (B, N) int32 voxel ids in [0, grid_size^3) ->
    (B, N, k^3*C) patch rows in `dtype`; see the module docstring."""
    _check_vox(vox)
    if not isinstance(fv, torch.Tensor) or fv.dtype != torch.float32 or fv.dim() != 3:
        raise TypeError("fv must be a (B, V, C) float32 tensor")
    if not fv.is_contiguous() or not vox.is_contiguous():
        raise ValueError("fv and vox must be contiguous")
    if fv.shape[1] != grid_size ** 3:
        raise ValueError(f"fv has {fv.shape[1]} cells, expected grid_size^3 = {grid_size ** 3}")
    if fv.shape[0] != vox.shape[0] or vox.shape[1] < 1:
        raise ValueError(f"fv {tuple(fv.shape)} and vox {tuple(vox.shape)} do not match")
    if fv.device != vox.device:
        raise ValueError(f"device mismatch: {fv.device} vs {vox.device}")
    _check_window(grid_size, k, fv.shape[2], fv.device)
    if dtype == torch.float32:
        return _TableGather.apply(fv, vox, grid_size, k)
    check_forward_only(dtype, fv)
    return _table_gather_impl(fv, vox, grid_size, k, dtype)


table_gather.launches = 0


def table_gather_bwd(vox, grad, grid_size: int, k: int):
    """(B, N) int32 voxel ids + (B, N, k^3*C) grad -> (B, V, C) dfv.

    `grad` may be a strided view (the patch part of x's gradient) as long
    as its last axis is contiguous. vox should lie in [0, grid_size^3): on
    the card a vox outside adds nothing; the plain version raises.
    """
    _check_vox(vox)
    if not isinstance(grad, torch.Tensor) or grad.dtype != torch.float32:
        raise TypeError("grad must be a float32 tensor")
    if grad.dim() != 3 or grad.shape[:2] != vox.shape or grad.shape[2] % k ** 3:
        raise ValueError(f"grad must be (B, N, k^3*C) for vox {tuple(vox.shape)}, "
                         f"got {tuple(grad.shape)}")
    if grad.device != vox.device:
        raise ValueError(f"device mismatch: {vox.device} vs {grad.device}")
    C = grad.shape[2] // k ** 3
    _check_window(grid_size, k, C, grad.device)
    dev = grad.device
    if dev.type == "cpu":
        return table_gather_bwd_plain(vox, grad, grid_size, k)

    from dpdist_tpu_torch.kernels import build

    if grad.stride(-1) != 1:
        grad = grad.contiguous()
    vox = vox.contiguous()
    B, N = vox.shape
    dfv = torch.empty((B, grid_size ** 3, C), dtype=torch.float32, device=dev)
    err = build.library().dpdist_table_gather_bwd(
        vox.data_ptr(), grad.data_ptr(), grad.stride(0), grad.stride(1), dfv.data_ptr(),
        B, N, grid_size, k, C, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather_bwd")
    table_gather_bwd.launches += 1
    return dfv


table_gather_bwd.launches = 0
