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
  (4 float32 or 8 two-byte rows) by bulk stores from a double buffer.
- table_gather: the same persistent design on the patch rows of given
  voxels (no delta): rows in groups of up to 40 KB (4 float32 or 8
  two-byte rows of k^3*C = 2,500), a two-byte chunk of 4 elements by one
  8-byte store.
- table_gather_bwd: owner-computes. On a float32 grad, one block per
  (cloud, slab of g^2 cells); each thread owns a few dfv slots in
  registers and pulls the grad entries of the queries whose window meets
  its slab, in query order: no atomics, no barrier per query. On a
  two-byte grad (bfloat16 or float16), its own kernel, instantiated for
  each: persistent blocks walk (cloud, slab) items, a producer warp
  listing each item's queries and bringing their grad runs into a ring by
  bulk copies while the consumer warps sum; a thread owns 10 channels of
  one cell, tests the window once a query and reads the pairs as 32-bit
  words, summing in float32 and rounding each dfv value once. Each value
  is summed from 0 in query order, so both kernels equal
  `table_gather_bwd_ordered` (one index_add_ per query, in query order)
  bit for bit and are the same from run to run.
  `table_gather_bwd_fits` holds their shared-memory limits, which
  `models.dpdist.route` reads.

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
        the patch gather in fv, in the grad's dtype: float32, or bfloat16 or
        float16 summed in float32 and rounded once, as the reference's
        table_gather_bwd(dtype=) (table_gather_pallas.py:159-256).

`table_gather_x` and `table_gather` take dtype=torch.bfloat16 or
torch.float16 for the two-byte paths: x or the patch rows are then written
in that dtype, each value the float32 one rounded once to nearest even
(overflow to inf, subnormals kept), as the reference gathers from its
volume cast to cfg.dtype (dpdist_tpu/models/dpdist.py:421-437). Their
backward then gets a gradient of that dtype: dq = grad[..., :3] in
float32, and dfv from the two-byte adjoint, whose values return to float32
exactly, as the VJP of the reference's cast of the float32 volume does.
One deviation, past float16's range only: where the volume holds a value
that rounds to inf, the reference's one-hot gathers read NaN (0 * inf) in
that channel of every row of the cloud, and these gathers read inf in the
rows whose window holds the cell and the finite values elsewhere (a 3DmFV
volume, normalised to unit length, never gets there).

On CPU tensors all three run their plain versions (`table_gather_x_plain`,
`table_gather_plain`, `table_gather_bwd_plain`), which are also the
kernels' oracles on the card, with `table_gather_bwd_ordered` for the
adjoint's order of sums. On CUDA tensors they launch the kernel or
raise; they never fall back. `table_gather_x.launches`,
`table_gather.launches`, `table_gather_bwd.launches` (its float32 kernel),
`table_gather_bwd.launches_bf16` and `table_gather_bwd.launches_fp16` (its
two-byte kernel on a bfloat16 and on a float16 grad) count kernel
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

# The persistent gathers' run of rows and a row's description
# (csrc/row_groups.cuh: kMaxRows, sizeof(XRow)).
MAX_ROWS, XROW_BYTES = 128, 20
# The output and grad dtypes the kernels take, and the code of each in
# their C entries (csrc/patch_rows.cuh: OutType).
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HALF_TYPES = (torch.bfloat16, torch.float16)


def window_fits(grid_size: int, k: int) -> bool:
    """Whether the kernels take a k^3 window on a grid_size^3 grid: k odd
    and at most 2 grid_size + 1 (every kernel's window check)."""
    return k % 2 == 1 and 1 <= k <= 2 * grid_size + 1


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def gather_smem(grid_size: int, k: int, C: int) -> int:
    """Shared memory bytes of the smallest layout of the persistent gathers
    (rows 2, 6 and 10; csrc/row_groups.cuh:plan_rows): one (G, C) float32
    volume buffer and a run's row descriptions, each rounded up to 128
    bytes, and two mbarriers; the window does not enter (the C entry
    dpdist_table_gather_smem)."""
    return _align128(4 * grid_size ** 3 * C) + _align128(MAX_ROWS * XROW_BYTES) + 16


def table_gather_fits(grid_size: int, k: int, C: int) -> bool:
    """Whether the gather kernels (rows 2 and 6 here, row 10 in
    kernels/gather_fused.py) take this volume and window: exactly where
    their plan finds a layout, gather_smem <= MAX_SMEM; larger plans take
    more shared memory only where it is there. Row 3 has its own limits
    (table_gather_bwd_fits)."""
    return window_fits(grid_size, k) and gather_smem(grid_size, k, C) <= MAX_SMEM


# The adjoint kernels' shared memory (csrc/table_gather.cu), mirrored from
# shapes so that route sees their limits before any launch.
BWD_F32_STAGES, BWD_F32_SLOTS, BWD_F32_MAX_THREADS = 4, 5, 256
# The two-byte adjoint (bfloat16 and float16 grads; named for its first
# type): an owner sums BWD_BF16_GROUP channels of one cell; a ring of
# BWD_BF16_STAGES stages of runs; vox chunks of 128 queries, 4 in flight.
# Its C entry plans the rest of its launch
# (dpdist_table_gather_bwd_bf16_plan).
BWD_BF16_GROUP, BWD_BF16_STAGES = 10, 4
BWD_BF16_VOX_BYTES = 4 * 128 * 4


def bwd_f32_smem(grid_size: int, k: int, C: int) -> int:
    """Shared memory bytes of the float32 adjoint's smallest layout (one run
    a stage, 64-bit run offsets), as its C entry sizes it."""
    per_thread = -(-grid_size ** 2 * C // BWD_F32_SLOTS)
    threads = min(BWD_F32_MAX_THREADS, -(-per_thread // 32) * 32)
    fixed = BWD_F32_STAGES * 8 + threads * (8 + 4) + threads // 32 * 4
    slot = (k * k * C + 6) // 4 * 4       # a run's 16-byte-aligned span, in floats
    return BWD_F32_STAGES * slot * 4 + fixed


def bwd_bf16_smem(k: int, C: int, runs: int) -> int:
    """Shared memory bytes of the two-byte adjoint with `runs` runs a stage
    (csrc/table_gather.cu:b16_layout): the ring of runs' slots (a run's
    16-byte-aligned span and BWD_BF16_GROUP + 2 elements past it), the full
    and empty barriers, each run's (vy, vz, lead) pair, the stages' headers
    and the vox chunks."""
    slot = (k * k * C + 14 + BWD_BF16_GROUP + 2 + 7) // 8 * 8
    return (BWD_BF16_STAGES * runs * (2 * slot + 8) + 2 * BWD_BF16_STAGES * 8
            + BWD_BF16_STAGES * 4 + BWD_BF16_VOX_BYTES)


def table_gather_bwd_fits(grid_size: int, k: int, C: int, dtype=torch.float32) -> bool:
    """Whether the adjoint kernel of `dtype` (float32, or the two-byte
    kernel of bfloat16 and float16) takes this window and channel count:
    g <= 255 and one run a stage of its ring in shared memory. In two bytes
    that also keeps a run below 2^24 elements and a slab's owners below
    2^31, the C entry's other limits."""
    if not window_fits(grid_size, k) or not 1 <= grid_size <= 255 or C < 1:
        return False
    if dtype in HALF_TYPES:
        return bwd_bf16_smem(k, C, 1) <= MAX_SMEM
    return bwd_f32_smem(grid_size, k, C) <= MAX_SMEM


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
    the reference's table_gather_bwd_xla_oracle). A bfloat16 or float16
    grad is summed in float32 and the result rounded once to its dtype."""
    if grad.dtype in HALF_TYPES:
        return table_gather_bwd_plain(vox, grad.float(), grid_size, k).to(grad.dtype)
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
    two agree bit for bit. A vox outside [0, grid_size^3) adds nothing. A
    bfloat16 or float16 grad is summed in float32 and the result rounded
    once."""
    if grad.dtype in HALF_TYPES:
        return table_gather_bwd_ordered(vox, grad.float(), grid_size, k).to(grad.dtype)
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


def check_dtype(dtype):
    if dtype not in OUT_TYPES:
        raise TypeError(f"the output dtype must be float32, bfloat16 or float16, got {dtype}")


def needs_grad(*inputs) -> bool:
    """Whether autograd records a graph through inputs: grad mode is on
    and one of them needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def dfv_of(vox, grad, grid_size: int, k: int):
    """The volume's gradient from a gather output's gradient: the adjoint
    in grad's dtype, returned in float32 (exact for a bfloat16 or float16
    dfv)."""
    return table_gather_bwd(vox, grad, grid_size, k).float()


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
        vox.data_ptr(), B, N, grid_size, k, C, OUT_TYPES[dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather_x")
    table_gather_x.launches += 1
    return x, vox


class _TableGatherX(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fv, queries, grid_size, k, dtype):
        x, vox = _table_gather_x_impl(fv, queries, grid_size, k, dtype)
        ctx.save_for_backward(vox)
        ctx.window = (grid_size, k)
        ctx.mark_non_differentiable(vox)
        return x, vox

    @staticmethod
    def backward(ctx, grad_x, _grad_vox):
        (vox,) = ctx.saved_tensors
        dfv = dq = None
        if ctx.needs_input_grad[0]:
            dfv = dfv_of(vox, grad_x[..., 3:], *ctx.window)
        if ctx.needs_input_grad[1]:
            dq = grad_x[..., :3].float()
        return dfv, dq, None, None, None


def table_gather_x(fv, queries, grid_size: int, k: int, dtype: torch.dtype = torch.float32):
    """(B, V, C) volume + (B, N, 3) queries -> (x, vox), x in `dtype`; see
    the module docstring."""
    _check_x(fv, queries, grid_size, k)
    check_dtype(dtype)
    if needs_grad(fv, queries):
        return _TableGatherX.apply(fv, queries, grid_size, k, dtype)
    return _table_gather_x_impl(fv, queries, grid_size, k, dtype)   # no graph to record


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
        fv.data_ptr(), vox.data_ptr(), out.data_ptr(), B, N, grid_size, k, C,
        OUT_TYPES[dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather")
    table_gather.launches += 1
    return out


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fv, vox, grid_size, k, dtype):
        ctx.save_for_backward(vox)
        ctx.window = (grid_size, k)
        return _table_gather_impl(fv, vox, grid_size, k, dtype)

    @staticmethod
    def backward(ctx, grad):
        (vox,) = ctx.saved_tensors
        dfv = dfv_of(vox, grad, *ctx.window) if ctx.needs_input_grad[0] else None
        return dfv, None, None, None, None


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
    check_dtype(dtype)
    if needs_grad(fv):
        return _TableGather.apply(fv, vox, grid_size, k, dtype)
    return _table_gather_impl(fv, vox, grid_size, k, dtype)   # no graph to record


table_gather.launches = 0


def table_gather_bwd(vox, grad, grid_size: int, k: int):
    """(B, N) int32 voxel ids + (B, N, k^3*C) grad -> (B, V, C) dfv in
    grad's dtype (float32, bfloat16 or float16).

    `grad` may be a strided view (the patch part of x's gradient); on the
    card a view whose last axis is not contiguous is copied first. vox
    should lie in [0, grid_size^3): on the card a vox outside adds
    nothing; the plain version raises. `launches` counts the float32
    kernel's launches, and `launches_bf16` and `launches_fp16` the
    two-byte kernel's on a bfloat16 and on a float16 grad.
    """
    _check_vox(vox)
    if not isinstance(grad, torch.Tensor) or grad.dtype not in OUT_TYPES:
        raise TypeError("grad must be a float32, bfloat16 or float16 tensor")
    if grad.dim() != 3 or grad.shape[:2] != vox.shape or grad.shape[2] % k ** 3:
        raise ValueError(f"grad must be (B, N, k^3*C) for vox {tuple(vox.shape)}, "
                         f"got {tuple(grad.shape)}")
    if grad.device != vox.device:
        raise ValueError(f"device mismatch: {vox.device} vs {grad.device}")
    C = grad.shape[2] // k ** 3
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")
    dev = grad.device
    if dev.type == "cpu":
        return table_gather_bwd_plain(vox, grad, grid_size, k)
    if dev.type != "cuda":
        raise ValueError(f"the table gather runs on cpu or cuda tensors, got {dev}")
    # The adjoint stages grad runs, not the volume: its own limits.
    if not table_gather_bwd_fits(grid_size, k, C, grad.dtype):
        raise ValueError(f"the {grad.dtype} adjoint kernel does not take g = {grid_size}, "
                         f"k = {k}, C = {C} (table_gather_bwd_fits)")

    from dpdist_tpu_torch.kernels import build

    if grad.stride(-1) != 1:
        grad = grad.contiguous()
    vox = vox.contiguous()
    B, N = vox.shape
    dfv = torch.empty((B, grid_size ** 3, C), dtype=grad.dtype, device=dev)
    err = build.library().dpdist_table_gather_bwd(
        vox.data_ptr(), grad.data_ptr(), grad.stride(0), grad.stride(1), dfv.data_ptr(),
        B, N, grid_size, k, C, OUT_TYPES[grad.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "table_gather_bwd")
    if grad.dtype == torch.bfloat16:
        table_gather_bwd.launches_bf16 += 1
    elif grad.dtype == torch.float16:
        table_gather_bwd.launches_fp16 += 1
    else:
        table_gather_bwd.launches += 1
    return dfv


table_gather_bwd.launches = 0
table_gather_bwd.launches_bf16 = 0
table_gather_bwd.launches_fp16 = 0
