"""The Hopper kernels as torch.library custom ops, for torch.export.

The kernels are bound through ctypes (kernels/build.py), which torch.export
cannot see. Each kernel that `models.dpdist.route` can choose for an
exported distance is registered here as an op of the `dpdist` namespace:

    dpdist::mfv_x                 row 1   kernels/mfv_gather.mfv_x
    dpdist::table_gather_x        row 2   kernels/table_gather.table_gather_x
    dpdist::table_gather_bwd      row 3   kernels/table_gather.table_gather_bwd
                                          (float32 and bfloat16 grads)
    dpdist::table_gather          row 6   kernels/table_gather.table_gather
    dpdist::threedmfv             row 7   kernels/threedmfv.threedmfv_kernel
    dpdist::fused_forward         row 9   kernels/fused_forward.fused_forward
    dpdist::gather_patches_fused  row 10  kernels/gather_fused.gather_patches_fused

An op's implementation is its eager wrapper, called without a graph: on
CUDA tensors it launches the kernel and counts the launch as the eager path
does (`.launches`), on CPU tensors it runs the kernel's plain version. Its
fake gives the output shapes and dtypes from the inputs' (a symbolic batch
included) and counts nothing. The gradients are those of the eager
autograd.Functions: rows 2, 6 and 10 take row 3 through its op, row 1 takes
row 3 and the replay of the plain encode, row 7 the replay; so an exported
gradient shows row 3. Row 9 has none, as the reference's kernel has no VJP.
Row 9's op takes the packed decoder's tensors as arguments (lists of
tensors), not the PackedDecoder.

The eager paths never call these ops. While `exporting("native")` is
active (serving.export_frozen_distance and export_registration with
portable=False), `dispatch(wrapper)` gives the op that stands for an eager
wrapper, and `route_device` routes as the card does wherever the export is
traced, so that a native artifact exported on the CPU holds the card's
kernels (and runs their plain versions on the CPU). Under
`exporting("portable")` every route takes the plain ops. Row 8
(kernels/chamfer.nn_min_sqdist) has no op yet: no exported function reaches
it at the served sizes, and `dispatch` raises NotImplementedError naming it.

A process that loads a native artifact imports this module first, so that
the `dpdist` ops are registered (as the reference's Mosaic artifact needs a
TPU runtime).
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor

from dpdist_tpu_torch.kernels import fused_forward as _ff
from dpdist_tpu_torch.kernels import gather_fused as _gf
from dpdist_tpu_torch.kernels import mfv_gather as _mfv
from dpdist_tpu_torch.kernels import table_gather as _tg
from dpdist_tpu_torch.kernels import threedmfv as _t7
from dpdist_tpu_torch.kernels.chamfer import chamfer_distance_kernel, nn_min_sqdist
from dpdist_tpu_torch.ops.threedmfv import threedmfv_plain

MODES = ("native", "portable")
_mode = None   # None (eager), or the mode of the export being traced


@contextlib.contextmanager
def exporting(mode: str):
    """Trace an export in `mode`: "native" (the kernels as ops, routed as on
    the card) or "portable" (plain ops only)."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"export mode must be one of {MODES}, got {mode!r}")
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


def route_device(t: Tensor) -> str:
    """The device type the kernels' routing reads for tensor t: "cuda"
    while a native export traces, "cpu" (the plain ops) while a portable
    one does, else t's own."""
    if _mode == "native":
        return "cuda"
    if _mode == "portable":
        return "cpu"
    return t.device.type


def _run(wrapper, *args, **kw):
    """The eager wrapper on contiguous inputs, recording no graph."""
    args = tuple(a.contiguous() if isinstance(a, Tensor) else a for a in args)
    with torch.no_grad():
        return wrapper(*args, **kw)


def _dfv(vox, grad, grid_size, k):
    """The volume's gradient by row 3's op, returned in float32."""
    return torch.ops.dpdist.table_gather_bwd(vox, grad, grid_size, k).float()


def _replay(points, dfv, n_gaussians, sigma):
    """d points of <threedmfv_plain(points), dfv>: the plain encode replayed
    under autograd, as the eager backwards of rows 1 and 7 take it."""
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        return torch.autograd.grad(threedmfv_plain(p, n_gaussians, sigma), p, dfv)[0]


# --- row 1

@torch.library.custom_op("dpdist::mfv_x", mutates_args=())
def mfv_x_op(points: Tensor, queries: Tensor, n_gaussians: int, sigma: float, grid_size: int,
             k: int, dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    return _run(_mfv.mfv_x, points, queries, n_gaussians, sigma, grid_size, k, dtype)


@mfv_x_op.register_fake
def _(points, queries, n_gaussians, sigma, grid_size, k, dtype):
    B, N, _ = queries.shape
    return (queries.new_empty((B, N, 3 + k ** 3 * _mfv.C), dtype=dtype),
            queries.new_empty((B, N), dtype=torch.int32))


def _mfv_setup(ctx, inputs, output):
    points, _, n_gaussians, sigma, grid_size, k, _ = inputs
    ctx.save_for_backward(points, output[1])
    ctx.args = (n_gaussians, sigma, grid_size, k)


def _mfv_backward(ctx, grad_x, _grad_vox):
    points, vox = ctx.saved_tensors
    n_gaussians, sigma, grid_size, k = ctx.args
    dpoints = dq = None
    if ctx.needs_input_grad[0]:
        dpoints = _replay(points, _dfv(vox, grad_x[..., 3:], grid_size, k), n_gaussians, sigma)
    if ctx.needs_input_grad[1]:
        dq = grad_x[..., :3].float()
    return dpoints, dq, None, None, None, None, None


mfv_x_op.register_autograd(_mfv_backward, setup_context=_mfv_setup)


# --- row 2

@torch.library.custom_op("dpdist::table_gather_x", mutates_args=())
def table_gather_x_op(fv: Tensor, queries: Tensor, grid_size: int, k: int,
                      dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    return _run(_tg.table_gather_x, fv, queries, grid_size, k, dtype)


@table_gather_x_op.register_fake
def _(fv, queries, grid_size, k, dtype):
    B, N, _ = queries.shape
    return (queries.new_empty((B, N, 3 + k ** 3 * fv.shape[2]), dtype=dtype),
            queries.new_empty((B, N), dtype=torch.int32))


def _x_setup(ctx, inputs, output):
    ctx.save_for_backward(output[1])
    ctx.window = inputs[2:4]


def _x_backward(ctx, grad_x, _grad_vox):
    (vox,) = ctx.saved_tensors
    dfv = _dfv(vox, grad_x[..., 3:], *ctx.window) if ctx.needs_input_grad[0] else None
    dq = grad_x[..., :3].float() if ctx.needs_input_grad[1] else None
    return dfv, dq, None, None, None


table_gather_x_op.register_autograd(_x_backward, setup_context=_x_setup)


# --- row 3

@torch.library.custom_op("dpdist::table_gather_bwd", mutates_args=())
def table_gather_bwd_op(vox: Tensor, grad: Tensor, grid_size: int, k: int) -> Tensor:
    if grad.device.type == "cpu":
        # Autograd is off inside an op's implementation, and
        # table_gather_bwd_plain takes the adjoint by autograd: the ordered
        # plain sum instead (the kernel's order of sums).
        return _tg.table_gather_bwd_ordered(vox, grad.contiguous(), grid_size, k)
    with torch.no_grad():
        return _tg.table_gather_bwd(vox.contiguous(), grad, grid_size, k)


@table_gather_bwd_op.register_fake
def _(vox, grad, grid_size, k):
    return grad.new_empty((grad.shape[0], grid_size ** 3, grad.shape[2] // k ** 3))


# --- row 6

@torch.library.custom_op("dpdist::table_gather", mutates_args=())
def table_gather_op(fv: Tensor, vox: Tensor, grid_size: int, k: int, dtype: torch.dtype) -> Tensor:
    return _run(_tg.table_gather, fv, vox, grid_size, k, dtype)


@table_gather_op.register_fake
def _(fv, vox, grid_size, k, dtype):
    return fv.new_empty((*vox.shape, k ** 3 * fv.shape[2]), dtype=dtype)


def _vox_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])
    ctx.window = inputs[2:4]


def _patches_backward(ctx, grad):
    (vox,) = ctx.saved_tensors
    dfv = _dfv(vox, grad, *ctx.window) if ctx.needs_input_grad[0] else None
    return dfv, None, None, None, None


table_gather_op.register_autograd(_patches_backward, setup_context=_vox_setup)


# --- row 7

@torch.library.custom_op("dpdist::threedmfv", mutates_args=())
def threedmfv_op(points: Tensor, n_gaussians: int, sigma: float) -> Tensor:
    return _run(_t7.threedmfv_kernel, points, n_gaussians, sigma)


@threedmfv_op.register_fake
def _(points, n_gaussians, sigma):
    return points.new_empty((points.shape[0], n_gaussians, 20))


def _t7_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])
    ctx.args = inputs[1:]


def _t7_backward(ctx, grad_fv):
    if not ctx.needs_input_grad[0]:
        return None, None, None
    (points,) = ctx.saved_tensors
    return _replay(points, grad_fv, *ctx.args), None, None


threedmfv_op.register_autograd(_t7_backward, setup_context=_t7_setup)


# --- row 9

@torch.library.custom_op("dpdist::fused_forward", mutates_args=())
def fused_forward_op(fv: Tensor, vox: Tensor, delta: Tensor, w: list[Tensor], b: list[Tensor],
                     w_out: Tensor, b_out: Tensor, in_dim: int, grid_size: int,
                     k: int) -> Tensor:
    packed = _ff.PackedDecoder(w=tuple(w), b=tuple(b), w_out=w_out, b_out=b_out, in_dim=in_dim)
    return _run(_ff.fused_forward, fv, vox, delta, packed, grid_size, k)


@fused_forward_op.register_fake
def _(fv, vox, delta, w, b, w_out, b_out, in_dim, grid_size, k):
    return delta.new_empty((*vox.shape, b_out.shape[0]))


# --- row 10

@torch.library.custom_op("dpdist::gather_patches_fused", mutates_args=())
def gather_patches_fused_op(fv: Tensor, vox: Tensor, mask: Tensor, grid_size: int, k: int,
                            dtype: torch.dtype) -> Tensor:
    return _run(_gf.gather_patches_fused, fv, vox, mask, grid_size, k, dtype)


@gather_patches_fused_op.register_fake
def _(fv, vox, mask, grid_size, k, dtype):
    return fv.new_empty((*vox.shape, k ** 3 * fv.shape[2]))


def _gf_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1], inputs[2])
    ctx.window = inputs[3:5]
    ctx.dtype = inputs[5]


def _gf_backward(ctx, grad):
    if not ctx.needs_input_grad[0]:
        return None, None, None, None, None, None
    vox, mask = ctx.saved_tensors
    dfv = _dfv(vox, (grad * mask[..., None]).to(ctx.dtype), *ctx.window)
    return dfv, None, None, None, None, None


gather_patches_fused_op.register_autograd(_gf_backward, setup_context=_gf_setup)


# --- the ops behind the eager wrappers' signatures

def _mfv_x(points, queries, n_gaussians, sigma, grid_size, k, dtype=torch.float32):
    return mfv_x_op(points, queries, n_gaussians, float(sigma), grid_size, k, dtype)


def _table_gather_x(fv, queries, grid_size, k, dtype=torch.float32):
    return table_gather_x_op(fv, queries, grid_size, k, dtype)


def _table_gather(fv, vox, grid_size, k, dtype=torch.float32):
    return table_gather_op(fv, vox, grid_size, k, dtype)


def _threedmfv(points, n_gaussians=512, sigma=0.125):
    return threedmfv_op(points, n_gaussians, float(sigma))


def _fused_forward(fv, vox, delta, packed, grid_size, k):
    return fused_forward_op(fv, vox, delta, list(packed.w), list(packed.b), packed.w_out,
                            packed.b_out, packed.in_dim, grid_size, k)


def _gather_patches_fused(fv, vox, mask, grid_size, k, dtype=torch.float32):
    return gather_patches_fused_op(fv, vox, mask, grid_size, k, dtype)


_OPS = {_mfv.mfv_x: _mfv_x, _tg.table_gather_x: _table_gather_x,
        _tg.table_gather: _table_gather, _t7.threedmfv_kernel: _threedmfv,
        _ff.fused_forward: _fused_forward, _gf.gather_patches_fused: _gather_patches_fused}
# Reached by no exported function at the served sizes (ROADMAP.md §1).
_NO_OP = {nn_min_sqdist: "row 8 (nn_min_sqdist)",
          chamfer_distance_kernel: "row 8 (nn_min_sqdist, through chamfer_distance_kernel)"}


def dispatch(wrapper):
    """The eager kernel wrapper `wrapper`, or while a native export traces,
    the op that stands for it (with the wrapper's signature). Raises
    NotImplementedError for a kernel that has no op."""
    if _mode != "native":
        return wrapper
    if wrapper in _NO_OP:
        raise NotImplementedError(
            f"a native-kernel export reaches {_NO_OP[wrapper]}, which has no torch.library op "
            "yet: export with portable=True")
    return _OPS[wrapper]
