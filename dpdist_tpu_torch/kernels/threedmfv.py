"""Streaming 3DmFV encode: (B, N, 3) points -> (B, G, 20) normalised full
Fisher vectors, for any N.

Port of dpdist_tpu/kernels/threedmfv_pallas.py (`threedmfv_pallas`, TPU
kernel `_kernel` with its XLA finalisation, and its VJP). The CUDA kernel
is dpdist_tpu_torch/csrc/threedmfv.cu, over the encode of
csrc/fv_encode.cuh; its header says what bounds it on an H100.

`threedmfv_kernel` is the wrapper. On a CPU tensor it runs the plain
encode (ops.threedmfv.threedmfv_plain), which is also the kernel's oracle
on the card. On a CUDA tensor it launches the kernels or raises; it never
falls back. One call makes one or two CUDA launches: the pools over a
(B, S) grid of point chunks (`split_plan`), and their merge where S > 1;
`threedmfv_kernel.launches` counts calls that launched, one per call, and
nothing else.

The kernel has no backward of its own, as on the TPU: the max and min
pools must split their gradient evenly over ties (points far outside the
grid underflow Q to 0 and tie at the floor), which autograd's amax/amin
do. So the backward replays the plain encode under autograd and takes its
VJP (dpdist_tpu/kernels/threedmfv_pallas.py:147-157), only where the
points need a gradient; `threedmfv_kernel.replays` counts those replays,
and under a profiler session each opens the span "threedmfv.replay"
(train.profiling.span) on the thread that runs the backward.
"""

from __future__ import annotations

import functools
import math

import torch

from dpdist_tpu_torch.kernels.build import MAX_SMEM
from dpdist_tpu_torch.ops.threedmfv import threedmfv_centers, threedmfv_plain


@functools.lru_cache(maxsize=8)
def _mu(G: int, device: torch.device):
    return threedmfv_centers(G, device=device)


def _threads(G: int) -> int:
    return min(1024, max(256, -(-G // 32) * 32))


# The split of each cloud's points over blocks: about BLOCKS_PER_SM blocks
# per SM in all, no chunk below MIN_CHUNK_POINTS points, chunks a multiple
# of the kernel's TILE_POINTS-point logit tile (csrc/fv_encode.cuh).
BLOCKS_PER_SM, MIN_CHUNK_POINTS, TILE_POINTS = 2, 32, 32
# The kernel's limits (csrc/threedmfv.cu): one thread per Gaussian in a
# block of at most 1,024, and the encode's shared memory.
MAX_GAUSSIANS = 1024


def encode_smem(n_gaussians: int, threads: int) -> int:
    """Shared memory bytes of the encode (the C entry dpdist_threedmfv_smem,
    csrc/fv_encode.cuh:encode_smem_floats): a logit tile per Gaussian, the
    tile's sums, two point tiles, and a warp reduction's scratch."""
    return 4 * (TILE_POINTS * n_gaussians + TILE_POINTS + 6 * TILE_POINTS
                + threads // 32 * 20 + 20)


def threedmfv_fits(n_gaussians: int) -> bool:
    """Whether the kernel takes an encode of n_gaussians Gaussians."""
    return (n_gaussians <= MAX_GAUSSIANS
            and encode_smem(n_gaussians, _threads(n_gaussians)) <= MAX_SMEM)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def merge_groups(B: int, sm_count: int) -> int:
    """Blocks per cloud of the merge, each taking every merge_groups-th of
    the 20 channels: 20 for a single cloud, 1 once B alone gives about
    BLOCKS_PER_SM blocks per SM."""
    return max(1, min(20, BLOCKS_PER_SM * sm_count // B))


def split_plan(B: int, N: int, sm_count: int) -> tuple[int, int]:
    """(S, chunk): cloud b's points [s*chunk, min(N, (s+1)*chunk)) go to
    block (b, s) for s < S; every chunk holds at least one point. S = 1
    (no merge) once B is more than half the card's BLOCKS_PER_SM * sm_count
    blocks."""
    want = max(1, min(BLOCKS_PER_SM * sm_count // B, -(-N // MIN_CHUNK_POINTS)))
    chunk = -(-N // want)
    chunk = -(-chunk // TILE_POINTS) * TILE_POINTS
    return -(-N // chunk), chunk


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
    if g ** 3 != n_gaussians or n_gaussians > MAX_GAUSSIANS:
        raise ValueError(f"n_gaussians must be a cube of at most {MAX_GAUSSIANS}, "
                         f"got {n_gaussians}")
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
    smem = encode_smem(G, threads)
    if smem > MAX_SMEM:
        raise ValueError(f"G={G} needs {smem} B of shared memory, more than the "
                         f"{MAX_SMEM} B a block has")
    sms = _sm_count(dev.index)
    S, chunk = split_plan(B, N, sms)
    out = torch.empty((B, G, 20), dtype=torch.float32, device=dev)
    partial = torch.empty((B, S, 20, G), dtype=torch.float32, device=dev) if S > 1 else out
    w = 1.0 / G
    err = lib.dpdist_threedmfv(
        points.data_ptr(), _mu(G, dev).data_ptr(), partial.data_ptr(), out.data_ptr(), B, N, S,
        chunk, merge_groups(B, sms), G, float(sigma), w, math.sqrt(w) * N, math.sqrt(w),
        math.sqrt(2.0 * w), 1.0 / N, threads, dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
        # Imported here: train.profiling imports kernels.ops, which imports
        # this module.
        from dpdist_tpu_torch.train.profiling import span

        (points,) = ctx.saved_tensors
        threedmfv_kernel.replays += 1
        with span("threedmfv.replay"), torch.enable_grad():
            p = points.detach().requires_grad_(True)
            fv = threedmfv_plain(p, *ctx.args)
            (dpoints,) = torch.autograd.grad(fv, p, grad_fv)
        return dpoints, None, None


def threedmfv_kernel(points, n_gaussians: int = 512, sigma: float = 0.125):
    """(B, N, 3) float32 contiguous points -> (B, G, 20) float32 normalised
    full 3DmFV; differentiable in points (see the module docstring)."""
    _check(points, n_gaussians)
    if not (torch.is_grad_enabled() and points.requires_grad):
        return _threedmfv_impl(points, n_gaussians, sigma)
    return _ThreeDmFV.apply(points, n_gaussians, sigma)


threedmfv_kernel.launches = 0
threedmfv_kernel.replays = 0
