"""Nearest-neighbour squared distances streamed over tiles, and the chamfer
distance built on them.

Port of dpdist_tpu/kernels/chamfer_pallas.py (`nn_min_sqdist_pallas`, TPU
kernel `_min_kernel`, and `chamfer_distance_pallas`). The CUDA kernel is
dpdist_tpu_torch/csrc/chamfer.cu; its header says what bounds it on an
H100 (issue slots: 7 instructions a pair) and how the design meets that:
one launch over units of (cloud, tile of a, chunk of p) spread evenly over
the blocks the card holds at once (`plan_nn_min`), the chunks of p
bulk-copied into shared memory, and the units' minima merged by atomicMin.

    dist = nn_min_sqdist(a, p)
        (B, N, 3) + (B, M, 3) float32 -> (B, N) float32,
        dist[b, n] = min over m of the squared distance, summed per
        dimension; no N x M matrix.
    value = chamfer_distance_kernel(pc1, pc2, sqrt=True)
        both directions, sqrt(max(d, 1e-12)) when sqrt, then the mean of
        the two directions' means (chamfer_pallas.py:96-104).

On a CPU tensor nn_min_sqdist runs `nn_min_sqdist_plain`, which is also
the kernel's oracle on the card. On a CUDA tensor it launches the kernel
or raises; it never falls back. `nn_min_sqdist.launches` counts kernel
launches (one per call), and nothing else. Like the reference, the kernel
has no backward: an input that requires a gradient while grad mode is on
raises, rather than yield a silent zero.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

# The kernel's units (csrc/chamfer.cu): TILE_N points of a (4 warps of
# WARP_POINTS) against a chunk of at most MAX_CHUNK points of p, a multiple
# of 4 (the body's float4 groups).
TILE_N, MAX_CHUNK, WARP_POINTS = 1024, 1024, 256
# The plan's cost model, in cycles, fitted to the kernel's device times on
# an H100 over chunks of 4 to 1,024 points at four shapes (B, N, M = 1,
# 10,000, 10,000; 2, 1,000, 4,099; 256, 64, 64; 1, 1, 10,000): a warp
# issues 56 instructions a point of p (8 points of a, 7 a pair); a
# scheduler with several warps issues one every ISSUE_CYCLES, a warp alone
# one every LONE_CYCLES; each split of M adds ATOMIC_CYCLES a warp of a
# tile (its loads of a and its atomics, which meet at the same addresses).
POINT_INSTRUCTIONS, ISSUE_CYCLES, LONE_CYCLES, ATOMIC_CYCLES = 56, 1.2, 1.35, 5
# Rows of a per step of the plain version: bounds its (B, rows, M, 3)
# difference tensor to about 2^26 floats.
_PLAIN_FLOATS = 2 ** 26


def nn_min_sqdist_plain(a, p):
    """Plain PyTorch version: per-dimension squared differences summed over
    the last axis, then the minimum over p, in row chunks."""
    B, N, _ = a.shape
    rows = max(1, _PLAIN_FLOATS // (B * p.shape[1] * 3))
    parts = []
    for n0 in range(0, N, rows):
        diff = a[:, n0:n0 + rows, None, :] - p[:, None, :, :]
        parts.append(torch.sum(diff * diff, dim=-1).amin(dim=-1))
    return torch.cat(parts, dim=1)


def _check(a, p):
    for name, t in (("a", a), ("p", p)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3 or t.shape[1] < 1:
            raise ValueError(f"{name} must be (B, n, 3) with n >= 1, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape[0] != p.shape[0]:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} vs {tuple(p.shape)}")
    if a.device != p.device:
        raise ValueError(f"device mismatch: {a.device} vs {p.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nn_min_sqdist runs on cpu or cuda tensors, got {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or p.requires_grad):
        raise RuntimeError("nn_min_sqdist has no backward (nor has the TPU kernel): "
                           "call it under torch.no_grad() or on detached inputs")


@dataclasses.dataclass(frozen=True)
class NNMinPlan:
    """One launch: `tiles` tiles of TILE_N points of a per cloud, M cut
    into `splits` chunks of `chunk` points (the last may be shorter), so
    units = B * tiles * splits, unit u = (cloud, tile, chunk) in that
    order of significance; `grid` blocks, block i taking units i,
    i + grid, ..."""

    tiles: int
    splits: int
    chunk: int
    units: int
    grid: int


@functools.lru_cache(maxsize=64)
def plan_nn_min(B: int, N: int, M: int, sm_count: int, blocks_per_sm: int) -> NNMinPlan:
    """The chunk of p that the cost model says finishes first. An SM takes
    ceil(units / sm_count) units; their active warps (w a tile: a warp
    whose points all lie past N skips the unit) share its 4 schedulers, k
    each, and a scheduler runs its warps' loops in turn. Ties go to the
    longer chunk (fewer atomics). Only plans whose units the card holds at
    once compete, where the longest chunk gives one: a block that takes a
    second unit starts it after the others have ended theirs. The grid is
    the blocks the card holds at once, or one block a unit."""
    tiles = -(-N // TILE_N)
    w = -(-min(N, TILE_N) // WARP_POINTS)
    slots = sm_count * blocks_per_sm
    best = None
    for chunk in range(min(MAX_CHUNK, -(-M // 4) * 4), 0, -4):
        splits = -(-M // chunk)
        units = B * tiles * splits
        if units > slots and best is not None:
            break   # shorter chunks give still more units
        per_sm = -(-units // sm_count)
        k = -(-per_sm * w // 4)
        cost = (POINT_INSTRUCTIONS * chunk * max(ISSUE_CYCLES * k, LONE_CYCLES)
                + ATOMIC_CYCLES * w * splits)
        if best is None or cost < best[0]:
            best = (cost, NNMinPlan(tiles, splits, chunk, units, min(units, slots)))
    return best[1]


@functools.lru_cache(maxsize=8)
def sm_occupancy(index: int) -> tuple[int, int]:
    """(SM count, the kernel's blocks per SM) of card `index`."""
    from dpdist_tpu_torch.kernels import build

    per_sm = build.library().dpdist_nn_min_blocks_per_sm(index)
    if per_sm <= 0:
        raise RuntimeError(f"nn_min_sqdist: the occupancy query returned {per_sm}")
    return torch.cuda.get_device_properties(index).multi_processor_count, per_sm


def nn_min_sqdist(a, p):
    """(B, N, 3), (B, M, 3) float32 contiguous -> (B, N) squared distance of
    each point of a to its nearest point of p; see the module docstring."""
    _check(a, p)
    dev = a.device
    if dev.type == "cpu":
        return nn_min_sqdist_plain(a, p)

    from dpdist_tpu_torch.kernels import build

    B, N, _ = a.shape
    M = p.shape[1]
    plan = plan_nn_min(B, N, M, *sm_occupancy(dev.index))
    dist = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = build.library().dpdist_nn_min_sqdist(
        a.data_ptr(), p.data_ptr(), dist.data_ptr(), B, N, M, plan.tiles, plan.splits, plan.chunk,
        plan.grid, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "nn_min_sqdist")
    nn_min_sqdist.launches += 1
    return dist


nn_min_sqdist.launches = 0


def chamfer_distance_kernel(pc1, pc2, *, sqrt: bool = True):
    """Scalar chamfer distance over a batch through nn_min_sqdist, both
    directions (port of chamfer_distance_pallas)."""
    d1 = nn_min_sqdist(pc1, pc2)
    d2 = nn_min_sqdist(pc2, pc1)
    if sqrt:
        d1 = torch.sqrt(torch.clamp(d1, min=1e-12))
        d2 = torch.sqrt(torch.clamp(d2, min=1e-12))
    return (torch.mean(d1) + torch.mean(d2)) / 2.0
