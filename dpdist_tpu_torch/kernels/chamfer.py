"""Nearest-neighbour squared distances streamed over tiles, and the chamfer
distance built on them.

Port of dpdist_tpu/kernels/chamfer_pallas.py (`nn_min_sqdist_pallas`, TPU
kernel `_min_kernel`, and `chamfer_distance_pallas`). The CUDA kernel is
dpdist_tpu_torch/csrc/chamfer.cu; its header says what bounds it on an
H100 and how the design fills the card at one large cloud.

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
launches (one per call, whatever the number of splits), and nothing else.
Like the reference, the kernel has no backward: an input that requires a
gradient while grad mode is on raises, rather than yield a silent zero.
"""

from __future__ import annotations

import torch

THREADS = 256
# The grid aims at about this many blocks per SM (chamfer.cu splits M to
# get there) and gives each split at least MIN_SPLIT_POINTS points of p.
BLOCKS_PER_SM = 2
MIN_SPLIT_POINTS = 256
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


def splits_for(B: int, N: int, M: int, sm_count: int, points_per_block: int) -> int:
    """How many parts M is split into, so that the grid holds about
    BLOCKS_PER_SM blocks per SM without splits below MIN_SPLIT_POINTS."""
    blocks = B * -(-N // points_per_block)
    want = -(-BLOCKS_PER_SM * sm_count // blocks)
    return max(1, min(want, -(-M // MIN_SPLIT_POINTS)))


def nn_min_sqdist(a, p):
    """(B, N, 3), (B, M, 3) float32 contiguous -> (B, N) squared distance of
    each point of a to its nearest point of p; see the module docstring."""
    _check(a, p)
    dev = a.device
    if dev.type == "cpu":
        return nn_min_sqdist_plain(a, p)

    from dpdist_tpu_torch.kernels import build

    lib = build.library()
    B, N, _ = a.shape
    M = p.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = splits_for(B, N, M, sms, lib.dpdist_nn_min_points_per_block(THREADS))
    dist = torch.empty((B, N), dtype=torch.float32, device=dev)
    partial = torch.empty((B, splits, N) if splits > 1 else (0,), dtype=torch.float32,
                          device=dev)
    err = lib.dpdist_nn_min_sqdist(a.data_ptr(), p.data_ptr(), dist.data_ptr(),
                                   partial.data_ptr(), B, N, M, splits, THREADS, dev.index,
                                   torch.cuda.current_stream(dev).cuda_stream)
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
