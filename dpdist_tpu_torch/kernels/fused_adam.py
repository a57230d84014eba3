"""Adam's update of a step's parameter leaves in one pass (train/optim.py).

The CUDA kernel is dpdist_tpu_torch/csrc/fused_adam.cu; its header says
what bounds it on an H100 (bytes: 28 a weight) and how the design meets
that: one launch for all the leaves, their table passed by value as
kernel parameters, a block for each chunk of 4,096 weights in 16-byte
vectors. It replaces no
TPU kernel (the JAX package leaves Adam to optax): the optimizer's list
path, 14 PyTorch ops a leaf (optim.adam_leaf_plain, which stays the
optimizer's path on the CPU and is the kernel's oracle on the card),
moved about 33 tensor widths a step.

    fused_adam(ps, gs, ms, vs, lr, c1, c2, b1, b2, eps)
        Adam on every leaf, p, m and v all in place, by the kernel: equal
        to the list path bit for bit on the card.

It takes CUDA float32 leaves on one card whose p, m and v are contiguous
and 16-byte aligned; a float32 gradient that is not (autograd hands back
a conv weight's gradient as a permuted view; data parallelism's as a view
into one flat buffer) is copied into a new contiguous tensor first. Any
other leaf raises: there is no fallback. The writes go through raw
pointers, so the wrapper bumps the version counters of p, m and v as an
in-place op would, and autograd still refuses a graph that saved them
before the update. `fused_adam.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch


def _dense(t) -> bool:
    """float32, contiguous and 16-byte aligned: the kernel's 16-byte vectors fit."""
    return t.dtype == torch.float32 and t.is_contiguous() and t.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=1)
def _max_leaves() -> int:
    from dpdist_tpu_torch.kernels import build

    return build.library().dpdist_fused_adam_max_leaves()


def fused_adam(ps, gs, ms, vs, lr, c1, c2, b1, b2, eps):
    """Update the leaves ps (and their moments ms, vs) in place from the
    gradients gs; the scalars are host floats, rounded to float32 as
    PyTorch rounds a Python scalar (1 / c1 and 1 / c2 too: PyTorch divides
    by a scalar by multiplying with its float reciprocal)."""
    leaves = list(zip(ps, gs, ms, vs))
    if not leaves:
        return
    dev = leaves[0][0].device
    for p, g, m, v in leaves:
        if (dev.type != "cuda" or any(t.device != dev for t in (p, g, m, v))
                or g.dtype != torch.float32 or not all(_dense(t) for t in (p, m, v))):
            raise ValueError("fused_adam takes CUDA float32 leaves on one card, p, m and v "
                             "contiguous and 16-byte aligned")
        if not p.numel() == g.numel() == m.numel() == v.numel():
            raise ValueError("fused_adam: a leaf's p, g, m and v differ in size")
    work = [(p, g if _dense(g) else g.clone(memory_format=torch.contiguous_format), m, v)
            for p, g, m, v in leaves if p.numel()]
    if not work:
        return
    from dpdist_tpu_torch.kernels import build

    lib = build.library()
    n = len(work)
    ptrs = [(ctypes.c_void_p * n)(*(q[j].data_ptr() for q in work)) for j in range(4)]
    sizes = (ctypes.c_int64 * n)(*(q[0].numel() for q in work))
    f32 = np.float32
    err = lib.dpdist_fused_adam(
        *ptrs, sizes, n, f32(lr), f32(1 - b1), f32(b1), f32(1 - b2), f32(b2),
        f32(1) / f32(c1), f32(1) / f32(c2), f32(eps), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "fused_adam")
    fused_adam.launches += -(-n // _max_leaves())
    for p, _, m, v in work:
        for t in (p, m, v):
            torch.autograd.graph.increment_version(t)


fused_adam.launches = 0
