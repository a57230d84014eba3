"""Dense layers of the DPDist decoder (port of xavier_uniform, dense_init,
dense_apply, mlp_init and mlp_apply with BN off, dpdist_tpu/nn/layers.py).

Parameters keep the JAX package's layout: a dense layer is {"w": (in, out),
"b": (out,)} and computes `x @ w + b`. The decoder runs in float32 with
TF32 off (set when the package is imported).

Initialisation follows TF's xavier_initializer as the reference does
(uniform on +-sqrt(6 / (fan_in + fan_out)), zero biases), drawn from an
explicit torch.Generator. The numbers differ from JAX's for the same
seed; parity tests carry JAX-initialised weights across instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def xavier_uniform(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), float32 on the CPU."""
    limit = math.sqrt(6.0 / float(fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def dense_init(in_dim: int, out_dim: int, *, conv_fan: Tuple[int, int] | None = None,
               generator=None) -> dict:
    """{"w": (in, out), "b": zeros(out)}. conv_fan overrides the fans with
    those of a TF [1, W] conv over one channel (fan_in = W*C_in,
    fan_out = W*C_out), as the reference's first decoder layer was."""
    fan_in, fan_out = conv_fan if conv_fan is not None else (in_dim, out_dim)
    return {"w": xavier_uniform((in_dim, out_dim), fan_in, fan_out, generator),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def mlp_init(in_dim: int, widths: Sequence[int], *, conv_fan_first=None,
             use_bn: bool = False, generator=None) -> dict:
    """A stack of dense layers; widths includes the output layer."""
    if use_bn:
        raise NotImplementedError("BatchNorm in the MLP is not ported yet")
    layers, d = [], in_dim
    for i, w in enumerate(widths):
        layers.append(dense_init(d, w, conv_fan=conv_fan_first if i == 0 else None,
                                 generator=generator))
        d = w
    return {"layers": layers}


def dense_apply(params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, params["w"]) + params["b"]


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """ReLU after every layer but the last, which is linear. BatchNorm is
    not ported yet and raises."""
    if "bn" in params:
        raise NotImplementedError("BatchNorm in the MLP is not ported yet")
    layers = params["layers"]
    for i, lp in enumerate(layers):
        x = dense_apply(lp, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
