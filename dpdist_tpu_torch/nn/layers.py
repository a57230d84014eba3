"""Dense layers of the DPDist decoder and the PCRNet policy (port of
xavier_uniform, dense_init, dense_apply, dropout, mlp_init and mlp_apply with
BN off, dpdist_tpu/nn/layers.py).

Parameters keep the JAX package's layout: a dense layer is {"w": (in, out),
"b": (out,)} and computes `x @ w + b`. The decoder runs in float32 with
TF32 off (set when the package is imported), or in bfloat16 when asked:
then params and x are cast to bfloat16, each product accumulates in
float32 and rounds to bfloat16, as the reference's composed bf16 decoder
(dpdist_tpu/models/dpdist.py:448-463).

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


def dropout(generator, x: torch.Tensor, keep_prob: float, *, train: bool) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability keep_prob and
    scale it by 1 / keep_prob (tf_util.dropout). The mask comes from an
    explicit torch.Generator on x's device; its bits differ from JAX's for
    the same seed."""
    if not train or keep_prob >= 1.0:
        return x
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


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


def mlp_apply(params, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ReLU after every layer but the last, which is linear. With dtype
    bfloat16, params and x are cast to it and the result is bfloat16 (the
    caller casts it back to float32). BatchNorm is not ported yet and
    raises."""
    if "bn" in params:
        raise NotImplementedError("BatchNorm in the MLP is not ported yet")
    layers = params["layers"]
    if dtype != torch.float32:
        layers = [{k: t.to(dtype) for k, t in lp.items()} for lp in layers]
        x = x.to(dtype)
    for i, lp in enumerate(layers):
        x = dense_apply(lp, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x
