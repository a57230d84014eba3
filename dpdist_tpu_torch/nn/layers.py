"""Functional layers of the DPDist decoder, the autoencoders and the PCRNet
policy (port of dpdist_tpu/nn/layers.py): dense, conv2d / conv3d and the
transposed conv2d, max and average pools, BatchNorm, dropout, the MLP.

Parameters keep the JAX package's layout: a dense layer is {"w": (in, out),
"b": (out,)} and computes `x @ w + b`; a conv is {"w": DHWIO or HWIO,
"b": (out,)} over channels-last inputs (B, D, H, W, C) or (B, H, W, C).
The decoder runs in float32 with TF32 off (set when the package is
imported, for matmuls and cuDNN), or in bfloat16 when asked: then params
and x are cast to bfloat16, each product accumulates in float32 and
rounds to bfloat16, as the reference's composed bf16 decoder
(dpdist_tpu/models/dpdist.py:448-463).

Padding follows XLA: "SAME" gives ceil(size / stride) outputs and puts the
odd cell of padding at the high end; "VALID" pads nothing. The convs run
F.conv3d / F.conv2d on permuted tensors after explicit padding (a
cross-correlation, as lax.conv_general_dilated). The transposed conv is
lax.conv_transpose without transpose_kernel: the input dilated by the
stride, padded as XLA pads it, and correlated with the kernel as given
(no flip, no swap of its channel axes).

BatchNorm is functional, state in and state out: `momentum` is the EMA
decay, eps 1e-3, and the variance is the biased one over every axis but
the last (tf.contrib.layers.batch_norm's), so torch.nn.BatchNorm is not
used.

Initialisation follows TF's xavier_initializer as the reference does
(uniform on +-sqrt(6 / (fan_in + fan_out)), zero biases; a conv's fans
span its receptive field), drawn from an explicit torch.Generator. The
numbers differ from JAX's for the same seed; parity tests carry
JAX-initialised weights across instead.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def params_to_device(params, device, requires_grad: bool = False):
    """The tree with every leaf (numpy array or tensor) as a float32 tensor
    on `device`, a fresh contiguous copy (a leaf of autograd with
    requires_grad); None stays None. Contiguous, whatever the source's
    order (a checkpoint may hold a leaf in Fortran order), because the
    optimizer's fused Adam kernel updates the leaves in place as dense
    vectors."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: params_to_device(v, device, requires_grad) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_device(v, device, requires_grad) for v in params]
    if isinstance(params, torch.Tensor):
        t = params.detach().to(device, torch.float32).clone(memory_format=torch.contiguous_format)
    else:
        t = torch.from_numpy(np.array(params, np.float32, order="C")).to(device)
    return t.requires_grad_(requires_grad)


def xavier_uniform(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """U(-limit, limit), limit = sqrt(6 / (fan_in + fan_out)), float32 on the CPU."""
    limit = math.sqrt(6.0 / float(fan_in + fan_out))
    return torch.empty(shape, dtype=torch.float32).uniform_(-limit, limit, generator=generator)


def truncated_normal(shape, stddev: float, generator=None) -> torch.Tensor:
    """stddev * N(0, 1) truncated to [-2, 2], float32 on the CPU."""
    t = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator) * stddev


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(in_dim: int, out_dim: int, *, conv_fan: Tuple[int, int] | None = None,
               generator=None) -> dict:
    """{"w": (in, out), "b": zeros(out)}. conv_fan overrides the fans with
    those of a TF [1, W] conv over one channel (fan_in = W*C_in,
    fan_out = W*C_out), as the reference's first decoder layer was."""
    fan_in, fan_out = conv_fan if conv_fan is not None else (in_dim, out_dim)
    return {"w": xavier_uniform((in_dim, out_dim), fan_in, fan_out, generator),
            "b": torch.zeros(out_dim, dtype=torch.float32)}


def dense_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b. Operands of two dtypes meet in the wider one, as jnp.matmul
    promotes them (a float32 activation after an eval-mode BN of a bf16
    decoder meets bf16 weights)."""
    w = params["w"]
    if w.dtype != x.dtype:
        dt = torch.promote_types(w.dtype, x.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w) + params["b"]


# ---------------------------------------------------------------------------
# Convolutions (channels-last, XLA padding)
# ---------------------------------------------------------------------------

def _same_pads(sizes, window, stride):
    """XLA's SAME padding per spatial dim: (low, high), the odd cell high."""
    pads = []
    for n, k, s in zip(sizes, window, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_spatial(x_cf: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims of a channels-first tensor; pads per dim, in order."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x_cf
    return F.pad(x_cf, flat, value=value)


def _pads(x_cf, window, stride, padding):
    if padding == "SAME":
        return _same_pads(x_cf.shape[2:], window, stride)
    if padding == "VALID":
        return [(0, 0)] * len(window)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _conv(params, x, stride, padding, conv):
    nd = x.dim() - 2
    w = params["w"]
    x_cf = torch.movedim(x, -1, 1)
    w_oi = w.permute(nd + 1, nd, *range(nd))            # (..., I, O) -> (O, I, ...)
    x_cf = _pad_spatial(x_cf, _pads(x_cf, w.shape[:nd], stride, padding))
    if x_cf.dtype == torch.float16 and x_cf.device.type == "cpu":
        # PyTorch's float16 conv on the CPU is a reference loop (its
        # backward takes minutes at the conv decoder's width): the float32
        # conv of the float16 values, rounded once, is a float16 conv that
        # accumulates in float32, as cuDNN's on the card.
        y = conv(x_cf.float(), w_oi.float(), stride=tuple(stride)).to(torch.float16)
    else:
        y = conv(x_cf, w_oi, stride=tuple(stride))
    return torch.movedim(y, 1, -1) + params["b"]


def conv3d_init(in_ch: int, out_ch: int, kernel: Tuple[int, int, int], generator=None) -> dict:
    """{"w": (kd, kh, kw, in, out) DHWIO, "b": zeros(out)}, xavier over the
    receptive field."""
    rf = math.prod(kernel)
    return {"w": xavier_uniform(tuple(kernel) + (in_ch, out_ch), rf * in_ch, rf * out_ch,
                                generator),
            "b": torch.zeros(out_ch, dtype=torch.float32)}


def conv3d_apply(params, x: torch.Tensor, *, stride: Tuple[int, int, int] = (1, 1, 1),
                 padding: str = "SAME") -> torch.Tensor:
    """x: (B, D, H, W, C) -> (B, D', H', W', C')."""
    return _conv(params, x, stride, padding, F.conv3d)


def conv2d_init(in_ch: int, out_ch: int, kernel: Tuple[int, int], generator=None) -> dict:
    """{"w": (kh, kw, in, out) HWIO, "b": zeros(out)}, xavier over the
    receptive field (tf_util.conv2d)."""
    rf = math.prod(kernel)
    return {"w": xavier_uniform(tuple(kernel) + (in_ch, out_ch), rf * in_ch, rf * out_ch,
                                generator),
            "b": torch.zeros(out_ch, dtype=torch.float32)}


def conv2d_apply(params, x: torch.Tensor, *, stride: Tuple[int, int] = (1, 1),
                 padding: str = "SAME") -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H', W', C')."""
    return _conv(params, x, stride, padding, F.conv2d)


def _conv_transpose_pads(k: int, s: int, padding: str):
    """lax.conv_transpose's padding of the dilated input for one dim."""
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return lo, total - lo


def conv2d_transpose_apply(params, x: torch.Tensor, *, stride: Tuple[int, int] = (2, 2),
                           padding: str = "SAME") -> torch.Tensor:
    """Transposed conv with conv2d_init's params (HWIO, I = x's channels):
    x (B, H, W, C) -> (B, H * s, W * s, out) with SAME. As
    lax.conv_transpose(transpose_kernel=False): the input dilated by the
    stride (s - 1 zeros between cells), padded, and correlated with the
    kernel as it is; torch's conv_transpose2d would flip it and swap its
    channel axes."""
    w = params["w"]
    kh, kw = w.shape[:2]
    x_cf = torch.movedim(x, -1, 1)
    B, C, H, W = x_cf.shape
    sh, sw = stride
    dil = x_cf.new_zeros((B, C, (H - 1) * sh + 1, (W - 1) * sw + 1))
    dil[:, :, ::sh, ::sw] = x_cf
    pads = [_conv_transpose_pads(kh, sh, padding), _conv_transpose_pads(kw, sw, padding)]
    y = F.conv2d(_pad_spatial(dil, pads), w.permute(3, 2, 0, 1))
    return torch.movedim(y, 1, -1) + params["b"]


# ---------------------------------------------------------------------------
# Pools (channels-last, XLA padding)
# ---------------------------------------------------------------------------

_POOLS = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}


def _pool(x, window, stride, padding, *, op, count_include_pad=False):
    """Max pads with -inf; avg divides each window's sum by its count of
    in-bounds cells, as the reference's helper, or with count_include_pad
    by the window's size (the padded zeros count, as the inception blocks'
    reduce_window(add) / 27)."""
    nd = len(window)
    max_pool, avg_pool = _POOLS[nd]
    x_cf = torch.movedim(x, -1, 1)
    pads = _pads(x_cf, window, stride, padding)
    if op == "max":
        y = max_pool(_pad_spatial(x_cf, pads, float("-inf")), window, stride)
        return torch.movedim(y, 1, -1)
    s = avg_pool(_pad_spatial(x_cf, pads), window, stride, divisor_override=1)
    if padding == "VALID" or count_include_pad:
        y = s / float(math.prod(window))
    else:
        ones = _pad_spatial(torch.ones_like(x_cf[:1, :1]), pads)
        y = s / avg_pool(ones, window, stride, divisor_override=1)
    return torch.movedim(y, 1, -1)


def max_pool2d(x, window=(2, 2), *, stride=None, padding="VALID"):
    """(B, H, W, C) max pool (tf_util.max_pool2d)."""
    return _pool(x, window, stride or window, padding, op="max")


def avg_pool2d(x, window=(2, 2), *, stride=None, padding="VALID"):
    """(B, H, W, C) average pool (tf_util.avg_pool2d)."""
    return _pool(x, window, stride or window, padding, op="avg")


def max_pool3d(x, window=(2, 2, 2), *, stride=None, padding="VALID"):
    """(B, D, H, W, C) max pool (tf_util.max_pool3d)."""
    return _pool(x, window, stride or window, padding, op="max")


def avg_pool3d(x, window=(2, 2, 2), *, stride=None, padding="VALID",
               count_include_pad: bool = False):
    """(B, D, H, W, C) average pool (tf_util.avg_pool3d)."""
    return _pool(x, window, stride or window, padding, op="avg",
                 count_include_pad=count_include_pad)


# ---------------------------------------------------------------------------
# BatchNorm (feature axis last, EMA running statistics)
# ---------------------------------------------------------------------------

def batchnorm_init(dim: int):
    """(params {"scale": ones, "offset": zeros}, state {"mean": zeros, "var": ones})."""
    params = {"scale": torch.ones(dim, dtype=torch.float32),
              "offset": torch.zeros(dim, dtype=torch.float32)}
    state = {"mean": torch.zeros(dim, dtype=torch.float32),
             "var": torch.ones(dim, dtype=torch.float32)}
    return params, state


def batch_moments(x: torch.Tensor):
    """Mean and biased variance over every axis but the last, computed in
    float32 and returned in x's dtype (jnp.mean and jnp.var upcast a bf16
    input so)."""
    axes = tuple(range(x.dim() - 1))
    xf = x.float()
    mean = torch.mean(xf, dim=axes)
    var = torch.mean(torch.square(xf - mean), dim=axes)
    return mean.to(x.dtype), var.to(x.dtype)


def batchnorm_apply(params, state, x: torch.Tensor, *, train: bool, momentum=0.9,
                    eps: float = 1e-3):
    """Normalise over every axis but the last; returns (y, new_state).

    train=True: the batch's mean and biased variance normalise x, and the
    new state is their EMA with decay `momentum` (the reference's bn_decay),
    detached from autograd; else the running statistics normalise and the
    state is returned as it is. params None normalises without scale and
    offset."""
    if train:
        mean, var = batch_moments(x)
        new_state = {"mean": (momentum * state["mean"] + (1.0 - momentum) * mean).detach(),
                     "var": (momentum * state["var"] + (1.0 - momentum) * var).detach()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps)
    if params is not None:
        y = y * params["scale"] + params["offset"]
    return y, new_state


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def dropout(generator, x: torch.Tensor, keep_prob: float, *, train: bool) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability keep_prob and
    scale it by 1 / keep_prob (tf_util.dropout). The mask comes from an
    explicit torch.Generator on x's device; its bits differ from JAX's for
    the same seed."""
    if not train or keep_prob >= 1.0:
        return x
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# MLP (dense chain with ReLU, optional BN)
# ---------------------------------------------------------------------------

def mlp_init(in_dim: int, widths: Sequence[int], *, conv_fan_first=None,
             use_bn: bool = False, generator=None) -> dict:
    """A stack of dense layers; widths includes the output layer. With
    use_bn, params["bn"] holds each layer's BN scale and offset; its
    running statistics come from mlp_bn_state."""
    layers, bn, d = [], [], in_dim
    for i, w in enumerate(widths):
        layers.append(dense_init(d, w, conv_fan=conv_fan_first if i == 0 else None,
                                 generator=generator))
        if use_bn:
            bn.append(batchnorm_init(w)[0])
        d = w
    return {"layers": layers, "bn": bn} if use_bn else {"layers": layers}


def mlp_bn_state(params) -> dict:
    """The initial BN state {"bn": [{"mean", "var"}, ...]} of a BN MLP."""
    return {"bn": [batchnorm_init(lp["b"].shape[0])[1] for lp in params["layers"]]}


def mlp_apply(params, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ReLU after every layer but the last, which is linear. With dtype
    bfloat16 or float16, params and x are cast to it and the result is in
    it (the caller casts it back to float32). An MLP with BN runs through
    mlp_apply_bn, which carries its state."""
    if "bn" in params:
        raise ValueError("an MLP with BatchNorm carries a state: use mlp_apply_bn")
    layers = params["layers"]
    if dtype != torch.float32:
        layers = [{k: t.to(dtype) for k, t in lp.items()} for lp in layers]
        x = x.to(dtype)
    for i, lp in enumerate(layers):
        x = dense_apply(lp, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def mlp_apply_bn(params, state, x: torch.Tensor, *, train: bool = False, bn_momentum=0.9,
                 final_activation=None):
    """The BN MLP: dense, BN, then ReLU on every layer but the last, which
    gets BN and final_activation (None = linear), as tf_util.conv2d orders
    them. Returns (y, new_state). The layers compute in their params' and
    x's dtypes as JAX promotes them: a bf16 or fp16 decoder (params and x
    cast by the caller) stays in its dtype in training; in eval the float32 running
    statistics lift the activations to float32 after the first BN."""
    layers = params["layers"]
    new_bn = []
    for i, (lp, bp, bs) in enumerate(zip(layers, params["bn"], state["bn"])):
        x, s = batchnorm_apply(bp, bs, dense_apply(lp, x), train=train, momentum=bn_momentum)
        new_bn.append(s)
        if i < len(layers) - 1:
            x = torch.relu(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x, {"bn": new_bn}
