"""Dense layers of the DPDist decoder (port of dense_apply and mlp_apply
with BN off, dpdist_tpu/nn/layers.py:65-66 and :237-269).

Parameters keep the JAX package's layout: a dense layer is {"w": (in, out),
"b": (out,)} and computes `x @ w + b`. The decoder runs in float32 with
TF32 off (set when the package is imported).
"""

from __future__ import annotations

import torch


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
