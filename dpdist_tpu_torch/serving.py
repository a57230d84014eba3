"""Serving: the frozen learned distance as an nn.Module (port of the forward
semantics of dpdist_tpu/serving.py:export_frozen_distance).

    model = load_frozen_distance("results/ckpt_best")        # on the card
    d = model(pcA, pcB)                                        # (B,) distances

    # bfloat16 serving through the fused gather + decoder kernel:
    model = load_frozen_distance("results/ckpt_best", dtype="bfloat16",
                                 fused_gather="full")

The module maps a (template, source) pair of (B, N, 3) clouds to the
per-pair learned distance `dpdist_distance(per_example=True)`. It is in
eval mode and every parameter has requires_grad=False. It is
differentiable in its input clouds: when an input requires a gradient,
fused_gather resolves for a gradient context (models.resolve_for_grad:
the table-gather kernels on the card), and the parameters' .grad stays
None. A bfloat16 config is forward only: under autograd it raises
NotImplementedError rather than run another path.
"""

from __future__ import annotations

import torch
from torch import nn

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.fused_forward import pack_decoder
from dpdist_tpu_torch.models.dpdist import (
    check_ported,
    dpdist_distance,
    resolve_for_grad,
    resolve_mode,
)
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax


class FrozenDistance(nn.Module):
    """The learned DPDist distance with frozen decoder weights.

    Weights keep the JAX (in, out) layout: layer i computes x @ w_i + b_i.
    A config whose forward takes "full" (bfloat16, and a decoder and grid
    the fused kernel takes: models.dpdist.resolve_mode) also holds the
    decoder packed once for the fused kernel
    (kernels.fused_forward.pack_decoder), on the parameters' device.
    """

    def __init__(self, cfg: DPDistConfig, params: dict):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.w = nn.ParameterList(
            nn.Parameter(lp["w"], requires_grad=False) for lp in params["decoder"]["layers"])
        self.b = nn.ParameterList(
            nn.Parameter(lp["b"], requires_grad=False) for lp in params["decoder"]["layers"])
        self.packed = None
        layers = params["decoder"]["layers"]
        if resolve_mode(cfg, layers[0]["w"].device.type) == "full":
            self.packed = pack_decoder(layers)

    def params(self) -> dict:
        p = {"decoder": {"layers": [{"w": w, "b": b} for w, b in zip(self.w, self.b)]}}
        if self.packed is not None:
            p["packed"] = self.packed
        return p

    def forward(self, pcA: torch.Tensor, pcB: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if torch.is_grad_enabled() and (pcA.requires_grad or pcB.requires_grad):
            cfg = resolve_for_grad(cfg, pcA.device)
        return dpdist_distance(self.params(), cfg, pcA, pcB, per_example=True)


def load_frozen_distance(ckpt_path: str, device="cuda", **cfg_overrides) -> FrozenDistance:
    """Load `<ckpt_path>.npz/.json` into a FrozenDistance on `device`.

    `cfg_overrides` replace fields of the checkpoint's config (for example
    fused_gather="off" for the plain composition). Raises without a card
    when `device` is CUDA.
    """
    dev = resolve_device(device)
    cfg, np_params = load_dpdist_checkpoint(ckpt_path)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    model = FrozenDistance(cfg, params_from_jax(np_params, dev))
    return model.eval()
