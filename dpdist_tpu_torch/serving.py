"""Serving: the frozen learned distance as an nn.Module (port of the forward
semantics of dpdist_tpu/serving.py:export_frozen_distance).

    model = load_frozen_distance("results/ckpt_best")        # on the card
    d = model(pcA, pcB)                                        # (B,) distances

The module maps a (template, source) pair of (B, N, 3) clouds to the
per-pair learned distance `dpdist_distance(per_example=True)`. It is in
eval mode and every parameter has requires_grad=False. It is
differentiable in its input clouds: when an input requires a gradient,
fused_gather resolves for a gradient context (models.resolve_for_grad:
the table-gather kernels on the card), and the parameters' .grad stays
None.
"""

from __future__ import annotations

import torch
from torch import nn

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.models.dpdist import check_ported, dpdist_distance, resolve_for_grad
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax


class FrozenDistance(nn.Module):
    """The learned DPDist distance with frozen decoder weights.

    Weights keep the JAX (in, out) layout: layer i computes x @ w_i + b_i.
    """

    def __init__(self, cfg: DPDistConfig, params: dict):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.w = nn.ParameterList(
            nn.Parameter(lp["w"], requires_grad=False) for lp in params["decoder"]["layers"])
        self.b = nn.ParameterList(
            nn.Parameter(lp["b"], requires_grad=False) for lp in params["decoder"]["layers"])

    def params(self) -> dict:
        return {"decoder": {"layers": [{"w": w, "b": b} for w, b in zip(self.w, self.b)]}}

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
