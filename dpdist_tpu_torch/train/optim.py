"""The optimizer of DPDist training (port of make_optimizer,
dpdist_tpu/train/optim.py, which chains optax transformations).

Same order as the reference's optax chain:
  1. weight decay (when set): g += weight_decay * p on dense kernels ("w")
     only, not on biases;
  2. global-norm clipping (when grad_clip > 0): g *= grad_clip / ||g||
     where ||g|| >= grad_clip;
  3. Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) or momentum SGD
     (trace = g + momentum * trace);
  4. p -= lr(count) * update, with the staircase LR and its floor
     evaluated at the update count before it increments, so the first
     step uses lr(0).

Parameters are nested dicts and lists of tensors in the JAX layout; the
optimizer updates them in place (under no_grad), which keeps the leaves
that autograd tracks.
"""

from __future__ import annotations

import numpy as np
import torch

from dpdist_tpu_torch.configs import TrainConfig
from dpdist_tpu_torch.nn.schedules import staircase_lr
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    def __init__(self, cfg: TrainConfig, *, base_lr: float | None = None):
        if cfg.optimizer not in ("adam", "momentum"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg
        self.lr = staircase_lr(base_lr if base_lr is not None else cfg.learning_rate,
                               cfg.decay_step, cfg.decay_rate, cfg.lr_floor)

    def init(self, params) -> dict:
        """Zero moments (Adam) or trace (momentum), count 0."""
        leaves = [t for _, t in tree_flatten_with_paths(params)]
        keys = ("mu", "nu") if self.cfg.optimizer == "adam" else ("trace",)
        return {"count": 0, **{key: [torch.zeros_like(t) for t in leaves] for key in keys}}

    @torch.no_grad()
    def step(self, params, grads, state) -> dict:
        """Apply one update to `params` in place; `grads` are in the order
        of tree_flatten_with_paths(params). Returns the new state."""
        cfg = self.cfg
        flat = tree_flatten_with_paths(params)
        g = list(grads)
        if cfg.weight_decay > 0:
            g = [gi + cfg.weight_decay * p if "w" in path.split("/") else gi
                 for gi, (path, p) in zip(g, flat)]
        if cfg.grad_clip > 0:
            norm = torch.sqrt(sum(torch.sum(gi * gi) for gi in g))
            g = [torch.where(norm < cfg.grad_clip, gi, gi / norm * cfg.grad_clip) for gi in g]
        count = state["count"]
        lr = self.lr(count)
        if cfg.optimizer == "adam":
            mu = [(1 - B1) * gi + B1 * m for gi, m in zip(g, state["mu"])]
            nu = [(1 - B2) * gi * gi + B2 * v for gi, v in zip(g, state["nu"])]
            c1, c2 = (float(np.float32(1) - np.power(np.float32(b), np.float32(count + 1),
                                                     dtype=np.float32)) for b in (B1, B2))
            for (_, p), m, v in zip(flat, mu, nu):
                p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + EPS)))
            return {"count": count + 1, "mu": mu, "nu": nu}
        trace = [gi + cfg.momentum * t for gi, t in zip(g, state["trace"])]
        for (_, p), t in zip(flat, trace):
            p.sub_(lr * t)
        return {"count": count + 1, "trace": trace}


def make_optimizer(cfg: TrainConfig, *, base_lr: float | None = None) -> Optimizer:
    return Optimizer(cfg, base_lr=base_lr)
