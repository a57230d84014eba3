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

Adam's steps 3 and 4 take their path from the device: on the CPU, the
list path of PyTorch ops (adam_leaf_plain), which makes new moments; on
CUDA, one launch of the fused kernel (kernels.fused_adam) for all the
leaves, which updates them and their moments in place, bit for bit as the
list path would, and raises on a leaf it does not take (not float32, or
not contiguous and 16-byte aligned). On every device the state handed to
`step` is spent: read only the state it returns. Weight decay and
clipping build the gradients with PyTorch ops first.
"""

from __future__ import annotations

import numpy as np
import torch

from dpdist_tpu_torch.configs import TrainConfig
from dpdist_tpu_torch.kernels.fused_adam import fused_adam
from dpdist_tpu_torch.nn.schedules import staircase_lr
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_leaf_plain(p, g, m, v, lr, c1, c2):
    """Adam on one leaf by PyTorch ops, each rounding once in float32
    (optax's order): returns the new (mu, nu); p is updated in place. The
    optimizer's path on the CPU and the fused kernel's oracle on the card."""
    mu = (1 - B1) * g + B1 * m
    nu = (1 - B2) * g * g + B2 * v
    p.sub_(lr * ((mu / c1) / (torch.sqrt(nu / c2) + EPS)))
    return mu, nu


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
        of tree_flatten_with_paths(params). Returns the new state; the
        state passed in is spent (on CUDA its moments are updated in place)."""
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
            c1, c2 = (float(np.float32(1) - np.power(np.float32(b), np.float32(count + 1),
                                                     dtype=np.float32)) for b in (B1, B2))
            ps = [p for _, p in flat]
            if ps and ps[0].is_cuda:
                fused_adam(ps, g, state["mu"], state["nu"], lr, c1, c2, B1, B2, EPS)
                mu, nu = list(state["mu"]), list(state["nu"])
            else:
                new = [adam_leaf_plain(p, gi, m, v, lr, c1, c2)
                       for p, gi, m, v in zip(ps, g, state["mu"], state["nu"])]
                mu, nu = [m for m, _ in new], [v for _, v in new]
            return {"count": count + 1, "mu": mu, "nu": nu}
        trace = [gi + cfg.momentum * t for gi, t in zip(g, state["trace"])]
        for (_, p), t in zip(flat, trace):
            p.sub_(lr * t)
        return {"count": count + 1, "trace": trace}


def make_optimizer(cfg: TrainConfig, *, base_lr: float | None = None) -> Optimizer:
    return Optimizer(cfg, base_lr=base_lr)
