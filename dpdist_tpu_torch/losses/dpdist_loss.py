"""The frozen DPDist distance as a differentiable loss (port of
dpdist_tpu/losses/dpdist_loss.py).

    loss_fn = make_frozen_dpdist_loss(params, cfg)
    loss = loss_fn(pcA, pcB)          # scalar; gradients reach the clouds

The parameters never receive a gradient: loss_fn detaches them on every
call, so differentiating a composition that contains them leaves their
`.grad` untouched.
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.models.dpdist import dpdist_distance, resolve_for_grad


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach()


def make_frozen_dpdist_loss(params, cfg: DPDistConfig, *, out_of_grid_penalty: float = 1.0):
    """Return loss_fn(pcA, pcB) -> scalar, closed over frozen params.

    The distance runs with fused_gather resolved for a gradient context
    (`resolve_for_grad`: the table-gather kernels on the card).

    out_of_grid_penalty: DPDist zeroes predictions for query points outside
    the [-1, 1] grid, which makes "push the cloud out of the grid" a
    degenerate minimum of the loss. The barrier
    penalty * (mean(relu(|pcA| - 1)) + mean(relu(|pcB| - 1))) keeps an
    optimisation inside the grid without touching in-grid gradients. Set
    0 for the raw reference semantics.
    """

    def loss_fn(pcA, pcB):
        gcfg = resolve_for_grad(cfg, pcA.device)
        d = dpdist_distance(_detached(params), gcfg, pcA, pcB)
        if out_of_grid_penalty > 0:
            def barrier(pc):
                return torch.mean(torch.relu(torch.abs(pc) - 1.0))

            d = d + out_of_grid_penalty * (barrier(pcA) + barrier(pcB))
        return d

    return loss_fn
