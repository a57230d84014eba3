"""Plain reference of the DPDist training step at dpdist_3dmfv_k5_train: the
canonical net trained with its l1 loss and Adam, in plain PyTorch
(dahliau/DPDist train_multi_gpu_pc_compare_dist.py, the run
...LR0001wd0...distnoise0...).

  forward   the AB direction only: the points of pcB against the surface
            encoded from pcA, through the frozen reference's pieces
            (dpdist_3dmfv_k5.Net.predict: the 3DmFV, the cell and k^3 patch
            of each query, the MLP, relu6(y)/3 on channel 0, the mask);
  loss      mean |pred_AB - labels_AB|, the labels being each query's
            distance to the surface (0 for pcB's surface points);
  update    Adam (bias-corrected) at the staircase learning rate of the
            configuration, no weight decay, no clipping, no input noise.

Parameters are {key path: tensor} with the program's key paths
("decoder/layers/0/w", ...), a dense layer's weight in (in, out).
"""

from __future__ import annotations

import math

import torch

from portbench.reference.dpdist_3dmfv_k5 import Arith, Net


def leaf_shapes(cfg: dict) -> dict:
    """{param path: shape} of the net at `cfg`."""
    c = 2 + 6 * cfg["dims"] if cfg["full_fv"] else 1 + 2 * cfg["dims"]
    widths = ([cfg["dims"] + c * cfg["k"] ** cfg["dims"]] + list(cfg["mlp"])
              + [cfg["output_channels"]])
    shapes = {}
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        shapes[f"decoder/layers/{i}/w"], shapes[f"decoder/layers/{i}/b"] = (cin, cout), (cout,)
    return shapes


def head_bias(cfg: dict) -> str:
    return f"decoder/layers/{len(cfg['mlp'])}/b"


def learning_rate(cfg: dict, count: int) -> float:
    """The staircase schedule at update `count`: max(lr * rate^floor(count / step), floor)."""
    lr = cfg["learning_rate"] * cfg["lr_decay_rate"] ** math.floor(count / cfg["lr_decay_step"])
    return max(lr, cfg["lr_floor"])


def loss(cfg: dict, arith: Arith, params: dict, pcA, pcB, labels):
    net = Net(cfg, params, pcA.device)       # holds the leaves themselves
    return (net.predict(arith, pcA, pcB) - labels).abs().mean()


def train(cfg: dict, arith: Arith, params: dict, batches):
    """Adam steps on `batches` [(pcA, pcB, labels)], one each, from
    `params` (updated in place). Returns (losses, the norm of each leaf's
    first gradient {path: float})."""
    leaves = sorted(params)
    for p in leaves:
        params[p].requires_grad_(True)
    mu = {p: torch.zeros_like(params[p]) for p in leaves}
    nu = {p: torch.zeros_like(params[p]) for p in leaves}
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, first = [], None
    for t, (pcA, pcB, labels) in enumerate(batches, start=1):
        with arith:
            value = loss(cfg, arith, params, pcA, pcB, labels)
            grads = torch.autograd.grad(value, [params[p] for p in leaves])
        losses.append(float(value.detach()))
        if first is None:
            first = {p: float(torch.linalg.vector_norm(g)) for p, g in zip(leaves, grads)}
        lr = learning_rate(cfg, t - 1)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                mu[p].mul_(b1).add_((1 - b1) * g)
                nu[p].mul_(b2).add_((1 - b2) * g * g)
                step = (mu[p] / (1 - b1 ** t)) / (torch.sqrt(nu[p] / (1 - b2 ** t)) + eps)
                params[p].sub_(lr * step)
    return losses, first
