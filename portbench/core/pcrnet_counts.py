"""Model FLOPs of a PCRNet training step from shapes (the architecture as
the configuration's plain reference defines it): the 3DmFV inception
encoder's convolutions, the head's dense layers and the frozen DPDist
loss's decoder GEMMs (2 operations a multiply-add; encodes, BN, pools and
the optimizer left out, as core/counts.py counts the other cells).

A step with train_single refines B (source, template) pairs for L
iterations, each encoding the 2B clouds as one batch, and backpropagates
through every iteration: each convolution and dense layer counts its
forward, its weight gradient and its input gradient, but for the input
gradient of iteration 0's first 1^3 convolutions, whose input (the
volume of the data) needs none. The frozen loss runs on the L * B
transformed sources against their templates: both directions' forward
and the decoder's input gradient (core/counts.grad_call_flops).
"""

from __future__ import annotations

from portbench.core import counts
from portbench.reference.pcrnet_3dmfv_dpdist import FV_CHANNELS, POOL_AFTER, feature_dim, filters


def conv_layers(cfg: dict):
    """[(cells, window, in, out)] of one cloud's forward through the encoder."""
    out, g, cin = [], cfg["mfv_grid"], FV_CHANNELS
    for i, nf in enumerate(filters(cfg)):
        cells = g ** 3
        out += [(cells, 1, cin, nf), (cells, 27, nf, nf), (cells, 125, nf, nf), (cells, 1, cin, nf)]
        cin = 4 * nf
        if i in POOL_AFTER:
            g = -(-g // 2)
    return out


def conv_flops(cfg: dict) -> int:
    """One cloud's forward through the six inception blocks (2,160 MFLOP at
    the published widths)."""
    return sum(2 * cells * window * cin * cout for cells, window, cin, cout in conv_layers(cfg))


def head_flops(cfg: dict) -> int:
    """One pair's forward through the head to the 7-dof pose."""
    return counts.mlp_row_flops(2 * feature_dim(cfg), list(cfg["head_widths"]) + [7])


def step_flops(cfg: dict, dpdist: dict, batch: int, points: int) -> int:
    """A train_single step at `batch` pairs of `points`-point clouds."""
    L = cfg["max_loops"]
    first = conv_layers(cfg)
    unneeded = sum(2 * cells * window * cin * cout for cells, window, cin, cout in
                   (first[0], first[3]))
    convs = 3 * L * 2 * batch * conv_flops(cfg) - 2 * batch * unneeded
    head = 3 * L * batch * head_flops(cfg)
    return convs + head + counts.grad_call_flops(dpdist, L * batch, points)
