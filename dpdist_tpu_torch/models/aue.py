"""Point-cloud autoencoders, the downstream task of the frozen DPDist loss
(port of dpdist_tpu/models/aue.py).

    params, state = init_aue(AUEConfig(encoder="3dmfv"), torch.Generator().manual_seed(0))
    rec, new_state = apply_aue(params, state, cfg, points, train=True)

Two encoders (the reference's get_model_aue_pn and get_model_aue_3dmfv,
models/dpdist_and_aue.py:88-180):
  "pn"    a PointNet: dense 3-64-64-64-128-1024, each with BN and ReLU,
          then the max over the points; decoder 1024-1024-N*3 with BN on
          the first two layers, the last linear;
  "3dmfv" the 3DmFV volume (g^3 Gaussians, sigma 0.0625) through one 3D
          inception block: 1^3 conv to 256, 3^3 and 5^3 convs to 128 each
          on top of it, and a 3^3 average (SAME, divided by 27: the padded
          zeros count) then a 1^3 conv to 256, each conv with BN and ReLU,
          concatenated (768 channels) and flattened channels-last; decoder
          g^3*768-1024-N*3, BN on both layers (the N*3 one too, without
          ReLU).
The output is tanh, (B, N, 3) in [-1, 1].

Parameters and state keep the JAX package's trees ({"encoder" |
"inception", "decoder"}, BN scale/offset under params "bn", running
mean/var under state "bn", None for a layer without BN), so checkpoints
load into either package (train/checkpoint.py). The max over the points
splits tied gradients evenly, as jnp.max does (torch.amax).
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import AUEConfig
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.nn.layers import (
    avg_pool3d,
    batchnorm_apply,
    batchnorm_init,
    conv3d_apply,
    conv3d_init,
    dense_apply,
    dense_init,
)
from dpdist_tpu_torch.ops.threedmfv import threedmfv

PN_ENCODER = (64, 64, 64, 128, 1024)
INCEPTION_FILTERS = 256
FV_CHANNELS = 20
SIGMA = 0.0625


def grid_of(cfg: AUEConfig) -> int:
    g = round(cfg.n_gaussians ** (1 / 3))
    if g ** 3 != cfg.n_gaussians:
        raise ValueError(f"n_gaussians must be a cube, got {cfg.n_gaussians}")
    return g


def _chain_init(in_dim, widths, bn_flags, generator, conv_fan_first=None):
    layers, bns_p, bns_s, d = [], [], [], in_dim
    for i, (w, bn) in enumerate(zip(widths, bn_flags)):
        layers.append(dense_init(d, w, conv_fan=conv_fan_first if i == 0 else None,
                                 generator=generator))
        bp, bs = batchnorm_init(w) if bn else (None, None)
        bns_p.append(bp)
        bns_s.append(bs)
        d = w
    return {"layers": layers, "bn": bns_p}, {"bn": bns_s}


def init_aue(cfg: AUEConfig, generator=None, device="cuda"):
    """(params, state): xavier-uniform weights and zero biases drawn in order
    (encoder or inception block, then decoder) from `generator` on the
    CPU, BN scale 1, offset 0, mean 0, var 1. The numbers differ from JAX's
    for the same seed."""
    if cfg.encoder not in ("pn", "3dmfv"):
        raise ValueError(f"unknown AUE encoder {cfg.encoder!r}")
    dev = resolve_device(device)
    params, state = {}, {}
    N3 = cfg.num_point * 3
    if cfg.encoder == "pn":
        params["encoder"], state["encoder"] = _chain_init(
            3, PN_ENCODER, [True] * 5, generator, conv_fan_first=(3, 3 * 64))
        dec_in, dec_widths, dec_bn = PN_ENCODER[-1], (1024, 1024, N3), (True, True, False)
    else:
        g, nf = grid_of(cfg), INCEPTION_FILTERS
        params["inception"] = {
            "conv1": conv3d_init(FV_CHANNELS, nf, (1, 1, 1), generator),
            "conv2": conv3d_init(nf, nf // 2, (3, 3, 3), generator),
            "conv3": conv3d_init(nf, nf // 2, (5, 5, 5), generator),
            "conv4": conv3d_init(FV_CHANNELS, nf, (1, 1, 1), generator),
        }
        bns = [batchnorm_init(w) for w in (nf, nf // 2, nf // 2, nf)]
        params["inception"]["bn"] = [p for p, _ in bns]
        state["inception"] = {"bn": [s for _, s in bns]}
        dec_in, dec_widths, dec_bn = g ** 3 * 3 * nf, (1024, N3), (True, True)
    params["decoder"], state["decoder"] = _chain_init(dec_in, dec_widths, dec_bn, generator)
    return params_to_device(params, dev), params_to_device(state, dev)


def _apply_chain(p, s, x, *, train, bn_momentum, final_linear=True):
    new_bn, n = [], len(p["layers"])
    for i, (lp, bp, bs) in enumerate(zip(p["layers"], p["bn"], s["bn"])):
        x = dense_apply(lp, x)
        if bp is not None:
            x, bs = batchnorm_apply(bp, bs, x, train=train, momentum=bn_momentum)
        new_bn.append(bs)
        if not (final_linear and i == n - 1):
            x = torch.relu(x)
    return x, {"bn": new_bn}


def _bn_relu(ip, istate, i, h, train, bn_momentum):
    y, s = batchnorm_apply(ip["bn"][i], istate["bn"][i], h, train=train, momentum=bn_momentum)
    return torch.relu(y), s


def apply_aue(params, state, cfg: AUEConfig, points, *, train: bool = False,
              bn_momentum=0.9):
    """points (B, N, 3) -> (reconstruction (B, N, 3) in [-1, 1], new_state).

    train=True normalises with batch statistics and returns their EMA (decay
    bn_momentum), detached; train=False uses the running statistics and
    returns the state as it is."""
    B, N, _ = points.shape
    new_state = {}
    if cfg.encoder == "pn":
        feat, new_state["encoder"] = _apply_chain(params["encoder"], state["encoder"], points,
                                                  train=train, bn_momentum=bn_momentum,
                                                  final_linear=False)
        z = torch.amax(feat, dim=1)                                     # (B, 1024)
    else:
        g = grid_of(cfg)
        vol = threedmfv(points, cfg.n_gaussians, SIGMA).reshape(B, g, g, g, -1)
        ip, ist = params["inception"], state["inception"]
        args = (train, bn_momentum)
        one, s0 = _bn_relu(ip, ist, 0, conv3d_apply(ip["conv1"], vol), *args)
        three, s1 = _bn_relu(ip, ist, 1, conv3d_apply(ip["conv2"], one), *args)
        five, s2 = _bn_relu(ip, ist, 2, conv3d_apply(ip["conv3"], one), *args)
        # reduce_window(add, SAME) / 27: the padded zeros count.
        avg = avg_pool3d(vol, (3, 3, 3), stride=(1, 1, 1), padding="SAME",
                         count_include_pad=True)
        avgc, s3 = _bn_relu(ip, ist, 3, conv3d_apply(ip["conv4"], avg), *args)
        z = torch.cat([one, three, five, avgc], dim=-1).reshape(B, -1)
        new_state["inception"] = {"bn": [s0, s1, s2, s3]}
    rec, new_state["decoder"] = _apply_chain(params["decoder"], state["decoder"], z,
                                             train=train, bn_momentum=bn_momentum)
    return torch.tanh(rec).reshape(B, N, 3), new_state
