"""Iterative PCRNet: point-cloud registration with the refinement loop on
the device (port of dpdist_tpu/models/pcrnet.py).

    params = init_pcrnet(PCRNetConfig(), torch.Generator().manual_seed(0))
    state = init_pcrnet_state(PCRNetConfig())
    src_out, T, poses = pcrnet_refine(params, cfg, source, template, iterations=8,
                                      state=state)

A siamese encoder maps source and template to features; a head maps the
two features to a 7-dof pose (tx, ty, tz, qw, qx, qy, qz); each iteration
applies its pose to the source and composes it onto the running 4x4
transform. The loop is a Python loop of device operations: nothing is
copied to the host between iterations.

Encoders:
  "pointnet", "pointnet_avg"  dense 3 -> 64 -> 64 -> 64 -> 128 ->
      out_features with ReLU, then a max (or a mean) over the points; no
      BN, no state; each cloud encoded apart.
  "3dmfv"  the 3DmFV volume (mfv_grid^3 Gaussians, sigma3dmfv) through
      six 3D inception blocks (ipcr_model.get_3dmfv_encoder): 1^3, 3^3
      and 5^3 convs (the last two on the 1^3's output) and a 3^3 average
      (divided by 27, padded zeros counted) then a 1^3 conv, each followed
      by BN without scale or offset and a ReLU, concatenated; filters 64
      in blocks 1-5 and out_features / 16 in block 6; a 2^3 stride-2 max
      pool (SAME) after blocks 3 and 5; flattened channels-last. Source
      and template go through it as ONE batch, as the reference's, so in
      training (and without a state) BN's batch statistics span both
      clouds. Its BN state {"mfv_bn": [{"one" | "three" | "five" | "avg":
      {"mean", "var"}}, ...]} is EMA-updated with BN_MOMENTUM in training;
      in eval the running statistics normalise; with state None the batch
      statistics do, in eval too (checkpoints without a state).

Parameters and state keep the JAX package's trees ({"encoder" |
"mfv_blocks", "head", "out"}; dense `w` as (in, out), conv `w` DHWIO), so
checkpoints load into either package.

Under a profiler session (train.profiling.span) pcrnet_refine opens the
span "pcrnet.refine" around its loop, and apply_pcrnet (and
encode_template) "pcrnet.encode" around the encoding and "pcrnet.head"
around the head and the pose's parameterisation; the detail of
"pcrnet.refine" and "pcrnet.encode" is the encoder, "threedmfv" or
"pointnet".

The max over points splits its gradient evenly among tied maxima
(torch.amax), as jnp.max does. Ties are real here: occlusion refills and
random resampling duplicate points, and duplicated points give identical
feature rows. torch.max(dim).values would hand the whole gradient to one
of them.
"""

from __future__ import annotations

import math

import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.geometry.rotations import normalize_quat
from dpdist_tpu_torch.geometry.se3 import apply_quat, compose_transforms, pose7_to_matrix
from dpdist_tpu_torch.nn.layers import (
    avg_pool3d,
    batch_moments,
    conv3d_apply,
    conv3d_init,
    dense_apply,
    dense_init,
    max_pool3d,
    params_to_device,
)
from dpdist_tpu_torch.ops.threedmfv import threedmfv
from dpdist_tpu_torch.train.profiling import span

ENCODER_WIDTHS = (64, 64, 64, 128)   # then cfg.out_features
ENCODERS = ("pointnet", "pointnet_avg", "3dmfv")
MFV_BRANCHES = ("one", "three", "five", "avg")
MFV_POOL_AFTER = (2, 4)              # blocks followed by a stride-2 max pool
FV_CHANNELS = 20
#: EMA decay of the 3dmfv encoder's BN: a fixed mid-schedule value of the
#: reference's bn_decay (0.5 toward 0.99), which keeps the state free of a
#: step counter.
BN_MOMENTUM = 0.9
BN_EPS = 1e-3


def check_encoder(cfg: PCRNetConfig) -> None:
    if cfg.encoder not in ENCODERS:
        raise ValueError(f"unknown PCRNet encoder {cfg.encoder!r}")


def _detail(cfg: PCRNetConfig) -> str:
    """The encoder, as the spans name it."""
    return "threedmfv" if cfg.encoder == "3dmfv" else "pointnet"


def mfv_filters(cfg: PCRNetConfig):
    return (64,) * 5 + (cfg.out_features // 16,)


def feature_dim(cfg: PCRNetConfig) -> int:
    """One cloud's encoder output width."""
    if cfg.encoder != "3dmfv":
        return cfg.out_features
    g = cfg.mfv_grid
    for _ in MFV_POOL_AFTER:
        g = -(-g // 2)
    return g ** 3 * 4 * mfv_filters(cfg)[-1]


def init_pcrnet(cfg: PCRNetConfig, generator=None, device="cuda"):
    """Params with xavier-uniform weights and zero biases, drawn in order
    (encoder, head, out) from `generator`. The numbers differ from JAX's
    for the same seed; parity tests carry JAX's weights across. The 3dmfv
    encoder's BN state comes from init_pcrnet_state."""
    check_encoder(cfg)
    dev = resolve_device(device)
    params = {}
    if cfg.encoder == "3dmfv":
        blocks, in_ch = [], FV_CHANNELS
        for nf in mfv_filters(cfg):
            blocks.append({"one": conv3d_init(in_ch, nf, (1, 1, 1), generator),
                           "three": conv3d_init(nf, nf, (3, 3, 3), generator),
                           "five": conv3d_init(nf, nf, (5, 5, 5), generator),
                           "avg": conv3d_init(in_ch, nf, (1, 1, 1), generator)})
            in_ch = 4 * nf
        params["mfv_blocks"] = blocks
    else:
        enc, d = [], 3
        for i, w in enumerate(ENCODER_WIDTHS + (cfg.out_features,)):
            enc.append(dense_init(d, w, conv_fan=(3, 3 * 64) if i == 0 else None,
                                  generator=generator))
            d = w
        params["encoder"] = enc
    head, d = [], 2 * feature_dim(cfg)
    for w in cfg.head_widths:
        head.append(dense_init(d, w, generator=generator))
        d = w
    params["head"] = head
    params["out"] = dense_init(d, 7, generator=generator)
    return params_to_device(params, dev)


def init_pcrnet_state(cfg: PCRNetConfig, device="cuda") -> dict:
    """The policy's initial state: {} for the pointnet encoders; for 3dmfv
    {"mfv_bn": [...]}, per block and branch a zero mean and a unit var."""
    check_encoder(cfg)
    if cfg.encoder != "3dmfv":
        return {}
    dev = resolve_device(device)
    return {"mfv_bn": [{name: {"mean": torch.zeros(nf, device=dev),
                               "var": torch.ones(nf, device=dev)} for name in MFV_BRANCHES}
                       for nf in mfv_filters(cfg)]}


def _encode(params, cfg: PCRNetConfig, points):
    """Siamese PointNet branch: (B, N, 3) -> (B, out_features)."""
    x = points
    for lp in params["encoder"]:
        x = torch.relu(dense_apply(lp, x))
    if cfg.encoder == "pointnet_avg":
        return torch.mean(x, dim=1)
    return torch.amax(x, dim=1)


def _quat_limit(pose_raw, rot_lim_deg: float):
    """tanh-limited axis-angle parameterization (ipcr_model.py:285-294)."""
    t, ang, direc = pose_raw[..., :3], pose_raw[..., 3:4], pose_raw[..., 4:7]
    ang = torch.tanh(ang) * (math.pi / 180.0 * rot_lim_deg)
    dn = torch.linalg.vector_norm(direc, dim=-1, keepdim=True) + 1e-6
    direc = direc / dn * torch.sin(ang / 2.0)
    w = torch.cos(ang / 2.0)
    t = torch.tanh(t) * 0.1
    return torch.cat([t, w, direc], dim=-1)


def template_feats_invariant(cfg: PCRNetConfig, state=None, train: bool = False) -> bool:
    """True when the template's features cannot depend on the source, so a
    refinement may encode them once. The pointnet encoders encode the
    clouds apart: always. The 3dmfv encoder encodes both as one batch, so
    only in eval with running statistics (a state with mfv_bn); in
    training, or without a state, BN's batch statistics couple them."""
    check_encoder(cfg)
    if cfg.encoder != "3dmfv":
        return True
    return (not train) and state is not None and state.get("mfv_bn") is not None


def encode_template(params, cfg: PCRNetConfig, template, *, state=None):
    """The template's features, for reuse across refinement iterations
    where template_feats_invariant(cfg, state, train) holds (the same rows
    as the two-cloud batch gives: running-statistics BN is per sample)."""
    check_encoder(cfg)
    with span("pcrnet.encode", _detail(cfg)):
        if cfg.encoder == "3dmfv":
            return _encode_3dmfv(params, cfg, template, state=state, train=False)[0]
        return _encode(params, cfg, template)


def _encode_3dmfv(params, cfg: PCRNetConfig, points, *, state=None, train: bool = False):
    """(features (B, feature_dim), new_state) of the 3dmfv encoder; the
    new state holds the EMA-updated statistics when train=True and a state
    is given, else it is `state` as it is."""
    B, g = points.shape[0], cfg.mfv_grid
    x = threedmfv(points, g ** 3, cfg.sigma3dmfv).reshape(B, g, g, g, -1)
    bn_in = state.get("mfv_bn") if state is not None else None
    bn_out = []

    def bn(h, i, name):
        if bn_in is not None and not train:
            m, v = bn_in[i][name]["mean"], bn_in[i][name]["var"]
        else:
            m, v = batch_moments(h)
            if bn_in is not None:
                old = bn_in[i][name]
                bn_out[i][name] = {
                    "mean": (BN_MOMENTUM * old["mean"] + (1 - BN_MOMENTUM) * m).detach(),
                    "var": (BN_MOMENTUM * old["var"] + (1 - BN_MOMENTUM) * v).detach()}
        return torch.relu((h - m) * torch.rsqrt(v + BN_EPS))

    for i, blk in enumerate(params["mfv_blocks"]):
        if bn_in is not None and train:
            bn_out.append(dict(bn_in[i]))
        one = bn(conv3d_apply(blk["one"], x), i, "one")
        three = bn(conv3d_apply(blk["three"], one), i, "three")
        five = bn(conv3d_apply(blk["five"], one), i, "five")
        avg = avg_pool3d(x, (3, 3, 3), stride=(1, 1, 1), padding="SAME",
                         count_include_pad=True)
        avgc = bn(conv3d_apply(blk["avg"], avg), i, "avg")
        x = torch.cat([one, three, five, avgc], dim=-1)
        if i in MFV_POOL_AFTER:
            x = max_pool3d(x, (2, 2, 2), stride=(2, 2, 2), padding="SAME")
    new_state = state
    if bn_in is not None and train:
        new_state = dict(state)
        new_state["mfv_bn"] = bn_out
    return x.reshape(B, -1), new_state


def apply_pcrnet(params, cfg: PCRNetConfig, source, template, *, template_feats=None,
                 state=None, train: bool = False, return_state: bool = False):
    """Predict a 7-dof pose (tx, ty, tz, qw, qx, qy, qz) for one iteration.

    state / train: the 3dmfv encoder's BN (see the module docstring);
    return_state also returns the new state (the pointnet encoders return
    `state` as it is). template_feats: encode_template's output, encoded
    once per refinement; only where template_feats_invariant(cfg, state,
    train) holds, else ValueError. The reference's dropout_key (dropout
    after the head in training) is not taken: no trainer or evaluator of
    either package passes one.
    """
    check_encoder(cfg)
    new_state = state
    if template_feats is not None and not template_feats_invariant(cfg, state, train):
        raise ValueError("template_feats passed but the template encoding is not "
                         "batch-independent here (3dmfv train mode, or eval without "
                         "running BN statistics)")
    with span("pcrnet.encode", _detail(cfg)):
        if template_feats is not None:
            if cfg.encoder == "3dmfv":
                sf = _encode_3dmfv(params, cfg, source, state=state, train=False)[0]
            else:
                sf = _encode(params, cfg, source)
            tf_ = template_feats
        elif cfg.encoder == "3dmfv":
            feats, new_state = _encode_3dmfv(params, cfg, torch.cat([source, template]),
                                             state=state, train=train)
            # Slices, not torch.chunk: chunk's size puts an unprovable guard on
            # a symbolic batch.
            B = source.shape[0]
            sf, tf_ = feats[:B], feats[B:]
        else:
            sf, tf_ = _encode(params, cfg, source), _encode(params, cfg, template)
    with span("pcrnet.head"):
        x = torch.cat([sf, tf_], dim=-1)
        for lp in params["head"]:
            x = torch.relu(dense_apply(lp, x))
        pose = dense_apply(params["out"], x)
        if cfg.lim_rot > 0:
            pose = _quat_limit(pose, cfg.lim_rot)
    return (pose, new_state) if return_state else pose


def pcrnet_iteration(params, cfg: PCRNetConfig, src, template, *, template_feats=None,
                     state=None, train: bool = False):
    """One refinement iteration: predict a pose from (src, template) and
    apply it to src. Returns (pose (B, 7), new_src (B, N, 3), state)."""
    pose, st = apply_pcrnet(params, cfg, src, template, template_feats=template_feats,
                            state=state, train=train, return_state=True)
    new_src = apply_quat(src, normalize_quat(pose[..., 3:7]), pose[..., :3])
    return pose, new_src, st


def pcrnet_refine(params, cfg: PCRNetConfig, source, template, *, iterations: int,
                  stop_gradient_iters: bool = True, return_trajectory: bool = False,
                  state=None, train: bool = False, return_state: bool = False):
    """Iterative refinement on the device.

    stop_gradient_iters: gradients flow only through the final iteration
      (the source and transform every earlier iteration hands on are
      detached), the reference's default training scheme; False
      backpropagates through the whole refinement (--train_single).
    return_trajectory: also return the per-iteration transformed sources
      (iterations, B, N, 3).
    state / train: the 3dmfv encoder's BN; with a state in training the
      EMA updates on every iteration (the reference's scan carries it).
      Where template_feats_invariant holds, the template is encoded once.
    return_state: append the final state.

    Returns (transformed_source, T_total (B, 4, 4), poses (iterations, B,
    7)[, trajectory][, state]).
    """
    B = source.shape[0]
    T = torch.eye(4, dtype=source.dtype, device=source.device).expand(B, 4, 4)
    carry_state = state is not None and train and cfg.encoder == "3dmfv"
    src, st, poses, traj = source, state, [], []
    with span("pcrnet.refine", _detail(cfg)):
        tfeats = (encode_template(params, cfg, template, state=state)
                  if template_feats_invariant(cfg, state, train) else None)
        for i in range(iterations):
            pose, new_src, new_st = pcrnet_iteration(params, cfg, src, template,
                                                     template_feats=tfeats, state=st,
                                                     train=train)
            T_new = compose_transforms(pose7_to_matrix(pose), T)
            if stop_gradient_iters and i < iterations - 1:
                new_src, T_new = new_src.detach(), T_new.detach()
            if carry_state:
                st = new_st
            poses.append(pose)
            if return_trajectory:
                traj.append(new_src)
            src, T = new_src, T_new
    ret = (src, T, torch.stack(poses))
    if return_trajectory:
        ret += (torch.stack(traj),)
    if return_state:
        ret += (st,)
    return ret
