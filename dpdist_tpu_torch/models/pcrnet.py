"""Iterative PCRNet: point-cloud registration with the refinement loop on
the device (port of dpdist_tpu/models/pcrnet.py).

    params = init_pcrnet(PCRNetConfig(), torch.Generator().manual_seed(0))
    src_out, T, poses = pcrnet_refine(params, cfg, source, template, iterations=8)

A siamese PointNet encodes source and template (dense layers 3 -> 64 -> 64
-> 64 -> 128 -> out_features with ReLU, then a max, or a mean for
"pointnet_avg", over the points); a head maps the two features to a 7-dof
pose (tx, ty, tz, qw, qx, qy, qz); each iteration applies its pose to the
source and composes it onto the running 4x4 transform. The loop is a
Python loop of device operations: nothing is copied to the host between
iterations.

Parameters keep the JAX package's tree ({"encoder": [...], "head": [...],
"out": {...}}, dense `w` as (in, out)), so checkpoints load into either
package. The pointnet encoders have no BN and so no state (the
reference's BN state, train flag and state returns serve its "3dmfv"
encoder, which needs BatchNorm and conv3d and raises NotImplementedError
until they are ported, ROADMAP.md §1 item 5).

The max over points splits its gradient evenly among tied maxima
(torch.amax), as jnp.max does. Ties are real here: occlusion refills and
random resampling duplicate points, and duplicated points give identical
feature rows. torch.max(dim).values would hand the whole gradient to one
of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.geometry.rotations import normalize_quat
from dpdist_tpu_torch.geometry.se3 import apply_quat, compose_transforms, pose7_to_matrix
from dpdist_tpu_torch.nn.layers import dense_apply, dense_init

ENCODER_WIDTHS = (64, 64, 64, 128)   # then cfg.out_features


def check_ported(cfg: PCRNetConfig) -> None:
    if cfg.encoder == "3dmfv":
        raise NotImplementedError(
            "the 3dmfv PCRNet encoder needs BatchNorm and conv3d, which are not ported yet "
            "(ROADMAP.md §1 item 5)")
    if cfg.encoder not in ("pointnet", "pointnet_avg"):
        raise ValueError(f"unknown PCRNet encoder {cfg.encoder!r}")


def init_pcrnet(cfg: PCRNetConfig, generator=None, device="cuda"):
    """Params with xavier-uniform weights and zero biases, drawn in order
    (encoder, head, out) from `generator`. The numbers differ from JAX's
    for the same seed; parity tests carry JAX's weights across."""
    check_ported(cfg)
    dev = resolve_device(device)
    enc, d = [], 3
    for i, w in enumerate(ENCODER_WIDTHS + (cfg.out_features,)):
        enc.append(dense_init(d, w, conv_fan=(3, 3 * 64) if i == 0 else None,
                              generator=generator))
        d = w
    head, d = [], 2 * cfg.out_features
    for w in cfg.head_widths:
        head.append(dense_init(d, w, generator=generator))
        d = w
    params = {"encoder": enc, "head": head, "out": dense_init(d, 7, generator=generator)}
    return params_to_device(params, dev)


def params_to_device(params, device, requires_grad: bool = False):
    """The tree with every leaf (numpy array or tensor) as a float32 tensor
    on `device`, a fresh copy (a leaf of autograd with requires_grad)."""
    if isinstance(params, dict):
        return {k: params_to_device(v, device, requires_grad) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_device(v, device, requires_grad) for v in params]
    if isinstance(params, torch.Tensor):
        t = params.detach().to(device, torch.float32).clone()
    else:
        t = torch.from_numpy(np.array(params, np.float32)).to(device)
    return t.requires_grad_(requires_grad)


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


def template_feats_invariant(cfg: PCRNetConfig) -> bool:
    """True when the template's features cannot depend on the source, so a
    refinement may encode them once. The pointnet encoders encode the
    clouds apart, so for every ported encoder it holds, in training too;
    the reference's 3dmfv encoder in training couples the two clouds
    through BN's batch statistics."""
    check_ported(cfg)
    return True


def encode_template(params, cfg: PCRNetConfig, template):
    """The template's features, for reuse across refinement iterations
    where template_feats_invariant(cfg) holds."""
    check_ported(cfg)
    return _encode(params, cfg, template)


def apply_pcrnet(params, cfg: PCRNetConfig, source, template, *, template_feats=None):
    """Predict a 7-dof pose (tx, ty, tz, qw, qx, qy, qz) for one iteration.

    template_feats: encode_template's output, encoded once per refinement.
    The reference's dropout_key (dropout after the head in training) is
    not taken: no trainer or evaluator of either package passes one.
    """
    check_ported(cfg)
    sf = _encode(params, cfg, source)
    tf_ = template_feats if template_feats is not None else _encode(params, cfg, template)
    x = torch.cat([sf, tf_], dim=-1)
    for lp in params["head"]:
        x = torch.relu(dense_apply(lp, x))
    pose = dense_apply(params["out"], x)
    if cfg.lim_rot > 0:
        pose = _quat_limit(pose, cfg.lim_rot)
    return pose


def pcrnet_iteration(params, cfg: PCRNetConfig, src, template, *, template_feats=None):
    """One refinement iteration: predict a pose from (src, template) and
    apply it to src. Returns (pose (B, 7), new_src (B, N, 3))."""
    pose = apply_pcrnet(params, cfg, src, template, template_feats=template_feats)
    new_src = apply_quat(src, normalize_quat(pose[..., 3:7]), pose[..., :3])
    return pose, new_src


def pcrnet_refine(params, cfg: PCRNetConfig, source, template, *, iterations: int,
                  stop_gradient_iters: bool = True, return_trajectory: bool = False):
    """Iterative refinement on the device.

    stop_gradient_iters: gradients flow only through the final iteration
      (the source and transform every earlier iteration hands on are
      detached), the reference's default training scheme; False
      backpropagates through the whole refinement (--train_single).
    return_trajectory: also return the per-iteration transformed sources
      (iterations, B, N, 3).

    Returns (transformed_source, T_total (B, 4, 4), poses (iterations, B,
    7)[, trajectory]).
    """
    B = source.shape[0]
    T = torch.eye(4, dtype=source.dtype, device=source.device).expand(B, 4, 4)
    tfeats = encode_template(params, cfg, template) if template_feats_invariant(cfg) else None
    src, poses, traj = source, [], []
    for i in range(iterations):
        pose, new_src = pcrnet_iteration(params, cfg, src, template, template_feats=tfeats)
        T_new = compose_transforms(pose7_to_matrix(pose), T)
        if stop_gradient_iters and i < iterations - 1:
            new_src, T_new = new_src.detach(), T_new.detach()
        poses.append(pose)
        if return_trajectory:
            traj.append(new_src)
        src, T = new_src, T_new
    ret = (src, T, torch.stack(poses))
    if return_trajectory:
        ret += (torch.stack(traj),)
    return ret
