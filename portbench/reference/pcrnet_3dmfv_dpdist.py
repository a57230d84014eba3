"""Plain reference of the PCRNet training step at pcrnet_3dmfv_dpdist: the
iterative PCRNet with the 3DmFV inception encoder, refined for max_loops
iterations with the gradient through all of them and trained on the
frozen DPDist loss of the whole trajectory, in plain PyTorch
(dahliau/DPDist pcrnet-registration/models/ipcr_model.py:29-52
get_3dmfv_encoder, :273-283 get_pose; iterative_PCRNet_ours.py).

  volume     each cloud's 3DmFV on the mfv_grid^3 Gaussians (sigma3dmfv),
             as a (B, 20, g, g, g) volume whose axes are the digits (iy,
             ix, iz) of the flat Gaussian index;
  inception  six blocks: a 1^3 conv; a 3^3 and a 5^3 conv on its output; a
             3^3 average over the block's input (zero padding counted,
             divided by 27) then a 1^3 conv; each conv followed by BN
             without scale or offset (batch mean, biased variance, eps)
             and ReLU; the four concatenated; filters 64 in blocks 1-5 and
             out_features / 16 in block 6; a 2^3 stride-2 max pool after
             blocks 3 and 5 (SAME: a window past the edge reads only the
             cells it covers); flattened cell-major, channels last;
  siamese    source and template through the encoder as one batch of 2B
             clouds, so BN's statistics span both;
  head       [source features, template features] through dense layers
             with ReLU, then a dense layer to the pose (tx, ty, tz, qw, qx,
             qy, qz);
  apply      q / (|q| + 1e-7) as a rotation matrix, x R^T + t;
  loss       the frozen DPDist loss (dpdist_3dmfv_k5's Net) of the max_loops
             transformed sources against their templates, one mean over
             all of them;
  update     the gradient scaled to norm grad_clip where its global norm is
             at least grad_clip, then Adam (bias-corrected) at the
             staircase learning rate.

BN's state is the EMA of each iteration's batch statistics with decay
bn_momentum, carried through the iterations; the step keeps the last.

Departures from ipcr_model, as the program makes them: BN's decay is a
fixed bn_momentum where the source schedules it from 0.5 towards 0.99
(get_bn_decay); no dropout after the head (no trainer passes a dropout
key). BN without scale or offset, the average's padded zeros counted and
the SAME max pool follow the JAX package's reading of get_3dmfv_encoder.

Parameters and state are {key path: tensor} with the program's key paths
("mfv_blocks/0/one/w", "head/0/w", "out/b", "mfv_bn/0/one/mean", ...), a
conv's weight in (kd, kh, kw, in, out) and a dense layer's in (in, out).

`step` is one training step, free-running or teacher-forced: given the
program's trajectory, each iteration starts from the program's own input
to it, and the gradient runs through the reference's chain at the
program's values (x_program + (y - y.detach())), so that float32 rounding
in one iteration does not grow through the others (the refinement in
training mode is chaotic). The frozen loss is computed `block` clouds at a
time, its gradient then carried back through the chain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dpdist_3dmfv_k5 import Arith, encode

POOL_AFTER = (2, 4)          # blocks followed by the stride-2 max pool
FV_CHANNELS = 20


def filters(cfg: dict):
    return (64,) * 5 + (cfg["out_features"] // 16,)


def feature_dim(cfg: dict) -> int:
    g = cfg["mfv_grid"]
    for _ in POOL_AFTER:
        g = -(-g // 2)
    return g ** 3 * 4 * filters(cfg)[-1]


def leaf_shapes(cfg: dict):
    """({param path: shape}, {state path: shape}) of the policy at `cfg`."""
    params, state, cin = {}, {}, FV_CHANNELS
    for i, nf in enumerate(filters(cfg)):
        for name, k, c in (("one", 1, cin), ("three", 3, nf), ("five", 5, nf), ("avg", 1, cin)):
            params[f"mfv_blocks/{i}/{name}/w"] = (k, k, k, c, nf)
            params[f"mfv_blocks/{i}/{name}/b"] = (nf,)
            state[f"mfv_bn/{i}/{name}/mean"] = state[f"mfv_bn/{i}/{name}/var"] = (nf,)
        cin = 4 * nf
    d = 2 * feature_dim(cfg)
    for i, w in enumerate(cfg["head_widths"]):
        params[f"head/{i}/w"], params[f"head/{i}/b"] = (d, w), (w,)
        d = w
    params["out/w"], params["out/b"] = (d, 7), (7,)
    return params, state


def learning_rate(cfg: dict, count: int) -> float:
    """The staircase schedule at update `count`: max(lr * rate^floor(count / step), floor)."""
    lr = cfg["learning_rate"] * cfg["lr_decay_rate"] ** math.floor(count / cfg["lr_decay_step"])
    return max(lr, cfg["lr_floor"])


def features(cfg: dict, arith: Arith, params: dict, clouds: torch.Tensor):
    """((2B, feature_dim) features, {state path: batch moment}) of a
    training forward of the encoder on `clouds`."""
    if cfg["lim_rot"] != 0:
        raise ValueError("this reference covers the unlimited pose head (lim_rot 0) only")
    n, g = clouds.shape[0], cfg["mfv_grid"]
    x = encode(clouds, g ** 3, cfg["sigma3dmfv"]).reshape(n, g, g, g, -1).permute(0, 4, 1, 2, 3)
    moments = {}

    def conv_bn_relu(i, name, h):
        w = params[f"mfv_blocks/{i}/{name}/w"]
        h = arith.conv3d(h, w.permute(4, 3, 0, 1, 2), params[f"mfv_blocks/{i}/{name}/b"],
                         padding=w.shape[0] // 2)
        mean = h.mean((0, 2, 3, 4), keepdim=True)
        var = ((h - mean) ** 2).mean((0, 2, 3, 4), keepdim=True)
        moments[f"mfv_bn/{i}/{name}/mean"] = mean.detach().reshape(-1)
        moments[f"mfv_bn/{i}/{name}/var"] = var.detach().reshape(-1)
        return torch.relu((h - mean) * torch.rsqrt(var + cfg["bn_eps"]))

    for i in range(len(filters(cfg))):
        one = conv_bn_relu(i, "one", x)
        three = conv_bn_relu(i, "three", one)
        five = conv_bn_relu(i, "five", one)
        avg = conv_bn_relu(i, "avg", F.avg_pool3d(F.pad(x, (1,) * 6), 3, stride=1))
        x = torch.cat([one, three, five, avg], 1)
        if i in POOL_AFTER:
            x = F.max_pool3d(x, 2, stride=2, ceil_mode=True)
    return x.permute(0, 2, 3, 4, 1).reshape(n, -1), moments


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(B, 4) (w, x, y, z) -> (B, 3, 3) of the quaternion over its norm plus 1e-7."""
    q = q / (torch.sqrt((q * q).sum(-1, keepdim=True)) + 1e-7)
    w, x, y, z = q.unbind(-1)
    rows = [[w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w + y * y - x * x - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w + z * z - x * x - y * y]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def iteration(cfg: dict, arith: Arith, params: dict, src: torch.Tensor, template: torch.Tensor):
    """(pose (B, 7), the transformed source, {state path: batch moment})."""
    B = src.shape[0]
    feats, moments = features(cfg, arith, params, torch.cat([src, template]))
    x = torch.cat([feats[:B], feats[B:]], -1)
    for i in range(len(cfg["head_widths"])):
        x = torch.relu(arith.linear(x, params[f"head/{i}/w"], params[f"head/{i}/b"]))
    pose = arith.linear(x, params["out/w"], params["out/b"])
    moved = arith.linear(src, rotation(pose[:, 3:7]).transpose(1, 2), pose[:, None, :3])
    return pose, moved, moments


def frozen_loss(net, arith: Arith, a: torch.Tensor, b: torch.Tensor, penalty: float,
                block: int, grad: bool):
    """(the frozen loss of clouds `a` against `b` as a float, and its
    gradient in `a` or None), `block` clouds at a time."""
    n, total = a.shape[0], 0.0
    ga = torch.empty_like(a) if grad else None
    for s in range(0, n, block):
        x = a[s:s + block].detach().requires_grad_(grad)
        y = b[s:s + block]
        with torch.set_grad_enabled(grad):
            part = net.distances(arith, x, y).sum() / n
            if penalty > 0:
                part = part + penalty * (torch.relu(x.abs() - 1).sum()
                                         + torch.relu(y.abs() - 1).sum()) / a.numel()
        if grad:
            (ga[s:s + block],) = torch.autograd.grad(part, x)
        total += float(part.detach())
    return total, ga


def step(cfg: dict, arith: Arith, net, params: dict, state: dict, template, source, *,
         trajectory=None, block: int = 32):
    """One training step's forward and gradient, before the update.

    trajectory: None (free-running), or the program's (L, B, N, 3)
    transformed sources, which teacher-force each iteration's input.
    Returns {"poses": (L, B, 7), "trajectory": the reference's own
    iterations' outputs (L, B, N, 3), and, at `trajectory` where given,
    "loss": the loss and "grads": {path: its gradient}; "state": the BN
    state after the step}."""
    L = cfg["max_loops"]
    leaves = sorted(params)
    p = {k: params[k].detach().requires_grad_(True) for k in leaves}
    st, poses, outs, chain = dict(state), [], [], []
    with arith, torch.enable_grad():
        z = source
        for i in range(L):
            pose, y, moments = iteration(cfg, arith, p, z, template)
            m = cfg["bn_momentum"]
            st = {k: m * st[k] + (1 - m) * moments[k] for k in st}
            poses.append(pose.detach())
            outs.append(y.detach())
            z = y if trajectory is None else trajectory[i] + (y - y.detach())
            chain.append(z)
        chain = torch.stack(chain).flatten(0, 1)
        templates = template.repeat(L, 1, 1)
        pen = cfg["out_of_grid_penalty"]
        loss, g_chain = frozen_loss(net, arith, chain, templates, pen, block, True)
        grads = torch.autograd.grad(chain, [p[k] for k in leaves], g_chain)
    return {"poses": torch.stack(poses), "trajectory": torch.stack(outs), "loss": loss,
            "grads": dict(zip(leaves, grads)), "state": st}


def clip(cfg: dict, grads: dict) -> dict:
    """The gradient scaled to norm grad_clip where its global norm is at least that."""
    c = cfg["grad_clip"]
    if c <= 0:
        return dict(grads)
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    return {k: g * (c / norm) if norm >= c else g for k, g in grads.items()}


def adam_update(cfg: dict, grads: dict, mu: dict, nu: dict, count: int) -> dict:
    """{path: the change of the leaf} of one Adam step (the moments `mu` and
    `nu` updated in place; `count` steps before this one)."""
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    t, lr = count + 1, learning_rate(cfg, count)
    out = {}
    for k, g in grads.items():
        mu[k] = b1 * mu[k] + (1 - b1) * g
        nu[k] = b2 * nu[k] + (1 - b2) * g * g
        out[k] = -lr * (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
    return out
