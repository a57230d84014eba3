"""Plain reference of the AUE training step at aue_3dmfv_dpdist: the 3DmFV
inception autoencoder trained through the frozen DPDist loss with Adam,
in plain PyTorch (dahliau/DPDist models/dpdist_and_aue.py:
get_model_aue_3dmfv; train_multi_gpu_pc_compare_dist.py's "ours" loss).

  encode    the 3DmFV of x1 (G Gaussians, sigma) as a (B, 20, g, g, g)
            volume, its cells in the flat order's digits (iy, ix, iz);
  inception 1^3 conv to F; 3^3 and 5^3 convs to F/2 on that; a 3^3
            average over the volume (zero padding, divided by 27) then a
            1^3 conv to F; each conv followed by BN (batch statistics,
            biased variance, eps) and ReLU; the four concatenated (3F
            channels) and flattened cell-major, channels last;
  decoder   dense to the width, BN, ReLU; dense to N * 3, BN; tanh;
  loss      the frozen DPDist loss of the reconstruction against x2;
  update    Adam (bias-corrected, the learning rate of the configuration).

BN's running statistics are the EMA of the batch's, with decay
`bn_momentum`. Parameters and state are {key path: tensor}, with the
program's key paths ("inception/conv1/w", "decoder/bn/0/scale", ...), a
conv's weight in (kd, kh, kw, in, out) and a dense layer's in (in, out).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.dpdist_3dmfv_k5 import Arith, encode

def leaf_shapes(cfg: dict):
    """({param path: shape}, {state path: shape}) of the AUE at `cfg`."""
    G, C, F_, W = cfg["n_gaussians"], cfg["fv_channels"], cfg["inception_filters"], cfg["decoder_width"]
    out = cfg["num_point"] * 3
    params, state = {}, {}
    convs = {"conv1": (1, C, F_), "conv2": (3, F_, F_ // 2), "conv3": (5, F_, F_ // 2),
             "conv4": (1, C, F_)}
    for name, (k, cin, cout) in convs.items():
        params[f"inception/{name}/w"], params[f"inception/{name}/b"] = (k, k, k, cin, cout), (cout,)
    norms = {"inception": (F_, F_ // 2, F_ // 2, F_), "decoder": (W, out)}
    for i, (cin, cout) in enumerate(((G * 3 * F_, W), (W, out))):
        params[f"decoder/layers/{i}/w"], params[f"decoder/layers/{i}/b"] = (cin, cout), (cout,)
    for where, widths in norms.items():
        for i, n in enumerate(widths):
            for leaf, tree in (("scale", params), ("offset", params), ("mean", state), ("var", state)):
                tree[f"{where}/bn/{i}/{leaf}"] = (n,)
    return params, state


def _bn(x, scale, offset, mean0, var0, dims, momentum, eps):
    """x normalised over `dims` by the batch's mean and biased variance,
    then scaled and offset; and the new running (mean, var)."""
    keep = [1 if i in dims else n for i, n in enumerate(x.shape)]
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * scale.reshape(keep) + offset.reshape(keep)
    return y, (momentum * mean0 + (1 - momentum) * mean.detach().reshape(-1),
               momentum * var0 + (1 - momentum) * var.detach().reshape(-1))


def forward(cfg: dict, arith: Arith, params: dict, state: dict, x1: torch.Tensor):
    """(reconstruction (B, N, 3), new state) of a training forward."""
    B, N, _ = x1.shape
    G, g = cfg["n_gaussians"], round(cfg["n_gaussians"] ** (1 / 3))
    new = {}

    def conv(name, x):
        w = params[f"inception/{name}/w"]
        return arith.conv3d(x, w.permute(4, 3, 0, 1, 2), params[f"inception/{name}/b"],
                            padding=w.shape[0] // 2)

    def bn_relu(i, x, where="inception", dims=(0, 2, 3, 4), relu=True):
        p = f"{where}/bn/{i}/"
        y, (m, v) = _bn(x, params[p + "scale"], params[p + "offset"], state[p + "mean"],
                        state[p + "var"], dims, cfg["bn_momentum"], cfg["bn_eps"])
        new[p + "mean"], new[p + "var"] = m, v
        return torch.relu(y) if relu else y

    vol = encode(x1, G, cfg["sigma"]).reshape(B, g, g, g, -1).permute(0, 4, 1, 2, 3)
    one = bn_relu(0, conv("conv1", vol))
    three = bn_relu(1, conv("conv2", one))
    five = bn_relu(2, conv("conv3", one))
    avg = F.avg_pool3d(F.pad(vol, (1,) * 6), 3, stride=1)
    avgc = bn_relu(3, conv("conv4", avg))
    z = torch.cat([one, three, five, avgc], 1).permute(0, 2, 3, 4, 1).reshape(B, -1)
    h = arith.linear(z, params["decoder/layers/0/w"], params["decoder/layers/0/b"])
    h = bn_relu(0, h, "decoder", (0,))
    h = arith.linear(h, params["decoder/layers/1/w"], params["decoder/layers/1/b"])
    h = bn_relu(1, h, "decoder", (0,), relu=False)
    return torch.tanh(h).reshape(B, N, 3), new


def train(cfg: dict, arith: Arith, net, params: dict, state: dict, batches):
    """Adam steps on `batches` [(x1, x2)], one each, from `params` and
    `state` (updated in place). Returns (losses, the norm of each leaf's
    first gradient {path: float}, the BN state after the first step)."""
    leaves = sorted(params)
    for p in leaves:
        params[p].requires_grad_(True)
    mu = {p: torch.zeros_like(params[p]) for p in leaves}
    nu = {p: torch.zeros_like(params[p]) for p in leaves}
    b1, b2, eps, lr = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["learning_rate"]
    losses, first, first_state = [], None, None
    for t, (x1, x2) in enumerate(batches, start=1):
        with arith:
            rec, new_state = forward(cfg, arith, params, state, x1)
            loss = net.frozen_loss(arith, rec, x2, cfg["out_of_grid_penalty"])
            grads = torch.autograd.grad(loss, [params[p] for p in leaves])
        losses.append(float(loss.detach()))
        if first is None:
            first = {p: float(torch.linalg.vector_norm(gr)) for p, gr in zip(leaves, grads)}
        with torch.no_grad():
            for p, gr in zip(leaves, grads):
                mu[p].mul_(b1).add_((1 - b1) * gr)
                nu[p].mul_(b2).add_((1 - b2) * gr * gr)
                step = (mu[p] / (1 - b1 ** t)) / (torch.sqrt(nu[p] / (1 - b2 ** t)) + eps)
                params[p].sub_(lr * step)
        state.update(new_state)
        if first_state is None:
            first_state = dict(new_state)
    return losses, first, first_state
