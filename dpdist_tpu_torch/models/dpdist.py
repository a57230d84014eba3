"""DPDist forward and learned distance (port of apply_dpdist with train=False,
_output_activation and dpdist_distance from dpdist_tpu/models/dpdist.py).

Forward semantics (the canonical config: 3DmFV encoder, k > 0,
conv_version 1, BN off, float32):
  1. Encode each cloud into a (B, V, 20) Fisher-vector volume.
  2. For each query point of the other cloud: its voxel, the k^3 patch
     around that voxel and its offset to the cell centre, giving the
     decoder input x = [delta, patch], (B, N, 3 + k^3*20).
  3. The MLP decoder, relu6(x)/3 on the output, and outside-grid query
     points zeroed by the membership mask.
pred_AB scores the points of B against the surface encoded from A.

`cfg.fused_gather` picks how step 1-2 run:
  "off"  the plain composition: threedmfv -> extract_patches ->
         voxel_assign -> gather -> concat, per direction;
  "mfv"  the fused kernel (kernels/mfv_gather.py), once over the 2B stack:
         encode [A; B], query [B; A] (dpdist_tpu/models/dpdist.py:400-417);
  "auto" "mfv" on CUDA tensors, "off" on the CPU.
Configs this port does not cover yet raise NotImplementedError.
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.mfv_gather import mfv_table_gather_x, mfv_x_plain
from dpdist_tpu_torch.nn.layers import mlp_apply
from dpdist_tpu_torch.ops.voxel import voxel_assign


def check_ported(cfg: DPDistConfig) -> None:
    """Raise NotImplementedError naming the first part of `cfg` that this
    port does not cover yet."""
    missing = []
    if cfg.encoder != "3dmfv":
        missing.append(f"encoder={cfg.encoder!r} (the pointnet encoder)")
    if cfg.dims != 3:
        missing.append(f"dims={cfg.dims}")
    if cfg.k <= 0:
        missing.append(f"k={cfg.k} (the global embedding)")
    if not cfg.full_fv:
        missing.append("full_fv=False (the 7-channel encode)")
    if cfg.conv_version != 1:
        missing.append(f"conv_version={cfg.conv_version}")
    if cfg.use_bn:
        missing.append("use_bn=True (BatchNorm)")
    if cfg.dtype != "float32":
        missing.append(f"dtype={cfg.dtype!r}")
    if cfg.fused_gather in ("on", "table", "full"):
        missing.append(f"fused_gather={cfg.fused_gather!r}")
    elif cfg.fused_gather not in ("auto", "mfv", "off"):
        raise ValueError(f"unknown fused_gather={cfg.fused_gather!r}")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


def fused_gather_mode(cfg: DPDistConfig, device: torch.device) -> str:
    """Resolve cfg.fused_gather to "mfv" or "off" for tensors on `device`."""
    check_ported(cfg)
    if cfg.fused_gather == "auto":
        return "mfv" if device.type == "cuda" else "off"
    return cfg.fused_gather


def _output_activation(x: torch.Tensor, output_act: str) -> torch.Tensor:
    if output_act == "tanh":
        return torch.tanh(x)
    if output_act == "relu":
        # relu6(x)/3 -> range [0, 2]
        return torch.clamp(x, 0.0, 6.0) / 3.0
    # (-1, 1) centered variant
    return torch.clamp(x + 3.0, 0.0, 6.0) / 3.0 - 1.0


def _plain_x(points, queries, *args):
    return mfv_x_plain(points, queries, *args)[0]


def apply_dpdist(params, cfg: DPDistConfig, pcA, pcB):
    """Bidirectional forward: (pred_AB, pred_BA), each (B, N, output_channels).

    `params` is the port's decoder state (train.params_from_jax). The
    reference's encoder-input noise (a training feature) is not ported.
    """
    mode = fused_gather_mode(cfg, pcA.device)
    pcA = pcA.to(torch.float32).contiguous()
    pcB = pcB.to(torch.float32).contiguous()
    dec = params["decoder"]
    args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
    _, maskAB, _ = voxel_assign(pcB, cfg.grid_size)
    _, maskBA, _ = voxel_assign(pcA, cfg.grid_size)
    if mode == "mfv" and pcA.shape == pcB.shape:
        # Both directions in one kernel call: encode [A; B], query [B; A].
        x2 = mfv_table_gather_x(torch.cat([pcA, pcB]), torch.cat([pcB, pcA]), *args)
        yAB, yBA = torch.chunk(mlp_apply(dec, x2), 2, dim=0)
    else:
        # BN off: each decoder row is independent, so the directions
        # decode separately.
        x_of = mfv_table_gather_x if mode == "mfv" else _plain_x
        yAB = mlp_apply(dec, x_of(pcA, pcB, *args))   # B's points vs surface(A)
        yBA = mlp_apply(dec, x_of(pcB, pcA, *args))   # A's points vs surface(B)

    pred_AB = _output_activation(yAB, cfg.output_act) * maskAB[..., None]
    pred_BA = _output_activation(yBA, cfg.output_act) * maskBA[..., None]
    return pred_AB, pred_BA


def dpdist_distance(params, cfg: DPDistConfig, pcA, pcB, *,
                    per_example: bool = False):
    """(mean(pred_AB[..., 0]) + mean(pred_BA[..., 0])) / 2, over the batch
    or, with per_example=True, per pair as a (B,) tensor."""
    pred_AB, pred_BA = apply_dpdist(params, cfg, pcA, pcB)
    if per_example:
        return (torch.mean(pred_AB[..., 0], dim=-1) + torch.mean(pred_BA[..., 0], dim=-1)) / 2.0
    return (torch.mean(pred_AB[..., 0]) + torch.mean(pred_BA[..., 0])) / 2.0
