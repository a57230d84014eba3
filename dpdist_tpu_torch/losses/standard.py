"""Losses (port of dpdist_tpu/losses/standard.py): DPDist's own training
losses, and the chamfer and EMD losses of ops/chamfer.py and ops/emd.py."""

from __future__ import annotations

import torch

from dpdist_tpu_torch.ops.chamfer import chamfer_distance
from dpdist_tpu_torch.ops.emd import earth_mover_distance


def l1_sample_loss(pred_AB, labels_AB):
    """L1 between channel-0 predictions (B, N, C) and ground-truth
    point-to-surface distances (B, N): DPDist's own training loss."""
    return torch.mean(torch.abs(pred_AB[..., 0] - labels_AB))


def pred_mean_loss(pred_AB, pred_BA):
    """The symmetric mean prediction, (mean(pred_AB[..., 0]) + mean(pred_BA[..., 0])) / 2."""
    return (torch.mean(pred_AB[..., 0]) + torch.mean(pred_BA[..., 0])) / 2.0


def chamfer_loss(pc1, pc2, *, sqrt: bool = True):
    return chamfer_distance(pc1, pc2, sqrt=sqrt)


def emd_loss(pc1, pc2, *, iters: int = 50):
    return earth_mover_distance(pc1, pc2, iters=iters)
