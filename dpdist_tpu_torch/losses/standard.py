"""Losses of DPDist training (port of l1_sample_loss and pred_mean_loss
from dpdist_tpu/losses/standard.py; chamfer and EMD come with the port of
ops/chamfer.py and ops/emd.py)."""

from __future__ import annotations

import torch


def l1_sample_loss(pred_AB, labels_AB):
    """L1 between channel-0 predictions (B, N, C) and ground-truth
    point-to-surface distances (B, N): DPDist's own training loss."""
    return torch.mean(torch.abs(pred_AB[..., 0] - labels_AB))


def pred_mean_loss(pred_AB, pred_BA):
    """The symmetric mean prediction, (mean(pred_AB[..., 0]) + mean(pred_BA[..., 0])) / 2."""
    return (torch.mean(pred_AB[..., 0]) + torch.mean(pred_BA[..., 0])) / 2.0
