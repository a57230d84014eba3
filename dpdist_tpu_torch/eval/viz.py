"""Plots and views (port of dpdist_tpu/eval/viz.py).

The AUE trainer's reconstruction snapshots
(train_multi_gpu_pc_compare_dist.py:574-590), the registration
evaluator's per-iteration error curves and error histograms
(results_itrPCRNet_no_stop.py:433-462), a cloud's three axis-aligned
density views (pc_util.point_cloud_three_views's stand-in, an image array
that needs no matplotlib) and a loss curve. The save_* functions are no-ops
returning None when matplotlib is unavailable and always use the Agg
backend (headless).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def save_cloud_pair(path: str, cloud_a, cloud_b, *, titles=("rec", "input"),
                    lim: float = 1.0) -> Optional[str]:
    """Side-by-side 3D scatter snapshot of two (N, 3) clouds."""
    plt = _plt()
    if plt is None:
        return None
    fig = plt.figure(figsize=(8, 4))
    for i, (pc, title) in enumerate(zip((cloud_a, cloud_b), titles)):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=2)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_zlim(-lim, lim)
        ax.set_title(title)
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def save_iteration_curves(path: str, rot_err: Sequence[float],
                          trans_err: Sequence[float],
                          conv_err: Optional[Sequence[float]] = None
                          ) -> Optional[str]:
    """Per-iteration registration error curves (plot_iter_graph parity)."""
    plt = _plt()
    if plt is None:
        return None
    fig, axes = plt.subplots(1, 3 if conv_err is not None else 2,
                             figsize=(12, 3.5))
    axes[0].plot(rot_err)
    axes[0].set_title("rotation error (deg)")
    axes[1].plot(trans_err)
    axes[1].set_title("translation error")
    if conv_err is not None:
        axes[2].semilogy(conv_err)
        axes[2].set_title("convergence measure")
    for ax in axes:
        ax.set_xlabel("iteration")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def save_error_histograms(path: str, rot_err_deg, trans_err) -> Optional[str]:
    """Rotation/translation error histograms (helper.log_test_results
    parity, helper.py:771-923)."""
    plt = _plt()
    if plt is None:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
    axes[0].hist(rot_err_deg, bins=36)
    axes[0].set_xlabel("rotation error (deg)")
    axes[1].hist(trans_err, bins=36)
    axes[1].set_xlabel("translation error")
    for ax in axes:
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def point_cloud_three_views(points, *, img_size: int = 128, radius: float = 1.0):
    """(img_size, 3 * img_size) float32 image in [0, 1]: the XY, XZ and YZ
    density projections of an (N, 3) cloud side by side, each view's
    counts over its largest (points outside [-radius, radius] dropped)."""
    pts = np.asarray(points.detach().cpu() if hasattr(points, "detach") else points)
    views = []
    for axes in ((0, 1), (0, 2), (1, 2)):
        img = np.zeros((img_size, img_size), np.float32)
        u = (pts[:, axes[0]] + radius) / (2 * radius) * (img_size - 1)
        v = (pts[:, axes[1]] + radius) / (2 * radius) * (img_size - 1)
        ok = (u >= 0) & (u < img_size) & (v >= 0) & (v < img_size)
        np.add.at(img, (v[ok].astype(int), u[ok].astype(int)), 1.0)
        m = img.max()
        views.append(img / m if m > 0 else img)
    return np.concatenate(views, axis=1)


def save_three_views(path: str, points) -> Optional[str]:
    """point_cloud_three_views as an image file."""
    plt = _plt()
    if plt is None:
        return None
    img = point_cloud_three_views(points)
    fig, ax = plt.subplots(figsize=(9, 3))
    ax.imshow(img, cmap="gray_r", origin="lower")
    ax.axis("off")
    fig.savefig(path, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return path


def save_loss_curve(path: str, losses: Sequence[float], *,
                    ylabel: str = "loss") -> Optional[str]:
    """A per-epoch loss curve."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(losses)
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path
