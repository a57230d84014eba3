"""Voxel-grid operations for the DPDist implicit decoder, plain PyTorch
(port of grid_centers, voxel_assign, extract_patches and gather_patches
from dpdist_tpu/ops/voxel.py).

Cells are strict below and inclusive above along each axis
(u = (x+1)/step, idx = ceil(u) - 1); the flat cell index is in meshgrid
order, v = iy*g^2 + ix*g + iz. Points outside [-1, 1]^3 read cell 0 and
take their delta from cell 0's centre; the decoder output is masked for
them afterwards. The patch gather is an indexed gather, which gives the
same values as the reference's one-hot matmul.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_centers(num_voxels: int) -> np.ndarray:
    """(V, 3) cell centers in the reference's flat (meshgrid) order."""
    g = int(np.ceil(num_voxels ** (1.0 / 3.0)))
    step = 2.0 / g
    l = np.arange(-1, 1, step) + step / 2
    X, Y, Z = np.meshgrid(l, l, l)
    return np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)


def voxel_assign(points: torch.Tensor, grid_size: int):
    """Assign each point to its containing grid cell.

    Args:
      points: (..., N, 3) coordinates.
      grid_size: g cells per axis over [-1, 1].

    Returns:
      vox:   (..., N) int32 flat cell index iy*g^2 + ix*g + iz,
             0 for points outside the grid.
      mask:  (..., N) 1.0 if the point lies inside the grid, in points' dtype.
      delta: (..., N, 3) point minus its cell center (cell 0's if outside).
    """
    g = grid_size
    if points.shape[-1] != 3:
        raise NotImplementedError(f"only 3-D points are ported, got {points.shape[-1]}")
    step = 2.0 / g
    u = (points + 1.0) / step                        # cell i covers (i, i+1]
    idx = torch.ceil(u).to(torch.int32) - 1          # (..., N, D)
    inside = torch.all((u > 0.0) & (idx <= g - 1), dim=-1)
    idx = torch.clamp(idx, 0, g - 1)
    vox = idx[..., 1] * (g * g) + idx[..., 0] * g + idx[..., 2]
    mask = inside.to(points.dtype)
    vox = torch.where(inside, vox, torch.zeros_like(vox))
    centers = torch.as_tensor(grid_centers(g ** 3), dtype=points.dtype,
                              device=points.device)
    delta = points - centers[vox.long()]
    return vox, mask, delta


def extract_patches(volume_features: torch.Tensor, grid_size: int, k: int) -> torch.Tensor:
    """k^3 neighborhood patches around every cell, SAME (zero) padding.

    Args:
      volume_features: (B, V, C) per-cell features, V = g^3 in flat order;
        the (B, V, C) -> (B, g, g, g, C) reshape splits the three digits
        of the flat index.
      grid_size: g.
      k: window size (odd).

    Returns:
      (B, V, k^3 * C) patches, flattened offset-major then channel.
    """
    B, V, C = volume_features.shape
    g = grid_size
    if V != g ** 3:
        raise ValueError(f"volume has V={V} cells, expected g^3 = {g ** 3}")
    kh = k // 2
    vol = volume_features.reshape(B, g, g, g, C)
    padded = torch.nn.functional.pad(vol, (0, 0, kh, kh, kh, kh, kh, kh))
    slices = []
    for di in range(k):
        for dj in range(k):
            for dl in range(k):
                slices.append(padded[:, di:di + g, dj:dj + g, dl:dl + g, :])
    patches = torch.stack(slices, dim=4)               # (B, g, g, g, k^3, C)
    return patches.reshape(B, V, k * k * k * C)


def gather_patches(patch_table: torch.Tensor, vox: torch.Tensor) -> torch.Tensor:
    """Fetch each query point's voxel patch: (B, V, E), (B, N) -> (B, N, E).

    No mask is applied: outside points read cell 0's patch and the decoder
    output is masked later.
    """
    B, V, E = patch_table.shape
    index = vox.long()[..., None].expand(B, vox.shape[1], E)
    return torch.gather(patch_table, 1, index)
