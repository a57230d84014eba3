"""Voxel-grid operations for the DPDist implicit decoder, plain PyTorch
(port of dpdist_tpu/ops/voxel.py: grid_centers, voxel_assign,
extract_patches, extract_patches_2d, gather_patches, point_cloud_to_volume
and volume_to_point_cloud; and of neighbor_ids from
dpdist_tpu/kernels/gather_pallas.py).

Cells are strict below and inclusive above along each axis
(u = (x+1)/step, idx = ceil(u) - 1); the flat cell index is in meshgrid
order, v = iy*g^2 + ix*g + iz in 3-D and v = iy*g + ix in 2-D. Points
outside [-1, 1]^D read cell 0 and take their delta from cell 0's centre;
the decoder output is masked for them afterwards. The patch gather is an
indexed gather, which gives the same values as the reference's one-hot
matmul. The 2-D patches are SAME-padded, as the 3-D ones: the JAX
package's recorded choice (the original's 2-D path used VALID padding).
"""

from __future__ import annotations

import numpy as np
import torch


def grid_centers(num_voxels: int, dims: int = 3) -> np.ndarray:
    """(V, D) cell centers in the reference's flat (meshgrid) order."""
    if dims == 2:
        g = int(np.floor(np.sqrt(num_voxels)))
        step = 2.0 / g
        l = np.arange(-1, 1, step) + step / 2
        X, Y = np.meshgrid(l, l)
        return np.stack([X, Y], -1).reshape(-1, 2).astype(np.float32)
    g = int(np.ceil(num_voxels ** (1.0 / 3.0)))
    step = 2.0 / g
    l = np.arange(-1, 1, step) + step / 2
    X, Y, Z = np.meshgrid(l, l, l)
    return np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)


def voxel_assign(points: torch.Tensor, grid_size: int):
    """Assign each point to its containing grid cell.

    Args:
      points: (..., N, D) coordinates, D in {2, 3}.
      grid_size: g cells per axis over [-1, 1].

    Returns:
      vox:   (..., N) int32 flat cell index (iy*g^2 + ix*g + iz, or
             iy*g + ix in 2-D), 0 for points outside the grid.
      mask:  (..., N) 1.0 if the point lies inside the grid, in points' dtype.
      delta: (..., N, D) point minus its cell center (cell 0's if outside).
    """
    g = grid_size
    D = points.shape[-1]
    if D not in (2, 3):
        raise ValueError(f"points must be 2-D or 3-D, got D={D}")
    step = 2.0 / g
    u = (points + 1.0) / step                        # cell i covers (i, i+1]
    idx = torch.ceil(u).to(torch.int32) - 1          # (..., N, D)
    inside = torch.all((u > 0.0) & (idx <= g - 1), dim=-1)
    idx = torch.clamp(idx, 0, g - 1)
    if D == 2:
        vox = idx[..., 1] * g + idx[..., 0]
    else:
        vox = idx[..., 1] * (g * g) + idx[..., 0] * g + idx[..., 2]
    mask = inside.to(points.dtype)
    vox = torch.where(inside, vox, torch.zeros_like(vox))
    centers = torch.as_tensor(grid_centers(g ** D, D), dtype=points.dtype,
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


def extract_patches_2d(volume_features: torch.Tensor, grid_size: int, k: int) -> torch.Tensor:
    """The 2-D analog of extract_patches: (B, g^2, C) -> (B, g^2, k^2 * C),
    k^2 neighbourhoods with SAME (zero) padding, offset-major then channel."""
    B, V, C = volume_features.shape
    g = grid_size
    if V != g ** 2:
        raise ValueError(f"volume has V={V} cells, expected g^2 = {g ** 2}")
    kh = k // 2
    vol = volume_features.reshape(B, g, g, C)
    padded = torch.nn.functional.pad(vol, (0, 0, kh, kh, kh, kh))
    slices = [padded[:, di:di + g, dj:dj + g, :] for di in range(k) for dj in range(k)]
    return torch.stack(slices, dim=3).reshape(B, V, k * k * C)


def point_cloud_to_volume(points, vsize: int = 12, radius: float = 1.0) -> torch.Tensor:
    """Binary occupancy voxelization of (N, 3) or (B, N, 3) points in
    [-radius, radius]: (vsize,)*3 or (B, vsize, vsize, vsize) float32, cell
    index int((x + radius) / voxel) clipped to the grid (pc_util.py:41-52)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    squeeze = pts.dim() == 2
    if squeeze:
        pts = pts[None]
    voxel = 2.0 * radius / float(vsize)
    loc = torch.clamp(((pts + radius) / voxel).to(torch.int64), 0, vsize - 1)
    flat = (loc[..., 0] * vsize + loc[..., 1]) * vsize + loc[..., 2]
    vol = torch.zeros((pts.shape[0], vsize ** 3), dtype=torch.float32, device=pts.device)
    vol.scatter_(1, flat, 1.0)
    vol = vol.reshape(pts.shape[0], vsize, vsize, vsize)
    return vol[0] if squeeze else vol


def volume_to_point_cloud(vol) -> np.ndarray:
    """The occupied cells' indices of a (vsize,)*3 volume as an (N, 3)
    float64 array, in argwhere order (pc_util.py:57-72)."""
    v = vol.detach().cpu().numpy() if isinstance(vol, torch.Tensor) else np.asarray(vol)
    vsize = v.shape[0]
    if v.shape[1] != vsize or v.shape[2] != vsize:
        raise ValueError(f"the volume must be a cube, got {v.shape}")
    pts = np.argwhere(v == 1)
    return pts.astype(np.float64) if len(pts) else np.zeros((0, 3))


def gather_patches(patch_table: torch.Tensor, vox: torch.Tensor) -> torch.Tensor:
    """Fetch each query point's voxel patch: (B, V, E), (B, N) -> (B, N, E).

    No mask is applied: outside points read cell 0's patch and the decoder
    output is masked later.
    """
    B, V, E = patch_table.shape
    index = vox.long()[..., None].expand(B, vox.shape[1], E)
    return torch.gather(patch_table, 1, index)


def neighbor_ids(vox: torch.Tensor, mask: torch.Tensor, grid_size: int, k: int) -> torch.Tensor:
    """(B, N) voxel ids -> (B, N, k^3) int32 flat ids of each query's
    window, -1 where the neighbour falls outside the grid or the query
    itself is off the grid (mask 0).

    Offsets run in extract_patches' order: row-major over (di, dj, dl),
    which shift the three digits of the flat id (v // g^2, v // g % g,
    v % g).
    """
    g = grid_size
    kh = k // 2
    v = vox.long()
    digits = torch.stack([v // (g * g), (v // g) % g, v % g], dim=-1)         # (B, N, 3)
    r = torch.arange(k, device=vox.device) - kh
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    nb = digits[..., None, :] + offs                                          # (B, N, k^3, 3)
    valid = ((nb >= 0) & (nb < g)).all(dim=-1) & (mask[..., None] > 0)
    nid = nb[..., 0] * (g * g) + nb[..., 1] * g + nb[..., 2]
    return torch.where(valid, nid, torch.full_like(nid, -1)).to(torch.int32)
