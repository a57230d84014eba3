"""Batched SE(3) transforms (port of dpdist_tpu/geometry/se3.py).

Differentiable and on the device, so a refinement loop never copies a
pose to the host. float32 with TF32 off, as geometry/rotations.py says.
"""

from __future__ import annotations

import torch

from dpdist_tpu_torch.geometry.rotations import (
    euler_zyx_to_matrix,
    matrix_to_euler_zyx,
    normalize_quat,
    quat_to_matrix,
    rotation_geodesic_error,
)


def _homogeneous(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4) [[R, t], [0, 0, 0, 1]]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    # The bottom row by ops without Python scalars stored into a tensor,
    # which a loop traced for torch.export could not serialise.
    zeros = torch.zeros(R.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose6_to_matrix(pose6):
    """(..., 6) pose (tx, ty, tz, rx, ry, rz) -> (..., 4, 4)."""
    R = euler_zyx_to_matrix(pose6[..., 3], pose6[..., 4], pose6[..., 5])
    return _homogeneous(R, pose6[..., 0:3])


def pose7_to_matrix(pose7):
    """(..., 7) pose (tx, ty, tz, qw, qx, qy, qz) -> (..., 4, 4); the
    quaternion is normalized first."""
    R = quat_to_matrix(normalize_quat(pose7[..., 3:7]))
    return _homogeneous(R, pose7[..., 0:3])


def apply_pose6(points, pose6):
    """Points (..., N, 3) rotated by Rz, then Ry, then Rx, then translated."""
    R = euler_zyx_to_matrix(pose6[..., 3], pose6[..., 4], pose6[..., 5])
    return torch.matmul(points, R.transpose(-1, -2)) + pose6[..., None, 0:3]


def apply_quat(points, quat, translation):
    """Points (..., N, 3) rotated by a (w, x, y, z) quaternion and translated."""
    R = quat_to_matrix(quat)
    return torch.matmul(points, R.transpose(-1, -2)) + translation[..., None, :]


def apply_transform(points, T):
    """Points (..., N, 3) under a (..., 4, 4) homogeneous transform."""
    return torch.matmul(points, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def compose_transforms(T_new, T_prev):
    """One refinement step's accumulation: T_total = T_new @ T_prev."""
    return torch.matmul(T_new, T_prev)


def invert_transform(T):
    """Inverse of a (..., 4, 4) rigid transform, without a general solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -torch.matmul(Rt, T[..., :3, 3:4])[..., 0]
    return _homogeneous(Rt, ti)


def matrix_to_pose6(T):
    """(..., 4, 4) -> (..., 6) euler pose, inverse of pose6_to_matrix."""
    rx, ry, rz = matrix_to_euler_zyx(T[..., :3, :3])
    return torch.cat([T[..., :3, 3], torch.stack([rx, ry, rz], -1)], dim=-1)


def transform_errors(T_pred, T_gt):
    """(translation L2 error, geodesic rotation error in degrees)."""
    t_err = torch.linalg.vector_norm(T_pred[..., :3, 3] - T_gt[..., :3, 3], dim=-1)
    r_err = rotation_geodesic_error(T_pred[..., :3, :3], T_gt[..., :3, :3])
    return t_err, r_err


def convergence_measure(T, T_prev):
    """||T @ T_prev^{-1} - I||_F^2 per batch element."""
    M = torch.matmul(T, invert_transform(T_prev))
    d = M - torch.eye(4, dtype=T.dtype, device=T.device)
    return torch.sum(d * d, dim=(-1, -2))
