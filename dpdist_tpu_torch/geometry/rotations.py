"""Batched rotation representations and conversions (port of
dpdist_tpu/geometry/rotations.py).

Conventions as the reference's:
  * Euler pose6 = (tx, ty, tz, rx, ry, rz), R = Rx @ Ry @ Rz (rotate about
    z first, then y, then x);
  * quaternions are (w, x, y, z), their matrix by the Besl-McKay formula;
  * the 6D representation's columns come from two raw vectors by
    Gram-Schmidt.

All functions broadcast over leading batch dimensions and are
differentiable. The pose algebra stays float32 with TF32 off (set when the
package is imported): the JAX package pins HIGHEST matmul precision here
because lower precision moved its acc@2.5 cells by 4-20 points.
"""

from __future__ import annotations

import math

import torch

_DEGREES = 180.0 / math.pi


def _stack3x3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rx(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[c, z, s], [z, o, z], [-s, z, c]])


def _rz(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


def euler_zyx_to_matrix(rx, ry, rz):
    """R = Rx(rx) @ Ry(ry) @ Rz(rz): rotate about z first, then y, then x."""
    return torch.matmul(torch.matmul(_rx(rx), _ry(ry)), _rz(rz))


def matrix_to_euler_zyx(R):
    """Inverse of euler_zyx_to_matrix; returns (rx, ry, rz). Where
    |cos ry| < 1e-7 (gimbal lock) rz is 0 and rx takes the whole turn."""
    r02 = torch.clamp(R[..., 0, 2], -1.0, 1.0)
    ry = torch.asin(r02)
    rx = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    rz = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    cy = torch.sqrt(torch.clamp(R[..., 0, 0] ** 2 + R[..., 0, 1] ** 2, min=0.0))
    degen = cy < 1e-7
    rx_d = torch.atan2(R[..., 2, 1], R[..., 1, 1])
    rx = torch.where(degen, rx_d, rx)
    rz = torch.where(degen, torch.zeros_like(rz), rz)
    return rx, ry, rz


def normalize_quat(q, eps: float = 1e-7):
    """Quaternion(s) (..., 4) over their norm plus eps (the reference's
    additive-epsilon form)."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)) + eps
    return q / n


def quat_to_matrix(q):
    """(w, x, y, z) quaternion(s) (..., 4) -> rotation matrix (..., 3, 3)."""
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3
    r11 = q0 * q0 + q2 * q2 - q1 * q1 - q3 * q3
    r22 = q0 * q0 + q3 * q3 - q1 * q1 - q2 * q2
    r01 = 2 * (q1 * q2 - q0 * q3)
    r02 = 2 * (q1 * q3 + q0 * q2)
    r10 = 2 * (q1 * q2 + q0 * q3)
    r12 = 2 * (q2 * q3 - q0 * q1)
    r20 = 2 * (q1 * q3 - q0 * q2)
    r21 = 2 * (q2 * q3 + q0 * q1)
    return _stack3x3([[r00, r01, r02], [r10, r11, r12], [r20, r21, r22]])


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z), by
    Shepperd's four cases chosen elementwise (trace, then the largest
    diagonal entry)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = tr > 0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    return normalize_quat(q, eps=0.0)


def quat_multiply(a, b):
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def rotation_6d_to_matrix(ortho6d):
    """6D rotation representation (..., 6) -> matrix whose columns are
    (x, y, z), built from the two raw vectors."""
    x_raw, y_raw = ortho6d[..., 0:3], ortho6d[..., 3:6]

    def _norm(v):
        return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True))

    x = _norm(x_raw)
    z = _norm(torch.linalg.cross(x, y_raw, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], -1)


def rotation_geodesic_error(R_pred, R_gt):
    """Axis-angle geodesic rotation error in degrees: the angle of
    R_pred^T @ R_gt, its cosine clipped to [-1, 1]."""
    M = torch.matmul(R_pred.transpose(-1, -2), R_gt)
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.acos(cos_theta) * _DEGREES
