"""Point-cloud augmentations (numpy, explicit RNG): the port's copy of
dpdist_tpu/data/augment.py, so that it needs nothing of the JAX package;
the same generator state gives the same arrays in both.

Parity with the original provider.py:20-234. Every function takes an
explicit np.random.Generator so data pipelines are reproducible.
All functions operate on (B, N, 3) float arrays and return float32.
"""

from __future__ import annotations

import numpy as np


def rotate_point_cloud(batch, rng):
    """Random rotation about the Y (up) axis per cloud (provider.py:32-49)."""
    out = np.empty_like(batch, dtype=np.float32)
    for k in range(batch.shape[0]):
        a = rng.uniform() * 2 * np.pi
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        out[k] = batch[k] @ R
    return out


def rotate_point_cloud_z(batch, rng):
    """Random rotation about the Z axis per cloud (provider.py:51-68)."""
    out = np.empty_like(batch, dtype=np.float32)
    for k in range(batch.shape[0]):
        a = rng.uniform() * 2 * np.pi
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        out[k] = batch[k] @ R
    return out


def rotate_point_cloud_by_angle(batch, angle):
    """Y-axis rotation by a fixed angle (provider.py:89-106)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return (batch @ R).astype(np.float32)


def rotate_perturbation_point_cloud(batch, rng, angle_sigma=0.06, angle_clip=0.18):
    """Small random xyz-euler perturbation (provider.py:128-149)."""
    out = np.empty_like(batch, dtype=np.float32)
    for k in range(batch.shape[0]):
        a = np.clip(angle_sigma * rng.standard_normal(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])], [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0], [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        out[k] = batch[k] @ R  # the reference right-multiplies R (provider.py:183-184)
    return out


def jitter_point_cloud(batch, rng, sigma=0.01, clip=0.05):
    """Per-point gaussian jitter (provider.py:151-163)."""
    noise = np.clip(sigma * rng.standard_normal(batch.shape), -clip, clip)
    return (batch + noise).astype(np.float32)


def shift_point_cloud(batch, rng, shift_range=0.1):
    """Per-cloud random translation (provider.py:165-177)."""
    shifts = rng.uniform(-shift_range, shift_range, (batch.shape[0], 1, 3))
    return (batch + shifts).astype(np.float32)


def random_scale_point_cloud(batch, rng, scale_low=0.8, scale_high=1.25):
    """Per-cloud random uniform scale (provider.py:179-191)."""
    scales = rng.uniform(scale_low, scale_high, (batch.shape[0], 1, 1))
    return (batch * scales).astype(np.float32)


def random_point_dropout(batch, rng, max_dropout_ratio=0.875):
    """Randomly duplicate the first point over dropped points (provider.py:20-30)."""
    out = batch.astype(np.float32).copy()
    for b in range(batch.shape[0]):
        ratio = rng.uniform() * max_dropout_ratio
        drop = np.where(rng.uniform(size=batch.shape[1]) <= ratio)[0]
        if len(drop) > 0:
            out[b, drop] = out[b, 0]
    return out


def shuffle_points(batch, rng):
    """Shuffle points (same permutation across the batch, provider.py:~70)."""
    idx = rng.permutation(batch.shape[1])
    return batch[:, idx].astype(np.float32)


def rotate_point_cloud_with_normal(batch_xyz_normal, rng):
    """Random Y-axis rotation of xyz AND normals, (B, N, 6)
    (provider.py:72-91). Returns a new array (the reference mutates)."""
    out = np.array(batch_xyz_normal, dtype=np.float32, copy=True)
    for k in range(out.shape[0]):
        a = rng.uniform() * 2 * np.pi
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        out[k, :, 0:3] = out[k, :, 0:3] @ R
        out[k, :, 3:6] = out[k, :, 3:6] @ R
    return out


def rotate_perturbation_point_cloud_with_normal(batch, rng, angle_sigma=0.06,
                                                angle_clip=0.18):
    """Small random xyz-euler perturbation of xyz AND normals, (B, N, 6)
    (provider.py:92-117)."""
    out = np.empty_like(batch, dtype=np.float32)
    for k in range(batch.shape[0]):
        a = np.clip(angle_sigma * rng.standard_normal(3), -angle_clip, angle_clip)
        Rx = np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])], [0, np.sin(a[0]), np.cos(a[0])]])
        Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0], [-np.sin(a[1]), 0, np.cos(a[1])]])
        Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0], [np.sin(a[2]), np.cos(a[2]), 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        out[k, :, 0:3] = batch[k, :, 0:3] @ R
        out[k, :, 3:6] = batch[k, :, 3:6] @ R
    return out


def rotate_point_cloud_by_angle_with_normal(batch, angle):
    """Fixed-angle Y-axis rotation of xyz AND normals, (B, N, 6)
    (provider.py:138-160)."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    out = np.array(batch, dtype=np.float32, copy=True)
    out[:, :, 0:3] = batch[:, :, 0:3] @ R
    out[:, :, 3:6] = batch[:, :, 3:6] @ R
    return out


def shuffle_data(data, labels, rng):
    """Co-shuffle (data, labels) along the batch axis; returns the
    permutation too (provider.py:8-18)."""
    idx = rng.permutation(len(labels))
    return data[idx, ...], labels[idx], idx


def augment_batch(batch, rng):
    """The reference's default train-time pipeline: y-rotation + shift
    (modelnet_dataset._augment_batch_data:82-95)."""
    rotated = rotate_point_cloud(batch, rng)
    return shift_point_cloud(rotated, rng)
