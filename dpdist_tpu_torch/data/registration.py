"""Registration data: the corruptions of a source cloud (port of
add_noise_np and add_occlusions_np from dpdist_tpu/data/registration.py;
its templates, poses and datasets come with the registration slice).

Both are numpy with an explicit generator, drawing in the reference's
order, so the same generator state gives the same arrays in both
packages. DPDistTrainer uses add_occlusions_np for encoder occlusion.
"""

from __future__ import annotations

import numpy as np


def add_noise_np(source: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-point gaussian noise with a random per-point sigma in [0, 0.04)
    (helper.add_noise, helper.py:464-470)."""
    out = source.copy()
    for i in range(out.shape[0]):
        sigma = 0.04 * rng.uniform(size=(out.shape[1], 1))
        out[i] += sigma * rng.standard_normal(out[i].shape)
    return out.astype(np.float32)


def add_occlusions_np(source: np.ndarray, fraction: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Remove the kNN ball of int(N * fraction) points around a random
    point of each cloud and refill it by resampling kept points, so the
    cloud keeps its size (helper.add_occlusions, helper.py:963-982)."""
    B, N, _ = source.shape
    if not 0.0 <= fraction < 1.0:
        raise ValueError(f"occlusion fraction must be in [0, 1), got {fraction}")
    n_drop = int(N * fraction)
    if n_drop == 0:
        return source
    out = np.empty_like(source)
    for i in range(B):
        c = source[i, rng.integers(N)]
        d = np.linalg.norm(source[i] - c, axis=1)
        keep = np.argsort(d)[n_drop:]
        refill = rng.choice(keep, size=N, replace=True)
        refill[: len(keep)] = keep
        out[i] = source[i, refill]
    return out
