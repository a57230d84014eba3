"""Ground-truth distance dataset generation (port of dpdist_tpu/data/gtgen.py;
the original is dataset_sample_with_gt.py:60-139). Per model:
  * scale the dense 10k-point surface by 0.8;
  * sample candidates in batches of 50,000 and keep num_neg_points "near"
    points with min_eps < d < 2*eps (eps = 0.05) and num_neg_points "far"
    points with d > 2*eps, where d is the distance to the dense surface;
  * overwrite the last 10 % of the far set with cube points outside the
    unit sphere;
  * write three txt files: *_dist_c_scaled.txt (surface),
    *_<n>_dist_c_neg_l.txt (near + distance) and *_<n>_dist_c_neg_u.txt
    (far + distance), as the reference does (both near and far files are
    written; the original overwrote one with the other).

Like every entry point of the port, these functions run on the card
unless the caller passes device="cpu", and raise without a card.
`min_distances(query, dense, device=)` is the one step that runs on the
card: on CUDA it is row 8, kernels.chamfer.nn_min_sqdist on (1, Q, 3) x
(1, M, 3), then sqrt(max(., 0)); it raises rather than fall back. On the
CPU it keeps the reference's host precedence: the native library
(native/lib.py), then numpy. Every draw comes from the numpy generator in
the reference's order, so on the CPU, where both packages run the same
native source, the files are byte for byte the reference's. On the card a
distance may differ from the native one in its last bits (row 8 sums the
squares with FMAs), and a candidate whose distance lies at a threshold
may then fall on the other side of it.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.data.synthetic import stable_seed, synthetic_surface

CANDIDATES = 50000   # candidates per sampling round (dataset_sample_with_gt.py:88)
# numpy's path takes one (Q, M) product up to this many pairs, then tiles
# the queries (the reference's JAX tile of 8,192 rows has no counterpart
# on the host: numpy gives the same values at any tiling).
_NUMPY_PAIRS = 2 * 10 ** 8


def _min_distances_numpy(query: np.ndarray, dense: np.ndarray) -> np.ndarray:
    q = query.astype(np.float32)
    d = dense.astype(np.float32)
    d2 = np.sum(d * d, 1)[None, :]
    rows = max(1, _NUMPY_PAIRS // max(1, len(d)))
    out = np.empty(len(q), np.float32)
    for s in range(0, len(q), rows):
        qs = q[s:s + rows]
        sq = np.sum(qs * qs, 1)[:, None] + d2 - 2.0 * (qs @ d.T)
        out[s:s + rows] = np.sqrt(np.maximum(sq.min(1), 0.0))
    return out


def min_distances(query: np.ndarray, dense: np.ndarray, device="cuda") -> np.ndarray:
    """(Q,) float32 euclidean distance from each query point to the nearest
    point of the dense cloud; see the module docstring for the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist

        q = torch.as_tensor(np.ascontiguousarray(query, np.float32), device=dev)[None]
        p = torch.as_tensor(np.ascontiguousarray(dense, np.float32), device=dev)[None]
        with torch.no_grad():
            d = torch.sqrt(torch.clamp(nn_min_sqdist(q, p)[0], min=0.0))
        return d.cpu().numpy()
    if dev.type != "cpu":
        raise ValueError(f"min_distances runs on cpu or cuda, got {dev}")
    from dpdist_tpu_torch.native import min_distances_native

    native = min_distances_native(query, dense)
    if native is not None:
        return native
    return _min_distances_numpy(query, dense)


def _uniform_cube(rng, n):
    return rng.uniform(-1, 1, (n, 3))


#: Query-point sampling schemes (dataset_sample_with_gt.py:141-188). The
#: default, dropped_coordinates, samples the unit ball uniformly; all but
#: "cube" sample the unit ball.
SAMPLING_SCHEMES = ("dropped_coordinates", "cube", "muller", "polar", "exponential")


def uniform_sampling(rng: np.random.Generator, n: int,
                     scheme: str = "dropped_coordinates") -> np.ndarray:
    """(n, 3) query points by one of SAMPLING_SCHEMES, drawn as the
    reference draws them."""
    if scheme == "cube":
        return rng.uniform(-1, 1, (n, 3))
    if scheme == "dropped_coordinates":
        g = rng.standard_normal((5, n))
        norm = np.sqrt((g * g).sum(0))
        return (g[2:] / norm).T
    if scheme == "muller":
        g = rng.standard_normal((3, n))
        r = rng.uniform(size=n) ** (1.0 / 3.0)
        norm = np.sqrt((g * g).sum(0))
        return (r * g / norm).T
    if scheme == "polar":
        u = 2 * rng.uniform(size=n) - 1
        phi = 2 * np.pi * rng.uniform(size=n)
        r = rng.uniform(size=n) ** (1.0 / 3.0)
        z = r * u
        x = r * np.cos(phi) * (1.0 - z ** 2) ** 0.5
        y = r * np.sin(phi) * (1.0 - z ** 2) ** 0.5
        return np.stack([x, y, z], 1)
    if scheme == "exponential":
        g = rng.standard_normal((3, n))
        e = rng.exponential(0.5, n)
        denom = np.sqrt(e + (g * g).sum(0))
        return (g / denom).T
    raise ValueError(f"unknown sampling scheme {scheme!r}; choose from {SAMPLING_SCHEMES}")


def generate_gt_for_points(point_set: np.ndarray, *, eps: float = 0.05,
                           min_eps: float = 0.001, num_neg_points: int = 10 ** 4,
                           rng: np.random.Generator | None = None, scale: float = 0.8,
                           scheme: str = "dropped_coordinates", device="cuda"):
    """(scaled_surface, near_set, far_set) for one dense cloud; near and
    far are (num_neg_points, 4): xyz and the distance to the surface. The
    last 10 % of the far set are cube points outside the unit sphere, as
    the reference samples them whatever `scheme` is."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    surface = (point_set[:, :3] * scale).astype(np.float32)
    f = 2.0

    near_parts, far_parts = [], []
    n_near = n_far = 0
    while n_near < num_neg_points:
        cand = uniform_sampling(rng, CANDIDATES, scheme)
        d = min_distances(cand, surface, device)
        with_d = np.concatenate([cand, d[:, None]], -1).astype(np.float32)
        sel_near = (d > min_eps) & (d < f * eps)
        near_parts.append(with_d[sel_near])
        n_near += sel_near.sum()
        if n_far < num_neg_points:
            sel_far = d > f * eps
            far_parts.append(with_d[sel_far])
            n_far += sel_far.sum()
    near = np.concatenate(near_parts, 0)[:num_neg_points]
    far = np.concatenate(far_parts, 0)[:num_neg_points]

    n_out = int(num_neg_points * 0.1)
    outs = []
    n_o = 0
    while n_o < n_out:
        cand = _uniform_cube(rng, CANDIDATES)
        cand = cand[np.linalg.norm(cand, axis=1) > 1]
        d = min_distances(cand, surface, device)
        outs.append(np.concatenate([cand, d[:, None]], -1).astype(np.float32))
        n_o += len(cand)
    far[-n_out:] = np.concatenate(outs, 0)[:n_out]
    return surface, near, far


def write_reference_format(base_path: str, surface: np.ndarray, near: np.ndarray,
                           far: np.ndarray, num_neg_points: int = 10 ** 4) -> None:
    """Write the three txt files the dataset reads; base_path is the model's
    path without extension, e.g. '<root>/chair/chair_0001'."""
    np.savetxt(base_path + "_dist_c_scaled.txt", surface, fmt="%.6f", delimiter=",")
    np.savetxt(base_path + f"_{num_neg_points}_dist_c_neg_l.txt", near, fmt="%.6f",
               delimiter=",")
    np.savetxt(base_path + f"_{num_neg_points}_dist_c_neg_u.txt", far, fmt="%.6f",
               delimiter=",")


def generate_synthetic_dataset(root: str, *, families: Sequence[str] = ("chair",),
                               n_train: int = 8, n_test: int = 2, n_surface: int = 10000,
                               num_neg_points: int = 10 ** 4, eps: float = 0.05,
                               seed: int = 0, scheme: str = "dropped_coordinates",
                               device="cuda") -> None:
    """A ModelNet-layout synthetic dataset with ground-truth distances:
    <root>/<family>/<family>_NNNN_* files, modelnet40_shape_names.txt and
    modelnet40_{train,test}.txt, as the reference writes them."""
    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    train_ids, test_ids = [], []
    for fam in families:
        os.makedirs(os.path.join(root, fam), exist_ok=True)
        for i in range(n_train + n_test):
            sid = f"{fam}_{i + 1:04d}"
            rng = np.random.default_rng(seed + i * 1000 + stable_seed(fam) % 1000)
            dense = synthetic_surface(fam, seed=seed + i, n_points=n_surface)
            surface, near, far = generate_gt_for_points(
                dense, eps=eps, num_neg_points=num_neg_points, rng=rng, scheme=scheme,
                device=device)
            write_reference_format(os.path.join(root, fam, sid), surface, near, far,
                                   num_neg_points)
            (train_ids if i < n_train else test_ids).append(sid)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as fh:
        fh.write("\n".join(families) + "\n")
    with open(os.path.join(root, "modelnet40_train.txt"), "w") as fh:
        fh.write("\n".join(train_ids) + "\n")
    with open(os.path.join(root, "modelnet40_test.txt"), "w") as fh:
        fh.write("\n".join(test_ids) + "\n")
