"""Registration data: templates, poses and the (template, source, gt_pose)
datasets (port of dpdist_tpu/data/registration.py).

Templates come from an h5 file ('templates' dataset, T x N x 3) when given,
else from the synthetic surface families. Poses are uniform in +-t_clip
and +-max_rotate_deg (generate_poses_ours.py), or read in order from a
fixed-pose CSV, the evaluator's protocol; the committed 5,070-pose set is
`default_eval_poses()`, a copy of the reference's in this package.

Everything is numpy with the dataset's own generator, drawing in the
reference's order, so the same seed gives the same batches, byte for byte,
in both packages. The trainers turn batches into tensors on their device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from dpdist_tpu_torch.data.synthetic import synthetic_surface


def generate_poses(num_poses: int, *, max_rotate_deg: float = 45.0, t_clip: float = 0.01,
                   gaussian: bool = False,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(num_poses, 6) poses: translation + euler radians, uniform in
    +-t_clip / +-max_rotate_deg (or gaussian with a third of each as its
    stddev)."""
    rng = rng or np.random.default_rng(0)
    if gaussian:
        t = rng.standard_normal((num_poses, 3)) * t_clip / 3.0
        d = rng.standard_normal((num_poses, 3)) * max_rotate_deg / 3.0 * np.pi / 180
    else:
        t = rng.uniform(-t_clip, t_clip, (num_poses, 3))
        d = rng.uniform(-max_rotate_deg, max_rotate_deg, (num_poses, 3)) * np.pi / 180
    return np.concatenate([t, d], 1).astype(np.float32)


def default_eval_poses() -> str:
    """Path of the committed 5,070-pose eval CSV (+-45 deg / +-0.01, seed
    2020), a byte-for-byte copy of the JAX package's asset. Evaluating a
    fixed pose set makes results comparable across methods and runs."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                        "eval_poses_45deg_5070.csv")


def apply_pose6_np(points: np.ndarray, pose6: np.ndarray) -> np.ndarray:
    """Batched numpy twin of geometry.apply_pose6 (Rz, then Ry, then Rx,
    then + t), bit-matching helper.apply_transformation."""
    out = np.empty_like(points, dtype=np.float32)
    for i in range(points.shape[0]):
        rx, ry, rz = pose6[i, 3], pose6[i, 4], pose6[i, 5]
        Rx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
        Ry = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0], [-np.sin(ry), 0, np.cos(ry)]])
        Rz = np.array([[np.cos(rz), -np.sin(rz), 0], [np.sin(rz), np.cos(rz), 0], [0, 0, 1]])
        out[i] = (Rx @ Ry @ Rz @ points[i].T).T + pose6[i, :3]
    return out


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


class PerturbedRegistrationDataset:
    """A RegistrationDataset whose sources get per-point noise and/or an
    occlusion after pose synthesis (the evaluator's --use_noise_data and
    --add_occlusions), drawn from the base dataset's generator."""

    def __init__(self, base, *, noise: bool = False, occlusion_fraction: float = 0.0):
        self.base = base
        self.noise = noise
        self.occlusion_fraction = occlusion_fraction

    def sample_batch(self, batch_size, **kw):
        out = self.base.sample_batch(batch_size, **kw)
        t, s, gt = out[:3]
        if self.noise:
            s = add_noise_np(s, self.base.rng)
        if self.occlusion_fraction > 0:
            s = add_occlusions_np(s, self.occlusion_fraction, self.base.rng)
        return (t, s, gt) + tuple(out[3:])


class RegistrationDataset:
    """Template library + pose sampler producing (template, source, gt_pose)."""

    def __init__(self, *, templates: Optional[np.ndarray] = None,
                 h5_path: Optional[str] = None, families: Sequence[str] = ("chair",),
                 n_templates: int = 16, num_point: int = 1024,
                 max_rotate_deg: float = 45.0, t_clip: float = 0.01, scale: float = 0.8,
                 seed: int = 0, sparse: int = 0, s_rand_points: float = 0.0,
                 centroid_sub: bool = True, poses: Optional[np.ndarray] = None,
                 pose_file: Optional[str] = None):
        """scale: synthetic templates are scaled x0.8, like the reference's
        registration data (the *_dist_c_scaled surfaces).

        poses / pose_file: the fixed-pose protocol. sample_batch then takes
        poses in order and cycles the templates in order (case i pairs
        template i % T with pose i).

        sparse / s_rand_points / centroid_sub: the reference's canonical
        experiment (SPARSE=1, SAMPLES=1.0, centroid_sub=0). With
        probability s_rand_points, template and source are disjoint random
        N-point subsets of one surface (sparse=1 pools the first 2N points,
        sparse=2 the first 4N); centroid_sub=False keeps the source's
        centroid."""
        self.rng = np.random.default_rng(seed)
        self.num_point = num_point
        self.max_rotate_deg = max_rotate_deg
        self.t_clip = t_clip
        self.sparse = int(sparse)
        self.s_rand_points = float(s_rand_points)
        self.centroid_sub = bool(centroid_sub)
        if pose_file is not None:
            from dpdist_tpu_torch.data.io import read_pose_csv

            poses = read_pose_csv(pose_file)
        self.poses = None if poses is None else np.asarray(poses, np.float32)
        self._pose_cursor = 0
        # Per-template family labels, for the evaluator's per-family report.
        self.template_families: Optional[list] = None
        if templates is not None:
            self.templates = templates.astype(np.float32)
        elif h5_path is not None:
            from dpdist_tpu_torch.data.io import read_templates_h5

            self.templates = read_templates_h5(h5_path)
        else:
            self.templates = np.stack([
                synthetic_surface(families[i % len(families)], seed=seed + i,
                                  n_points=max(num_point, 2048))
                for i in range(n_templates)
            ]) * scale
            self.template_families = [families[i % len(families)] for i in range(n_templates)]
        assert self.templates.shape[1] >= num_point
        if self.sparse > 0 and self.templates.shape[1] < 2 * self.sparse * num_point:
            raise ValueError(
                f"sparse={self.sparse} needs templates with >= {2 * self.sparse * num_point} "
                f"points, got {self.templates.shape[1]}")

    def _sample_sparse(self, template: np.ndarray, pose6: np.ndarray):
        """Pool the first 2*sparse*N points, one shared shuffle: template =
        first N, source = next N (disjoint), then pose the source."""
        N = self.num_point
        pool = template[:, : 2 * self.sparse * N]
        perm = self.rng.permutation(pool.shape[1])[: 2 * N]
        template_n = pool[:, perm[:N]]
        source_n = apply_pose6_np(np.ascontiguousarray(pool[:, perm[N:]]), pose6)
        return template_n, source_n

    def sample_batch(self, batch_size: int, *, random_points_prob: Optional[float] = None,
                     noise_prob: float = 0.0, occlusion_fraction: float = 0.0,
                     return_info: bool = False):
        """(template, source, gt_pose6) of batch_size cases.

        random_points_prob defaults to the dataset's s_rand_points.
        return_info=True appends {"template_idx", "family"}."""
        if random_points_prob is None:
            random_points_prob = self.s_rand_points
        if self.poses is not None:
            take = np.arange(self._pose_cursor, self._pose_cursor + batch_size)
            self._pose_cursor += batch_size
            idx = take % len(self.templates)
            pose6 = self.poses[take % len(self.poses)].copy()
        else:
            idx = self.rng.integers(0, len(self.templates), batch_size)
            pose6 = generate_poses(batch_size, max_rotate_deg=self.max_rotate_deg,
                                   t_clip=self.t_clip, rng=self.rng)
        template = self.templates[idx]
        info = None
        if return_info:
            fams = (None if self.template_families is None
                    else [self.template_families[i] for i in idx])
            info = {"template_idx": np.asarray(idx), "family": fams}

        def _ret(t, s, p):
            return (t, s, p, info) if return_info else (t, s, p)

        if self.sparse > 0:
            if self.rng.uniform() < random_points_prob:
                template_n, source_n = self._sample_sparse(template, pose6)
            else:
                # template and source are the same first N points, the
                # source posed (helper.split_template_source's else branch)
                template_n = template[:, : self.num_point]
                source_n = apply_pose6_np(template_n, pose6)
            if self.centroid_sub:
                c = source_n.mean(1, keepdims=True)
                source_n = source_n - c
                pose6 = pose6.copy()
                pose6[:, :3] -= c[:, 0, :]
            if self.rng.uniform() < noise_prob:
                source_n = add_noise_np(source_n, self.rng)
            if occlusion_fraction > 0:
                source_n = add_occlusions_np(source_n, occlusion_fraction, self.rng)
            return _ret(template_n.astype(np.float32), source_n.astype(np.float32), pose6)

        source = apply_pose6_np(template, pose6)
        # Translation is applied last in pose6, so folding the centroid
        # shift into the ground truth is exact.
        if self.centroid_sub:
            c = source.mean(1, keepdims=True)
            source = source - c
            pose6 = pose6.copy()
            pose6[:, :3] -= c[:, 0, :]

        N = self.num_point
        if self.rng.uniform() < random_points_prob:
            pt = self.rng.permutation(template.shape[1])[:N]
            ps = self.rng.permutation(source.shape[1])[:N]
            template_n, source_n = template[:, pt], source[:, ps]
        else:
            template_n, source_n = template[:, :N], source[:, :N]
        if self.rng.uniform() < noise_prob:
            source_n = add_noise_np(source_n, self.rng)
        if occlusion_fraction > 0:
            source_n = add_occlusions_np(source_n, occlusion_fraction, self.rng)
        return _ret(template_n.astype(np.float32), source_n.astype(np.float32), pose6)
