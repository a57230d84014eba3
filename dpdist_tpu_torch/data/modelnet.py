"""Surface-pair dataset with ground-truth point-to-surface distances (port
of dpdist_tpu/data/modelnet.py, the data semantics of
modelnet_dataset.ModelNetDataset, modelnet_dataset.py:30-187). It is the
dataset DPDistTrainer.fit takes: reset(), has_next_batch() and
next_batch(augment=). For the same files and seed its batches are byte
for byte the reference's. It reads the on-disk layout that data/gtgen.py
writes (or real ModelNet40's):

  <root>/<class>/<id>_dist_c_scaled.txt          dense surface (10k x 3)
  <root>/<class>/<id>_10000_dist_c_neg_l.txt     near points + GT dist (10k x 4)
  <root>/<class>/<id>_10000_dist_c_neg_u.txt     far  points + GT dist (10k x 4)
  <root>/modelnet40_shape_names.txt, modelnet40_{train,test}.txt

Per __getitem__, like the reference (_get_item :98-146):
  * take the first `npoints` of each of surface / near / shuffled-far;
  * stack into (3*npoints, 3) and labels (2*npoints,) = [near_d, far_d];
  * shuffle all three blocks with one shared per-item index.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from dpdist_tpu_torch.data import augment as aug


class SurfacePairDataset:
    def __init__(self, root: str, *, batch_size: int = 16, npoints: int = 64,
                 split: str = "train", class_choice: Optional[Sequence[str]] = None,
                 shuffle: Optional[bool] = None, cache_size: int = 15000,
                 num_neg_points: Optional[int] = None, seed: int = 0):
        """num_neg_points: size of the near/far files; auto-detected from
        the first model's files when None (the reference hardcodes 10^4)."""
        assert split in ("train", "test")
        self.root = root
        self.batch_size = batch_size
        self.npoints = npoints
        self.split = split
        self.num_neg_points = num_neg_points
        self.rng = np.random.default_rng(seed)

        catfile = os.path.join(root, "modelnet40_shape_names.txt")
        self.cat = [l.rstrip() for l in open(catfile)]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

        ids = [l.rstrip() for l in open(os.path.join(root, f"modelnet40_{split}.txt"))]
        if isinstance(class_choice, str):
            class_choice = [class_choice]
        names, kept = [], []
        for x in ids:
            name = "_".join(x.split("_")[0:-1])
            if class_choice and name not in class_choice:
                continue
            names.append(name)
            kept.append(x)
        self.datapath = [
            (names[i], os.path.join(root, names[i], kept[i])) for i in range(len(kept))
        ]
        if num_neg_points is None and self.datapath:
            import glob as _glob
            import re as _re

            base = self.datapath[0][1]
            hits = _glob.glob(base + "_*_dist_c_neg_l.txt")
            if not hits:
                raise FileNotFoundError(
                    f"no GT-distance files next to {base}; run gen_data first"
                )
            num_neg_points = int(_re.search(r"_(\d+)_dist_c_neg_l",
                                            hits[0]).group(1))
        self.num_neg_points = num_neg_points
        self.cache: dict = {}
        self.cache_size = cache_size
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self.reset()

    # -- iteration ---------------------------------------------------------

    def reset(self):
        self.idxs = np.arange(len(self.datapath))
        if self.shuffle:
            self.rng.shuffle(self.idxs)
        self.num_batches = (len(self.datapath) + self.batch_size - 1) // self.batch_size
        self.batch_idx = 0

    def has_next_batch(self) -> bool:
        return self.batch_idx < self.num_batches

    def __len__(self):
        return len(self.datapath)

    # -- item loading ------------------------------------------------------

    def _load(self, index):
        from dpdist_tpu_torch.native import fast_loadtxt

        name, base = self.datapath[index]
        cls = np.array([self.classes[name]], np.int32)
        surface = fast_loadtxt(base + "_dist_c_scaled.txt", 3)
        surface = surface[: self.npoints * 1, :3]
        near = fast_loadtxt(base + f"_{self.num_neg_points}_dist_c_neg_l.txt", 4)
        far = fast_loadtxt(base + f"_{self.num_neg_points}_dist_c_neg_u.txt", 4)
        # Shuffle the far set so the 10% outside-unit-sphere tail mixes in
        # (modelnet_dataset.py:130-134).
        far = far[self.rng.permutation(len(far))]
        n = self.npoints
        point_set = np.concatenate([surface[:n], near[:n, :3], far[:n, :3]], 0)
        labels = np.concatenate([near[:n, 3], far[:n, 3]], 0)
        return point_set.astype(np.float32), cls, labels.astype(np.float32)

    def _get_item(self, index):
        if index in self.cache:
            point_set, cls, labels = self.cache[index]
        else:
            point_set, cls, labels = self._load(index)
            if len(self.cache) < self.cache_size:
                self.cache[index] = (point_set, cls, labels)
        # Per-item co-shuffle of points and labels with one shared index
        # (modelnet_dataset.py:99-111).
        n = self.npoints
        shuf = self.rng.permutation(n)
        ps = point_set.reshape(3, n, 3)[:, shuf].reshape(3 * n, 3)
        lb = labels.reshape(2, n)[:, shuf].reshape(2 * n)
        return ps, cls, lb

    def next_batch(self, augment: bool = False):
        """Returns (B, 3*npoints, 3) data + (B, 2*npoints) GT distances."""
        start = self.batch_idx * self.batch_size
        end = min((self.batch_idx + 1) * self.batch_size, len(self.datapath))
        bsize = end - start
        data = np.zeros((bsize, self.npoints * 3, 3), np.float32)
        labels = np.zeros((bsize, self.npoints * 2), np.float32)
        for i in range(bsize):
            ps, _, lb = self._get_item(int(self.idxs[start + i]))
            data[i] = ps
            labels[i] = lb
        self.batch_idx += 1
        if augment:
            data = aug.augment_batch(data, self.rng)
        return data, labels
