"""Golden distance pairs: seeded synthetic clouds with reference distances.

The file assets/golden_distance.json lists each pair as two
(family, seed) surfaces times a scale. At its `num_point` points it holds,
per committed net, the per-pair distance the JAX package computes and its
frozen loss; its "np256" section holds the same at 256 points, and the
pairs' chamfer and EMD.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dpdist_tpu_torch.data.synthetic import synthetic_surface

GOLDEN_PATH = Path(__file__).resolve().parent.parent / "assets" / "golden_distance.json"


def load_golden(path=GOLDEN_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def golden_clouds(golden: dict, num_point: int = None):
    """(pcA, pcB), each (P, n, 3) float32, for the file's P pairs at
    n = num_point points (default: the file's num_point)."""
    n = num_point or golden["num_point"]

    def cloud(spec):
        family, seed = spec
        return synthetic_surface(family, seed=seed, n_points=n)

    pcA = np.stack([cloud(p["a"]) * p["scale"] for p in golden["pairs"]])
    pcB = np.stack([cloud(p["b"]) * p["scale"] for p in golden["pairs"]])
    return pcA.astype(np.float32), pcB.astype(np.float32)
