"""Golden distance pairs: seeded synthetic clouds with reference distances.

The file assets/golden_distance.json lists each pair as two
(family, seed) surfaces of `num_point` points times a scale, and, per
committed net, the per-pair distance the JAX package computes for it.
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


def golden_clouds(golden: dict):
    """(pcA, pcB), each (P, num_point, 3) float32, for the file's P pairs."""
    n = golden["num_point"]

    def cloud(spec):
        family, seed = spec
        return synthetic_surface(family, seed=seed, n_points=n)

    pcA = np.stack([cloud(p["a"]) * p["scale"] for p in golden["pairs"]])
    pcB = np.stack([cloud(p["b"]) * p["scale"] for p in golden["pairs"]])
    return pcA.astype(np.float32), pcB.astype(np.float32)
