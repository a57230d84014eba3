"""Golden distance pairs: seeded synthetic clouds with reference distances.

The file assets/golden_distance.json lists each pair as two
(family, seed) surfaces times a scale. At its `num_point` points it holds,
per committed net, the per-pair distance the JAX package computes and its
frozen loss; its "np256" section holds the same at 256 points, and the
pairs' chamfer and EMD; its "bf16" section holds the distances served in
bfloat16 ("full" and "auto") at 64 and 256 points, and its "bf16_grad"
section the frozen loss in bfloat16 and its gradient at 64 and 256 points.

assets/golden_aue.json holds JAX's outputs for the autoencoders, the 3dmfv
PCRNet and compare_losses (tests/test_torch_aue.py writes it); its batches
are dataset batches of seeded synthetic surfaces (aue_batch).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dpdist_tpu_torch.data.synthetic import synthetic_surface

GOLDEN_PATH = Path(__file__).resolve().parent.parent / "assets" / "golden_distance.json"
AUE_GOLDEN_PATH = GOLDEN_PATH.with_name("golden_aue.json")


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


def aue_batch(spec: dict) -> np.ndarray:
    """A dataset batch (B, 6N, 3) in the reference's layout for the AUE
    trainer: item i's surface block holds 2N points of synthetic surface
    (families[i % len], seed0 + i) times scale; the near and far blocks,
    which the AUE never reads, are zeros. spec: {"families", "seed0",
    "scale", "batch_size", "num_point"}."""
    B, N = spec["batch_size"], spec["num_point"]
    fams = spec["families"]
    surf = np.stack([synthetic_surface(fams[i % len(fams)], seed=spec["seed0"] + i,
                                       n_points=2 * N) * spec["scale"] for i in range(B)])
    return np.concatenate([surf, np.zeros((B, 4 * N, 3))], axis=1).astype(np.float32)
