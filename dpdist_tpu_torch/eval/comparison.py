"""Distance-comparison harness: DPDist against chamfer and EMD on
controlled perturbation sweeps (port of dpdist_tpu/eval/comparison.py).

The paper's claim (README.md:7-9): the learned distance responds to
surface deviation rather than to sampling, so two samplings of one
surface score about 0 while a genuine geometric perturbation grows the
distance monotonically. perturbation_sweep scores cloud pairs under
growing perturbation with all three metrics.

The draws are the reference's: one np.random.default_rng(seed) stream,
taken in the same order (per magnitude, per surface: a permutation, then
the perturbation's own draws), so the per-magnitude means match JAX's.
Each pair is scored alone (B = 1), a pure forward: on the card the DPDist
distance takes its default route (the fused encode + gather kernel at 64
points), chamfer and EMD the plain paths at these sizes.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.models.dpdist import dpdist_distance
from dpdist_tpu_torch.ops.chamfer import chamfer_distance
from dpdist_tpu_torch.ops.emd import earth_mover_distance

KINDS = ("resample", "noise", "deform", "translate", "occlude")


@torch.no_grad()
def perturbation_sweep(params, cfg: DPDistConfig, surfaces, *, kind: str = "deform",
                       magnitudes: Sequence[float] = (0.0, 0.02, 0.05, 0.1, 0.2),
                       num_point: int = 64, seed: int = 0, device="cuda", state=None) -> Dict:
    """Score cloud pairs under growing perturbation with all 3 metrics.

    params, state: the port's DPDist params and BN state (params_from_jax;
      state None for a net without BN) on `device`.
    surfaces: (M, P, 3) dense surfaces (P >= 2 * num_point). For each
      magnitude, pcA is one sampling, pcB an independent sampling perturbed
      by `kind`:
        'resample' : none (a different sampling only; magnitude ignored)
        'noise'    : gaussian jitter of scale m
        'deform'   : low-frequency sinusoidal warp of amplitude m
        'translate': rigid shift by m along a random direction
        'occlude'  : kNN-ball removal + duplicate refill, fraction m

    Returns {"magnitudes": [...], "dpdist": [...], "chamfer": [...],
    "emd": [...]} with per-magnitude mean scores.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    rng = np.random.default_rng(seed)
    M, P, _ = surfaces.shape
    N = num_point
    out = {"magnitudes": list(magnitudes), "dpdist": [], "chamfer": [], "emd": []}
    for m in magnitudes:
        scores = []
        for s in surfaces:
            idx = rng.permutation(P)
            pcA = s[idx[:N]]
            pcB = s[idx[N:2 * N]].copy()
            if kind == "noise":
                pcB = pcB + rng.normal(0, max(m, 1e-12), pcB.shape)
            elif kind == "deform":
                pcB = pcB + m * np.sin(2.0 * np.pi * pcB[:, [1, 2, 0]])
            elif kind == "translate":
                d = rng.normal(size=3)
                pcB = pcB + m * d / np.linalg.norm(d)
            elif kind == "occlude" and m > 0:
                # The occluded cloud still lies ON the surface: a surface
                # distance should stay near its resample floor while
                # chamfer and EMD read the missing ball as change.
                from dpdist_tpu_torch.data.registration import add_occlusions_np

                pcB = add_occlusions_np(pcB[None].astype(np.float32), min(m, 0.95), rng)[0]
            a = torch.as_tensor(pcA[None].astype(np.float32), device=device)
            b = torch.as_tensor(pcB[None].astype(np.float32), device=device)
            scores.append(torch.stack([dpdist_distance(params, cfg, a, b, state=state),
                                       chamfer_distance(a, b), earth_mover_distance(a, b)]))
        mean = torch.stack(scores).cpu().numpy().astype(np.float64).mean(0)
        for key, v in zip(("dpdist", "chamfer", "emd"), mean):
            out[key].append(float(v))
    return out


def monotonicity(values: Sequence[float]) -> float:
    """Fraction of consecutive increases: 1.0 means strictly responsive."""
    v = np.asarray(values)
    if len(v) < 2:
        return 1.0
    return float(np.mean(np.diff(v) > 0))
