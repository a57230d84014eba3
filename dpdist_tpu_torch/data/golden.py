"""Golden distance pairs: seeded synthetic clouds with reference distances.

The file assets/golden_distance.json lists each pair as two
(family, seed) surfaces times a scale. At its `num_point` points it holds,
per committed net, the per-pair distance the JAX package computes and its
frozen loss; its "np256" section holds the same at 256 points, and the
pairs' chamfer and EMD; its "bf16" section holds the distances served in
bfloat16 ("full" and "auto") at 64 and 256 points, and its "bf16_grad"
section the frozen loss in bfloat16 and its gradient at 64 and 256 points;
its "fp16" and "fp16_grad" sections hold the same in float16 (the
distances by JAX's plain composition, "off", and its table kernels,
"table").

assets/golden_aue.json holds JAX's outputs for the autoencoders, the 3dmfv
PCRNet and compare_losses (tests/test_torch_aue.py writes it); its batches
are dataset batches of seeded synthetic surfaces (aue_batch).

assets/golden_variants.json holds JAX's outputs for the DPDist variants at
full width from seeded weights (tests/test_torch_variants.py writes it):
forwards of the first pairs of golden_distance.json (variant_clouds) in
float32, bfloat16 and float16, a few train steps on a seeded batch
(dpdist_train_batch) in float32 and float16, and a dense
distance field's subsample on a committed net (dense_field_queries). Its
forwards run on the seeded weights made informative (informative_weights):
at init the decoder's first layer is so small against the FV entries that
every output sits within ~1e-3 of 0.15, below the bf16 bound, so a wrong
patch would pass unseen.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from dpdist_tpu_torch.data.synthetic import synthetic_surface
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

GOLDEN_PATH = Path(__file__).resolve().parent.parent / "assets" / "golden_distance.json"
AUE_GOLDEN_PATH = GOLDEN_PATH.with_name("golden_aue.json")
VARIANTS_GOLDEN_PATH = GOLDEN_PATH.with_name("golden_variants.json")


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


def variant_clouds(spec: dict, dims: int = 3):
    """(pcA, pcB), each (P, n, dims) float32: the golden-distance pairs of
    spec ({"pairs", "num_point"}), in 2-D their first two coordinates."""
    pcA, pcB = golden_clouds(spec)
    return np.ascontiguousarray(pcA[..., :dims]), np.ascontiguousarray(pcB[..., :dims])


def dpdist_train_batch(spec: dict):
    """A seeded DPDist dataset batch in the reference's layout: (B, 6N, 3)
    points uniform in [-0.9, 0.9] and (B, 4N) labels uniform in [0, 0.3].
    spec: {"seed", "batch_size", "num_point"}."""
    r = np.random.default_rng(spec["seed"])
    B, N = spec["batch_size"], spec["num_point"]
    data = r.uniform(-0.9, 0.9, (B, 6 * N, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (B, 4 * N)).astype(np.float32)
    return data, labels


def informative_weights(params, state, spec: dict):
    """(params, state) with the decoder's first layer (the MLP's layer 0,
    or the conv decoder's conv0) scaled by spec["gain"], spec["shift"]
    added to its output layer's bias (as init adds 0.45), and every BN
    scale and var redrawn uniform in [0.75, 1.25], every offset and mean
    normal with sd 0.05, from numpy seeded with spec["seed"] in the trees'
    order; the rest is kept. Each new leaf is made on the host and copied
    to its tensor's device, so every device builds the same weights. The
    gain lifts the input-dependent spread of the outputs from ~1e-3 to a
    few tenths and the shift centres them (the golden file records both
    per variant); the BN draws take eval-mode BN away from the identity."""
    r = np.random.default_rng(spec["seed"])

    def redraw(node, key=None):
        if isinstance(node, dict):
            return {k: redraw(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [redraw(v) for v in node]
        shape = tuple(node.shape)
        if key in ("scale", "var"):
            new = r.uniform(0.75, 1.25, shape)
        elif key in ("offset", "mean"):
            new = r.normal(0.0, 0.05, shape)
        else:
            return node
        return torch.as_tensor(new.astype(np.float32), device=node.device)

    params, state = redraw(params), redraw(state)
    dec = params["decoder"]
    if "conv0" in dec:
        first, head = dec["conv0"], dec["out"]
    else:
        first, head = dec["layers"][0], dec["layers"][-1]
    first["w"] = first["w"] * float(spec["gain"])
    head["b"] = head["b"] + float(spec["shift"])
    return params, state


def state_sample(state, n: int) -> dict:
    """Per BN state leaf (tensors or arrays), n entries evenly spaced as
    float64 numpy arrays: how the golden file stores a state."""
    out = {}
    for p, t in tree_flatten_with_paths(state):
        v = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        v = v.reshape(-1).astype(np.float64)
        out[p] = v[np.linspace(0, v.size - 1, n).astype(int)]
    return out


def state_gap(got: dict, want: dict) -> float:
    """Over the leaves of two state samples, the largest |got - want| over
    the larger of 1 and the leaf's largest |want| entry (0 without BN)."""
    return max([float(np.abs(np.asarray(got[p]) - np.asarray(w)).max()
                      / max(1.0, float(np.abs(np.asarray(w)).max()))) for p, w in want.items()]
               or [0.0])


def output_spread(preds) -> float:
    """max - min over golden prediction samples (nested lists or arrays)."""
    a = np.concatenate([np.asarray(p, np.float64).reshape(-1) for p in preds])
    return float(a.max() - a.min())


# float16's edge values, on which a float16 output must round as a cast
# does: the largest finite (65,504) and what rounds down to it, a tie
# (65,520) and beyond, to inf; the smallest normal and the subnormals with
# their ties (2^-25 to 0, 1.5 * 2^-24 to 2^-23); ties between normals
# (1 + 2^-11 to 1, 1 + 3 * 2^-11 to 1 + 2^-9).
FP16_EDGES = np.array([65504.0, 65505.0, 65519.99, 65520.0, 65536.0, 1e5, 2.0 ** -24,
                       2.0 ** -25, 1.5 * 2.0 ** -24, 2.5 * 2.0 ** -24, 2.0 ** -14,
                       2.0 ** -14 - 2.0 ** -25, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1e-9,
                       0.1, 1.0 / 3.0, 1024.5, 2049.0, 3.0], np.float32)


def half_ulp(exact: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of `dtype` (bfloat16 or float16) at each value of `exact`
    rounded to it, in float64: 2^(e - 8) or 2^(e - 11) for 2^(e - 1) <= |x|
    < 2^e, and float16's subnormal step 2^-24 below its smallest normal."""
    rounded = exact.double().to(dtype).double()
    bits = 8 if dtype == torch.bfloat16 else 11
    ulp = torch.ldexp(torch.ones_like(rounded), torch.frexp(rounded)[1] - bits)
    return ulp if dtype == torch.bfloat16 else ulp.clamp_min(2.0 ** -24)


def beyond_one_ulp(got: torch.Tensor, exact: torch.Tensor, f32: torch.Tensor = None) -> int:
    """Entries of a bf16 or fp16 sum `got` more than one ulp of its dtype
    from the float64 sums `exact`; with `f32` (the same sums in float32,
    which a two-byte sum rounds once), beyond that and the float32 sums'
    own distance from `exact`: where a sum cancels to near 0, float32's
    rounding of it can pass float16's finest steps."""
    exact = exact.double()
    allowed = half_ulp(exact, got.dtype)
    if f32 is not None:
        allowed = allowed + (f32.double() - exact).abs()
    return int(((got.double() - exact).abs() > allowed).sum())


def dense_field_queries(spec: dict):
    """(cloud (1, M, 3), all grid queries (R^3, 3), the subsample's flat
    indices) of a dense golden spec ({"family", "seed", "n_points",
    "scale", "resolution", "extent", "stride", "count"}); the queries in
    distance_field's order (meshgrid "ij", z fastest)."""
    cloud = synthetic_surface(spec["family"], seed=spec["seed"], n_points=spec["n_points"])
    R = spec["resolution"]
    r = np.linspace(-spec["extent"], spec["extent"], R).astype(np.float32)
    q = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    index = np.arange(0, R ** 3, spec["stride"])[:spec["count"]]
    return (cloud[None] * spec["scale"]).astype(np.float32), q, index
