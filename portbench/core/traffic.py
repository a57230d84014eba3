"""Traffic: synthetic surfaces and the pools of cloud pairs a cell draws from.

The surface samplers are a frozen copy of the port's
`dpdist_tpu_torch/data/synthetic.py` (itself the JAX package's, the same
(family, seed) giving the same points), kept here so that the yardstick
cannot move with the program. One general generator, `pair_pool`, reads a
traffic file's parameters:

  families          surface families, drawn in turn
  surfaces          distinct surfaces in the pool
  surface_points    dense samples of each surface, from which each cloud
                    draws its points without replacement
  num_point         points in each cloud
  batch             pairs in one call
  pool_batches      distinct batches; call i takes batch i % pool_batches
  rotate            "uniform": the template under a uniformly random
                    rotation; "none": as sampled
  source_angle_deg  the source is the template's surface, sampled anew and
                    turned further about a random axis by an angle drawn
                    uniformly up to this (0: the template's pose)

Every seed gives the same sizes; the seed picks the surfaces, the samples
and the rotations. Unit-scaled surfaces lie in the unit ball, so every
rotated point stays on the [-1, 1]^3 grid.
"""

from __future__ import annotations

import numpy as np


def _unit_scale(pts: np.ndarray) -> np.ndarray:
    """Center and scale into the unit sphere (like ModelNet resampling)."""
    pts = pts - pts.mean(0, keepdims=True)
    r = np.max(np.linalg.norm(pts, axis=1))
    return (pts / max(r, 1e-9)).astype(np.float32)


def _sphere(n, rng, squash):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * squash


def _box(n, rng, half):
    # Sample faces proportionally to area.
    hx, hy, hz = half
    areas = np.array([hy * hz, hy * hz, hx * hz, hx * hz, hx * hy, hx * hy])
    face = rng.choice(6, size=n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    axis = face // 2
    for a in range(3):
        m = axis == a
        others = [i for i in range(3) if i != a]
        pts[m, a] = sign[m] * half[a]
        pts[m, others[0]] = u[m, 0] * half[others[0]]
        pts[m, others[1]] = u[m, 1] * half[others[1]]
    return pts


def _cylinder(n, rng, r, h):
    # lateral + caps proportional to area
    lat = 2 * np.pi * r * h
    cap = np.pi * r * r
    p = np.array([lat, cap, cap])
    part = rng.choice(3, size=n, p=p / p.sum())
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    m = part == 0
    pts[m] = np.stack([r * np.cos(th[m]), r * np.sin(th[m]),
                       rng.uniform(-h / 2, h / 2, m.sum())], -1)
    for cap_i, zs in ((1, h / 2), (2, -h / 2)):
        m = part == cap_i
        rr = r * np.sqrt(rng.uniform(0, 1, m.sum()))
        pts[m] = np.stack([rr * np.cos(th[m]), rr * np.sin(th[m]),
                           np.full(m.sum(), zs)], -1)
    return pts


def _torus(n, rng, R, r):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    # rejection for uniform area: weight ~ (R + r cos v)
    keep = rng.uniform(0, 1, n) < (R + r * np.cos(v)) / (R + r)
    u, v = u[keep], v[keep]
    pts = np.stack([(R + r * np.cos(v)) * np.cos(u),
                    (R + r * np.cos(v)) * np.sin(u),
                    r * np.sin(v)], -1)
    return pts


def _chair(n, rng, leg_h, seat_t, back_t):
    """Multi-part chair: 4 legs + seat slab + back slab."""
    seat_w = 0.9
    parts = []
    weights = []
    # legs: boxes
    for sx in (-1, 1):
        for sy in (-1, 1):
            parts.append(("leg", sx, sy))
            weights.append(0.08)
    parts.append(("seat",))
    weights.append(0.4)
    parts.append(("back",))
    weights.append(0.36)
    w = np.array(weights) / np.sum(weights)
    counts = rng.multinomial(n, w)
    out = []
    for (part, cnt) in zip(parts, counts):
        if cnt == 0:
            continue
        if part[0] == "leg":
            p = _box(cnt, rng, (0.06, 0.06, leg_h / 2))
            p += np.array([part[1] * (seat_w / 2 - 0.08),
                           part[2] * (seat_w / 2 - 0.08), -leg_h / 2])
        elif part[0] == "seat":
            p = _box(cnt, rng, (seat_w / 2, seat_w / 2, seat_t / 2))
        else:  # back
            p = _box(cnt, rng, (seat_w / 2, back_t / 2, leg_h / 2))
            p += np.array([0.0, -(seat_w / 2 - back_t / 2), leg_h / 2 + seat_t])
        out.append(p)
    return np.concatenate(out, 0)


def _cone(n, rng, r, h):
    # lateral surface + base disk, area-weighted
    slant = np.sqrt(r * r + h * h)
    lat = np.pi * r * slant
    base = np.pi * r * r
    p = np.array([lat, base])
    part = rng.choice(2, size=n, p=p / p.sum())
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    m = part == 0
    # uniform on the lateral surface: radius ~ sqrt(u)
    rr = r * np.sqrt(rng.uniform(0, 1, m.sum()))
    pts[m] = np.stack([rr * np.cos(th[m]), rr * np.sin(th[m]),
                       h * (1 - rr / r) - h / 2], -1)
    m = part == 1
    rr = r * np.sqrt(rng.uniform(0, 1, m.sum()))
    pts[m] = np.stack([rr * np.cos(th[m]), rr * np.sin(th[m]),
                       np.full(m.sum(), -h / 2)], -1)
    return pts


def _capsule(n, rng, r, h):
    # cylinder barrel + two hemispherical caps, area-weighted
    barrel = 2 * np.pi * r * h
    caps = 4 * np.pi * r * r
    part = rng.choice(2, size=n, p=np.array([barrel, caps]) / (barrel + caps))
    th = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    m = part == 0
    pts[m] = np.stack([r * np.cos(th[m]), r * np.sin(th[m]),
                       rng.uniform(-h / 2, h / 2, m.sum())], -1)
    m = part == 1
    v = rng.normal(size=(m.sum(), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    z_sign = np.sign(v[:, 2])
    pts[m] = v * r
    pts[m, 2] += z_sign * h / 2
    return pts


SHAPE_FAMILIES = ("sphere", "box", "cylinder", "torus", "chair", "cone",
                  "capsule")


def stable_seed(*parts) -> int:
    """Deterministic seed from strings/ints. Python's built-in hash() of a
    str is salted per process (PYTHONHASHSEED), which silently made every
    process generate different synthetic geometry — eval templates were
    only reproducible within one process. crc32 is stable everywhere."""
    import zlib

    return zlib.crc32("|".join(str(p) for p in parts).encode()) % (2 ** 31)


def synthetic_surface(family: str, seed: int, n_points: int = 10000) -> np.ndarray:
    """Sample a dense surface of the given family, unit-scaled.

    Deterministic in (family, seed); per-seed random shape parameters give
    intra-class variation like different ModelNet instances.
    """
    rng = np.random.default_rng(stable_seed(family, seed))
    # oversample: some samplers reject
    m = int(n_points * 1.5) + 64
    if family == "sphere":
        squash = rng.uniform(0.5, 1.0, 3)
        pts = _sphere(m, rng, squash)
    elif family == "box":
        pts = _box(m, rng, rng.uniform(0.35, 1.0, 3))
    elif family == "cylinder":
        pts = _cylinder(m, rng, rng.uniform(0.3, 0.7), rng.uniform(0.8, 1.8))
    elif family == "torus":
        pts = _torus(2 * m, rng, rng.uniform(0.5, 0.8), rng.uniform(0.15, 0.3))
    elif family == "chair":
        pts = _chair(m, rng, rng.uniform(0.7, 1.0), rng.uniform(0.08, 0.14),
                     rng.uniform(0.08, 0.14))
    elif family == "cone":
        pts = _cone(m, rng, rng.uniform(0.4, 0.8), rng.uniform(0.8, 1.6))
    elif family == "capsule":
        pts = _capsule(m, rng, rng.uniform(0.25, 0.5), rng.uniform(0.6, 1.4))
    else:
        raise ValueError(f"unknown family {family!r}; options: {SHAPE_FAMILIES}")
    pts = _unit_scale(pts)
    idx = rng.permutation(len(pts))[:n_points]
    return pts[idx]


def rotations(rng, n: int, max_angle_deg=None) -> np.ndarray:
    """(n, 3, 3) rotations: uniform on SO(3) (unit quaternions from normal
    draws) when max_angle_deg is None, else about a uniform axis by an
    angle uniform in [0, max_angle_deg]."""
    if max_angle_deg is None:
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w, x, y, z = q.T
        return np.stack([
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ], 1)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.deg2rad(rng.uniform(0.0, max_angle_deg, n))
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    s, c = np.sin(angle)[:, None, None], np.cos(angle)[:, None, None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def _sample(rng, dense: np.ndarray, which: np.ndarray, n: int) -> np.ndarray:
    """n points of surface which[i] for every i, each cloud without replacement."""
    pick = np.argsort(rng.random((len(which), dense.shape[1])), axis=1)[:, :n]
    return dense[which[:, None], pick]


def pair_pool(spec: dict, seed: int):
    """(template, source): float32 arrays (pool_batches, batch, num_point, 3)."""
    rng = np.random.default_rng(seed)
    fams = spec["families"]
    n_surf, dense_n, n = spec["surfaces"], spec["surface_points"], spec["num_point"]
    total = spec["pool_batches"] * spec["batch"]
    seeds = rng.integers(0, 2 ** 31, n_surf)
    dense = np.stack([synthetic_surface(fams[i % len(fams)], int(seeds[i]), dense_n)
                      for i in range(n_surf)])
    which = rng.integers(0, n_surf, total)
    tmpl, src = _sample(rng, dense, which, n), _sample(rng, dense, which, n)
    if spec["rotate"] == "uniform":
        rt = rotations(rng, total)
    elif spec["rotate"] == "none":
        rt = np.broadcast_to(np.eye(3), (total, 3, 3))
    else:
        raise ValueError(f"rotate must be 'uniform' or 'none', got {spec['rotate']!r}")
    rs = rt
    if spec["source_angle_deg"] > 0:
        rs = rotations(rng, total, spec["source_angle_deg"]) @ rt
    shape = (spec["pool_batches"], spec["batch"], n, 3)
    tmpl = np.einsum("pij,pnj->pni", rt, tmpl).astype(np.float32).reshape(shape)
    src = np.einsum("pij,pnj->pni", rs, src).astype(np.float32).reshape(shape)
    return tmpl, src
