"""Weights: the committed DPDist checkpoint read with numpy, and seeded
weights made on the device.

A checkpoint is `<base>.npz` (leaves `leaf_00000`, ...) beside
`<base>.json` (their key paths, "params/decoder/layers/0/w", ...). The
reader returns {path: array}; the benchmark hands the same arrays to the
program and to the plain reference.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch


def read_checkpoint(base: str) -> dict:
    """{key path without the leading "params/": float32 array}."""
    with open(base + ".json") as f:
        paths = json.load(f)["paths"]
    with np.load(base + ".npz") as z:
        return {p.split("/", 1)[1]: np.asarray(z[f"leaf_{i:05d}"], np.float32)
                for i, p in enumerate(paths) if p.startswith("params/")}


def nest(flat: dict, to_leaf=lambda a: a) -> dict:
    """{"a/b/0/c": leaf} -> {"a": {"b": [{"c": leaf}]}} (digit keys are list
    items)."""
    root: dict = {}
    for path, leaf in flat.items():
        node, parts = root, path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = to_leaf(leaf)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def initial_leaves(shapes: dict, seed: int, device) -> dict:
    """{path: float32 tensor on `device`} for {path: shape}, as a training
    run starts: a weight ("w": (in, out), or a conv's (..., in, out))
    xavier-uniform, U(-l, l) with l = sqrt(6 / (fan_in + fan_out)) over its
    receptive field; a BN scale or variance ones; biases, BN offsets and
    means zeros. The weights come from one uniform draw of all their
    elements, in sorted path order, by a generator on `device` seeded with
    `seed`: the same seed gives the same tensors."""
    weights = sorted(p for p in shapes if p.rsplit("/", 1)[-1] == "w")
    sizes = [math.prod(shapes[p]) for p in weights]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, i = {}, 0
    for p, n in zip(weights, sizes):
        shape = shapes[p]
        field = math.prod(shape[:-2])
        limit = math.sqrt(6.0 / (field * (shape[-2] + shape[-1])))
        out[p] = flat[i:i + n].view(shape).mul_(2 * limit).sub_(limit)
        i += n
    for p, shape in shapes.items():
        if p not in out:
            fill = 1.0 if p.rsplit("/", 1)[-1] in ("scale", "var") else 0.0
            out[p] = torch.full(shape, fill, device=device)
    return out
