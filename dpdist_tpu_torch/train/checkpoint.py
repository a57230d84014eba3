"""Checkpoint reading (port of the read side of dpdist_tpu/train/checkpoint.py
and of `load_dpdist_checkpoint`, dpdist_tpu/cli/train_aue.py:18-30).

Format: <path>.npz holds the flattened leaves as arrays leaf_00000...;
<path>.json holds their key paths ("params/decoder/layers/0/w", ...) and
the metadata, whose `model_config` is a DPDistConfig JSON string. The
reader rebuilds the nested structure from the paths alone, so it needs no
template and no JAX.

Weights keep the JAX layout: a dense `w` is (in, out), and the port's
layers compute `x @ w + b` with it as it is.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig


def _listify(node):
    """Turn dicts keyed "0", "1", ... (JAX list nodes) back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def load_checkpoint(path: str) -> Tuple[Any, Any, dict]:
    """Read `<path>.npz` + `<path>.json` into (tree, step, metadata).

    `tree` is the nested structure the key paths describe, with numpy
    leaves; dict nodes keyed 0..n-1 become lists.
    """
    with open(path + ".json") as f:
        meta = json.load(f)
    paths = meta["paths"]
    with np.load(path + ".npz") as data:
        if len(data.files) != len(paths):
            raise ValueError("%s.npz holds %d leaves but the json lists %d paths"
                             % (path, len(data.files), len(paths)))
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(paths))]
    tree: Dict[str, Any] = {}
    for p, leaf in zip(paths, leaves):
        node = tree
        keys = p.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf
    return _listify(tree), meta.get("step"), meta.get("metadata", {})


def load_dpdist_checkpoint(path: str) -> Tuple[DPDistConfig, dict]:
    """(cfg, params) of a DPDistTrainer checkpoint; params hold numpy arrays
    in the JAX package's structure ({"decoder": {"layers": [{"w", "b"}]}})."""
    tree, _, metadata = load_checkpoint(path)
    cfg = DPDistConfig.from_json(metadata["model_config"])
    return cfg, tree["params"]


def params_from_jax(params, device="cuda") -> dict:
    """The port's decoder state from the JAX package's DPDist parameters.

    `params` is the JAX params tree with numpy (or array-like) leaves, as
    `load_dpdist_checkpoint` returns it or as `jax.device_get` gives it.
    Dense `w` stays in JAX's (in, out) layout: each layer computes
    `x @ w + b`, no transpose. Parts this slice does not port raise.
    """
    dev = resolve_device(device)
    if "pointnet" in params:
        raise NotImplementedError("the pointnet encoder is not ported yet")
    dec = params["decoder"]
    if "layers" not in dec:
        raise NotImplementedError("the conv_version=3 decoder is not ported yet")
    if "bn" in dec:
        raise NotImplementedError("BatchNorm in the decoder is not ported yet")

    def to_t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    layers = [{"w": to_t(lp["w"]), "b": to_t(lp["b"])} for lp in dec["layers"]]
    return {"decoder": {"layers": layers}}
