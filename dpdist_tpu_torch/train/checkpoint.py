"""Checkpoints (port of dpdist_tpu/train/checkpoint.py and of
`load_dpdist_checkpoint`, dpdist_tpu/cli/train_aue.py:18-30).

Format: <path>.npz holds the flattened leaves as arrays leaf_00000...;
<path>.json holds their key paths ("params/decoder/layers/0/w", ...), the
step and the metadata, whose `model_config` is a DPDistConfig JSON string.
Leaves are flattened in JAX's order (dict keys sorted, list items by
index), so a checkpoint written here restores through the reference's
restore_checkpoint against its own template, and the reader rebuilds the
nested structure from the paths alone, with no template and no JAX.
Writes publish atomically: a temporary file, then a rename.

Weights keep the JAX layout: a dense `w` is (in, out), and the port's
layers compute `x @ w + b` with it as it is.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

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


def tree_flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """[(key path, leaf)] in JAX's flattening order: dict keys sorted, list
    and tuple items by index; an empty dict or list has no leaves."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in tree_flatten_with_paths(tree[key], prefix + (str(key),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in tree_flatten_with_paths(sub, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, *, step: Optional[int] = None,
                    metadata: Optional[dict] = None) -> str:
    """Save a tree of tensors or arrays. `path` is the base path (no extension)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = tree_flatten_with_paths(tree)
    arrays = {f"leaf_{i:05d}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    # The temporary name ends in .npz so np.savez appends no second extension.
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path + ".npz")
    meta = {"paths": [p for p, _ in flat], "step": step, "metadata": metadata or {}}
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    return path


def latest_checkpoint(run_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """The newest '<prefix>_<step>' base path in run_dir, or None."""
    if not os.path.isdir(run_dir):
        return None
    best, best_step = None, -1
    pat = re.compile(rf"^{re.escape(prefix)}_(\d+)\.json$")
    for fn in os.listdir(run_dir):
        m = pat.match(fn)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(run_dir, fn[:-5])
    return best


def archive_checkpoint(src_base: str, dst_base: str, *, metric: Optional[float] = None,
                       metric_name: str = "metric", extra: Optional[dict] = None) -> str:
    """Copy <src_base>.{npz,json} to <dst_base>.{npz,json}, recording
    `metric` (and `extra` keys) in the destination's metadata, so a resumed
    run never overwrites the archive with a worse checkpoint
    (`archived_metric`). npz first, then json, each published atomically."""
    d = os.path.dirname(os.path.abspath(dst_base))
    os.makedirs(d, exist_ok=True)
    shutil.copyfile(src_base + ".npz", dst_base + ".tmp.npz")
    os.replace(dst_base + ".tmp.npz", dst_base + ".npz")
    with open(src_base + ".json") as f:
        meta = json.load(f)
    md = meta.setdefault("metadata", {})
    if metric is not None:
        md[metric_name] = float(metric)
    if extra:
        md.update(extra)
    with open(dst_base + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(dst_base + ".json.tmp", dst_base + ".json")
    return dst_base


def archived_meta(dst_base: str, key: str):
    """A raw metadata value of an archive's json, or None."""
    try:
        with open(dst_base + ".json") as f:
            meta = json.load(f)
        return meta.get("metadata", {}).get(key)
    except (OSError, ValueError):
        return None


def archived_metric(dst_base: str, metric_name: str = "metric"):
    """The metric `archive_checkpoint` recorded, or None if the archive (or
    the metric) does not exist."""
    v = archived_meta(dst_base, metric_name)
    try:
        return float(v) if v is not None else None
    except (ValueError, TypeError):
        return None


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


def params_to_numpy(params) -> dict:
    """The reverse of params_from_jax: the port's decoder state as the JAX
    package's params tree with numpy float32 leaves."""
    layers = [{"w": _to_numpy(lp["w"]), "b": _to_numpy(lp["b"])}
              for lp in params["decoder"]["layers"]]
    return {"decoder": {"layers": layers}}
