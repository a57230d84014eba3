"""Checkpoints (port of dpdist_tpu/train/checkpoint.py and of
`load_dpdist_checkpoint`, dpdist_tpu/cli/train_aue.py:18-30).

Format: <path>.npz holds the flattened leaves as arrays leaf_00000...;
<path>.json holds their key paths ("params/decoder/layers/0/w", ...), the
step and the metadata, whose `model_config` is a DPDistConfig JSON string.
Leaves are flattened in JAX's order (dict keys sorted, list items by
index, None without leaves), so a checkpoint written here restores
through the reference's restore_checkpoint against its own template.
load_checkpoint rebuilds the nested structure from the paths alone, with
no template and no JAX; restore_checkpoint restores into a template's
structure, as the reference's does, for trees with None entries (the
AUE's BN-less layers). Writes publish atomically: a temporary file, then
a rename.

Weights keep the JAX layout: a dense `w` is (in, out), a conv's DHWIO or
HWIO, and the port's layers compute with them as they are.
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
from dpdist_tpu_torch.nn.layers import params_to_device


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
    and tuple items by index; an empty dict or list, and None (the AUE's
    BN-less layers), have no leaves."""
    if tree is None:
        return []
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


def _paths(tree) -> List[str]:
    return [p for p, _ in tree_flatten_with_paths(tree)]


def tree_unflatten_like(template, leaves):
    """`template`'s structure with its leaves, in tree_flatten_with_paths
    order, replaced by `leaves`; None stays None."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def restore_checkpoint(path: str, template: Any):
    """Restore into the structure of `template` (a matching tree), as the
    reference's restore_checkpoint: the saved key paths must equal the
    template's, else ValueError. Returns (tree with numpy leaves, step,
    metadata)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    want = _paths(template)
    if meta["paths"] != want:
        raise ValueError("checkpoint structure mismatch:\n saved: %s...\n template: %s..."
                         % (meta["paths"][:5], want[:5]))
    with np.load(path + ".npz") as data:
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(want))]
    return tree_unflatten_like(template, leaves), meta.get("step"), meta.get("metadata", {})


def restore_params_maybe_state(path: str, params_template: Any, state_template: Any):
    """Restore a {"params", "state"} checkpoint, falling back to the
    params-only format of the reference's first round, as the reference's
    restore_params_maybe_state does.

    The saved key paths must equal the templates' ({"params": ...,
    "state": ...} first, then {"params": ...}); else ValueError. Returns
    (params, state or None, step), with numpy leaves in the checkpoint's
    structure. A state without leaves (the pointnet PCRNet's {}) restores
    as the template's."""
    tree, step, _ = load_checkpoint(path)
    with open(path + ".json") as f:
        saved = json.load(f)["paths"]
    if saved == _paths({"params": params_template, "state": state_template}):
        state = tree.get("state", state_template)
        return tree["params"], state_template if not _paths(state) else state, step
    if saved == _paths({"params": params_template}):
        return tree["params"], None, step
    raise ValueError("checkpoint structure mismatch:\n saved: %s...\n template: %s..."
                     % (saved[:5], _paths({"params": params_template})[:5]))


def load_dpdist_checkpoint(path: str) -> Tuple[DPDistConfig, dict, dict]:
    """(cfg, params, state) of a DPDistTrainer checkpoint, as the reference's
    load_dpdist_checkpoint; params and state hold numpy arrays in the JAX
    package's trees (init_dpdist's structure: the decoder, and the pointnet
    encoder where the config has it). A model without BN has an empty state,
    which a checkpoint stores as no leaves: it is rebuilt from the config."""
    tree, _, metadata = load_checkpoint(path)
    cfg = DPDistConfig.from_json(metadata["model_config"])
    state = {"decoder": {}, **({"pointnet": {}} if cfg.encoder == "pointnet" else {})}
    for key, sub in tree.get("state", {}).items():
        state[key] = sub
    return cfg, tree["params"], state


def params_from_jax(params, device="cuda", *, model: str = "dpdist") -> dict:
    """The port's tensors from a JAX package tree with numpy (or
    array-like) leaves, as a checkpoint or `jax.device_get` gives it:
    params or BN state of any of the port's models (model="dpdist", "aue",
    "pcrnet", ...), leaf by leaf as float32 tensors on `device`, None kept.
    A DPDist tree must hold its decoder. Dense `w` stays in JAX's (in, out)
    layout and a conv's `w` in DHWIO / HWIO: the layers compute with them
    as they are, no transpose.
    """
    if model == "dpdist" and "decoder" not in params:
        raise ValueError(f"a DPDist tree holds its decoder, got keys {sorted(params)}")
    return params_to_device(params, resolve_device(device))


def params_to_numpy(tree):
    """The reverse of params_from_jax: any of the port's trees (DPDist or
    AUE params, BN state) with numpy float32 leaves in the JAX package's
    structure, None kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return _to_numpy(tree).astype(np.float32, copy=False)
