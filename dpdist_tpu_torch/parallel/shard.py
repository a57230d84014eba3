"""Synchronous data parallelism over the mesh (port of
dpdist_tpu/parallel/shard.py, whose shard_map step replaces the original's
tower data parallelism and average_gradients).

Parameters and state are the same tensors in every process (replicate
broadcasts them from rank 0 once); every process builds the same global
batch and takes its rows along the 'data' axis (shard_batch, the torch
form of P("data")); a step computes the loss and its gradients on the
process's shard and then averages the gradients, the loss and the new BN
state over the data axis in ONE all_reduce of one flat buffer, as the
reference's pmean does, before the optimizer's update (so weight decay
and clipping see the averaged gradient, as in the reference's optax chain)
and the gradient norm of the averaged gradient.

BN normalises with each process's local batch statistics, and only the
state's EMA is averaged afterwards, as inside the reference's shard_map:
neither DistributedDataParallel (which broadcasts rank 0's buffers) nor
SyncBatchNorm (global statistics) has these semantics, and neither is
used. The params are plain tensor trees, not modules.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from dpdist_tpu_torch.parallel.mesh import Mesh
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths, tree_unflatten_like
from dpdist_tpu_torch.train.profiling import span


def _leaves(tree):
    return [t for _, t in tree_flatten_with_paths(tree)]


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _split(flat, like):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def replicate(tree, mesh: Mesh):
    """Copy rank 0's leaves (float32, as every tree of the port) into every
    process's tree, in place, by one broadcast; returns the tree. On a
    one-process mesh nothing happens."""
    if mesh.device_mesh is None:
        return tree
    leaves = _leaves(tree)
    buf = _flat(leaves)
    dist.broadcast(buf, src=0)
    with torch.no_grad():
        for t, v in zip(leaves, _split(buf, leaves)):
            t.copy_(v)
    return tree


def shard_batch(tree, mesh: Mesh):
    """Rows [i * b, (i + 1) * b) of every leaf's leading axis, for this
    process's index i on the 'data' axis and b = rows / data (raises
    ValueError when the rows do not divide). Leaves are numpy arrays or
    tensors; None stays None; dicts, lists and tuples keep their form. On a
    data axis of one the tree comes back as it is."""
    n, i = mesh.shape["data"], mesh.index("data")
    if n == 1:
        return tree

    def take(leaf):
        if leaf is None:
            return None
        if isinstance(leaf, dict):
            return {k: take(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(take(v) for v in leaf)
        rows = leaf.shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not divide over the data axis of {n}")
        b = rows // n
        return leaf[i * b:(i + 1) * b]

    return take(tree)


def mean_over_data(mesh: Mesh, loss, grads, state):
    """(loss, grads, state) averaged over the data axis by one all_reduce:
    the loss a 0-d tensor, grads a list of tensors, state a tree (None or
    empty allowed) of the loss's dtype. On a data axis of one they come
    back as they are (the loss detached), with no collective."""
    if mesh.shape["data"] == 1:
        return loss.detach(), grads, state
    state_leaves = _leaves(state)
    parts = [loss.detach().reshape(1), *grads, *state_leaves]
    buf = _flat(parts)
    dist.all_reduce(buf, group=mesh.group("data"))
    buf /= mesh.shape["data"]
    out = _split(buf, parts)
    loss, grads = out[0].reshape(()), out[1:1 + len(grads)]
    if state_leaves:
        state = tree_unflatten_like(state, out[1 + len(grads):])
    return loss, grads, state


def build_sharded_train_step(loss_fn: Callable, optimizer, mesh: Mesh):
    """(init_fn, step_fn) of a data-parallel train step; on a 1 x 1 mesh
    it is the single-device step, with no collective.

    loss_fn(params, state, batch) -> (loss, new_state), run on this
    process's shard of the batch; optimizer: train.optim.Optimizer.

      init_fn(params) -> opt_state
      step_fn(params, state, opt_state, batch) -> (params, state, opt_state,
          {"loss", "grad_norm"}): the local loss and gradients, their mean
          and the new state's over the data axis, the update (params change
          in place), and the averaged gradient's global norm.

    Under a profiler session step_fn opens the span "train.step" and,
    inside it, "train.forward" (loss_fn), "train.backward"
    (torch.autograd.grad) and "train.optimizer" (optimizer.step; detail:
    "adam" or "momentum"), as train.profiling.span records them.
    """

    def init_fn(params):
        return optimizer.init(params)

    def step_fn(params, state, opt_state, batch):
        with span("train.step"):
            leaves = _leaves(params)
            with torch.enable_grad():
                with span("train.forward"):
                    loss, new_state = loss_fn(params, state, batch)
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, leaves)
            loss, grads, new_state = mean_over_data(mesh, loss, grads, new_state)
            with span("train.optimizer", optimizer.cfg.optimizer):
                opt_state = optimizer.step(params, grads, opt_state)
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            return params, new_state, opt_state, {"loss": loss, "grad_norm": gnorm}

    return init_fn, step_fn
