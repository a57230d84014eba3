"""Serving: the frozen learned distance as an nn.Module (port of the forward
semantics of dpdist_tpu/serving.py:export_frozen_distance).

    model = load_frozen_distance("results/ckpt_best")        # on the card
    d = model(pcA, pcB)                                        # (B,) distances

    # bfloat16 serving through the fused gather + decoder kernel:
    model = load_frozen_distance("results/ckpt_best", dtype="bfloat16",
                                 fused_gather="full")

The module maps a (template, source) pair of (B, N, 3) clouds to the
per-pair learned distance `dpdist_distance(per_example=True)`. It is in
eval mode and every parameter has requires_grad=False. It is
differentiable in its input clouds: when an input requires a gradient,
fused_gather resolves for a gradient context (models.resolve_for_grad:
the table-gather kernels on the card, in float32, bfloat16 and float16), and
the parameters' .grad stays None. fused_gather="full" is forward only:
under autograd it raises NotImplementedError, as the reference refuses a
gradient through its fused kernel, rather than run another path.

The serving export (port of dpdist_tpu/serving.py:export_frozen_distance,
export_registration, save_exported, load_exported): the reference traces
its functions with jax.export into StableHLO with the weights baked in;
here they become torch.export programs (`torch.export.ExportedProgram`),
the weights their buffers, which `save_exported` writes and
`load_exported` reads back with torch alone:

    ep = export_frozen_distance(params, state, cfg, device="cpu")
    save_exported(ep, "model.pt2")
    d = load_exported("model.pt2", device="cuda").module()(pcA, pcB)

- Portable (the default) forces fused_gather="off", so the program holds
  plain aten ops only, as the reference's forces XLA; it loads in a process
  that imports neither this package nor JAX.
- portable=False keeps the checkpoint's fused_gather and the kernels
  `route` names for it, as the reference's keeps its Pallas kernels: they
  appear as the torch.library ops of kernels/ops.py (dpdist::...). Such a
  program is routed as on the card wherever it was exported.
- batch=None exports a symbolic batch (torch.export.Dim), bounded for a
  native program by the batch limits of the kernels it holds.
- export_registration serves the pointnet and the 3dmfv policies: the
  whole refinement is one while_loop in the program; a native 3dmfv
  program at num_point >= 128 launches row 7 (dpdist::threedmfv) on every
  trip, and once before the loop for a hoisted template.
- with_grad exports (per-pair value (B,), d/dsrc (B, N, 3)) with the
  out-of-grid barrier taken per pair, as the reference's vmap over pairs
  does; the function is traced with make_fx (torch.export cannot trace
  torch.autograd.grad) and then exported.

Deviations from the reference:
- `device` takes the place of `platforms`: a program is exported on one
  device, and a portable program exported on the CPU serves on the card
  after `load_exported(path, device="cuda")` (torch.export's
  move_to_device_pass).
- A native program holds the Hopper kernels, so it serves on the card
  only (on the CPU its ops run the kernels' plain versions), and the
  process that loads it must import dpdist_tpu_torch.kernels.ops first, to
  register the ops, as the reference's Mosaic artifact needs a TPU runtime.
- Row 8 (kernels/chamfer.nn_min_sqdist) has no op: no exported function
  reaches it at the served sizes, and an export that would raises.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig, PCRNetConfig
from dpdist_tpu_torch.kernels import ops
from dpdist_tpu_torch.kernels.fused_forward import fused_forward_batch_fits, pack_decoder
from dpdist_tpu_torch.models.dpdist import (
    check_ported,
    dpdist_distance,
    resolve_for_grad,
    resolve_mode,
)
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.train.checkpoint import (
    load_dpdist_checkpoint,
    params_from_jax,
    tree_flatten_with_paths,
    tree_unflatten_like,
)


class FrozenDistance(nn.Module):
    """The learned DPDist distance with frozen weights and BN state.

    `params` and `state` are init_dpdist's trees (state None for a config
    without BN); their leaves are the module's parameters, in
    tree_flatten_with_paths order, and keep the JAX layout (a dense layer
    computes x @ w + b). A config whose forward takes "full" (bfloat16,
    the conv_version=1 decoder without BN, and a decoder and grid the fused
    kernel takes: models.dpdist.resolve_mode) also holds the decoder packed
    once for the fused kernel (kernels.fused_forward.pack_decoder), on the
    parameters' device.
    """

    def __init__(self, cfg: DPDistConfig, params: dict, state: dict = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self._trees = (params, state)
        self.p = nn.ParameterList(nn.Parameter(t, requires_grad=False)
                                  for _, t in tree_flatten_with_paths(params))
        self.s = nn.ParameterList(nn.Parameter(t, requires_grad=False)
                                  for _, t in tree_flatten_with_paths(state))
        self.packed = None
        if resolve_mode(cfg, ops.route_device(self.p[0])) == "full":
            self.packed = pack_decoder(self.params()["decoder"]["layers"])

    def params(self) -> dict:
        p = tree_unflatten_like(self._trees[0], list(self.p))
        if self.packed is not None:
            p["packed"] = self.packed
        return p

    def state(self):
        return None if self._trees[1] is None else tree_unflatten_like(self._trees[1], list(self.s))

    def forward(self, pcA: torch.Tensor, pcB: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if torch.is_grad_enabled() and (pcA.requires_grad or pcB.requires_grad):
            cfg = resolve_for_grad(cfg, ops.route_device(pcA))
        return dpdist_distance(self.params(), cfg, pcA, pcB, state=self.state(),
                               per_example=True)


def load_frozen_distance(ckpt_path: str, device="cuda", **cfg_overrides) -> FrozenDistance:
    """Load `<ckpt_path>.npz/.json` (params and BN state) into a
    FrozenDistance on `device`.

    `cfg_overrides` replace fields of the checkpoint's config (for example
    fused_gather="off" for the plain composition). Raises without a card
    when `device` is CUDA.
    """
    dev = resolve_device(device)
    cfg, np_params, np_state = load_dpdist_checkpoint(ckpt_path)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    model = FrozenDistance(cfg, params_from_jax(np_params, dev), params_from_jax(np_state, dev))
    return model.eval()


# The batch of the example clouds a symbolic batch is traced with: one that
# no other size of the served functions takes (a stop period of 2, say).
EXAMPLE_BATCH = 11


class _Program(nn.Module):
    """fn(a, b, *leaves) with the leaves (the weights) held as buffers, the
    module torch.export turns into a program."""

    def __init__(self, fn, leaves):
        super().__init__()
        self.fn = fn
        self.n = len(leaves)
        for i, t in enumerate(leaves):
            self.register_buffer(f"w{i}", t)

    def forward(self, a, b):
        return self.fn(a, b, *(getattr(self, f"w{i}") for i in range(self.n)))


def _leaves(*trees):
    return [t for tree in trees for _, t in tree_flatten_with_paths(tree)]


def _unflatten(leaves, *trees):
    """The trees of `_leaves(*trees)` rebuilt from `leaves`."""
    out, i = [], 0
    for tree in trees:
        n = len(tree_flatten_with_paths(tree))
        out.append(None if tree is None else tree_unflatten_like(tree, list(leaves[i:i + n])))
        i += n
    return out


def _largest(fits, hi=2 ** 31):
    """The largest batch b < hi with fits(b), fits monotone (None if none)."""
    lo, hi = 0, hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo or None


def _examples(num_point: int, batch, dev):
    """Two (batch, num_point, 3) float32 clouds on `dev` to trace with."""
    return tuple(torch.zeros((batch or EXAMPLE_BATCH, num_point, 3), device=dev)
                 for _ in range(2))


def _export(module, num_point: int, batch, dev, max_batch=None):
    """torch.export of module(a, b) for (batch, num_point, 3) float32
    clouds on `dev`; batch None: a symbolic batch up to max_batch."""
    examples = _examples(num_point, batch, dev)
    dynamic = None
    if batch is None:
        b = torch.export.Dim("b", max=max_batch) if max_batch else torch.export.Dim("b")
        dynamic = ({0: b}, {0: b})
    return torch.export.export(module, examples, dynamic_shapes=dynamic)


def _pair_barrier(pc):
    """The frozen loss's out-of-grid barrier of each cloud, (B,)."""
    return torch.mean(torch.relu(torch.abs(pc) - 1.0), dim=(1, 2))


def export_frozen_distance(params, state, cfg: DPDistConfig, *, num_point: Optional[int] = None,
                           batch: Optional[int] = None, with_grad: bool = False,
                           out_of_grid_penalty: float = 1.0, portable: bool = True,
                           device="cuda") -> torch.export.ExportedProgram:
    """The frozen distance, or with with_grad its value and gradient in the
    source cloud, as a torch.export program of (src, tgt) (B, N, 3) float32.

    params, state: init_dpdist's trees (numpy arrays or tensors; state None
    for a config without BN). num_point defaults to cfg.num_point; batch
    None exports a symbolic batch. Without with_grad the program gives
    dpdist_distance(per_example=True), (B,). with_grad gives (value (B,),
    d value / d src (B, N, 3)), value the frozen loss of each pair on its
    own: the distance plus out_of_grid_penalty * (the mean of relu(|src| -
    1) + that of tgt), the barrier of losses/dpdist_loss.py per pair (0:
    the reference's raw semantics). portable (see the module docstring):
    fused_gather="off"; else the checkpoint's, with the kernels as ops.
    Traced on `device` (nothing runs there: the export traces with fake
    tensors)."""
    dev = resolve_device(device)
    num_point = num_point or cfg.num_point
    if portable:
        cfg = cfg.replace(fused_gather="off")
    params, state = params_to_device(params, dev), params_to_device(state, dev)
    with ops.exporting("portable" if portable else "native"), torch.no_grad():
        if not with_grad:
            max_batch = None
            if not portable and resolve_mode(cfg, "cuda") == "full":
                max_batch = _largest(lambda b: fused_forward_batch_fits(
                    2 * b, num_point, cfg.grid_size, cfg.fv_channels))
            return _export(FrozenDistance(cfg, params, state).eval(), num_point, batch, dev,
                           max_batch)
        from torch.fx.experimental.proxy_tensor import make_fx

        def value_and_grad(src, tgt, *leaves):
            p, s = _unflatten(leaves, params, state)
            with torch.enable_grad():
                src = src.detach().requires_grad_(True)
                gcfg = resolve_for_grad(cfg, ops.route_device(src))
                vals = dpdist_distance(p, gcfg, src, tgt, state=s, per_example=True)
                if out_of_grid_penalty > 0:
                    vals = vals + out_of_grid_penalty * (_pair_barrier(src) + _pair_barrier(tgt))
                (grads,) = torch.autograd.grad(vals.sum(), src)
            return vals.detach(), grads

        leaves = _leaves(params, state)
        traced = make_fx(value_and_grad, tracing_mode="symbolic" if batch is None else "fake")(
            *_examples(num_point, batch, dev), *leaves)
        return _export(_Program(traced, leaves), num_point, batch, dev)


def export_registration(params, pcfg: PCRNetConfig, *, state=None,
                        num_point: Optional[int] = None, iterations: Optional[int] = None,
                        batch: Optional[int] = None, portable: bool = True, device="cuda",
                        stop_threshold: Optional[float] = None, stop_period: int = 1,
                        stop_select: str = "last",
                        early_exit: bool = False) -> torch.export.ExportedProgram:
    """A frozen iterative-PCRNet policy as a torch.export program of
    (template, source) (B, N, 3) -> (T_pred (B, 4, 4), aligned (B, N, 3)).

    The whole refinement runs inside the program, as one while_loop of
    `iterations` trips (default pcfg.eval_iterations; an unrolled loop's
    trace, and its export time, grows with the iterations), the template's
    encoding hoisted where template_feats_invariant holds.
    T_pred is the inverse of the accumulated transform (the evaluator's
    convention, so it composes with pose CSVs). stop_threshold /
    stop_period / stop_select bake the convergence stop of
    eval.registration.accumulate_with_stopping into the program (aligned
    is then the frozen transform applied to the source, else the refined
    source). early_exit (with a stop_threshold) also returns from the loop
    once every case of the batch has frozen: the same outputs, and fewer
    iterations on a converging policy.
    params, state: a policy's trees. A pointnet policy's state is {}; it
    reaches no kernel. A 3dmfv policy's state holds its BN running
    statistics (the template then encoded once, before the loop); with
    state None BN normalises with batch statistics and template and source
    are encoded as one batch on every trip, as pcrnet_iteration does. A
    native 3dmfv program at num_point >= 128 holds row 7's op
    (dpdist::threedmfv) inside the loop, as `threedmfv` routes on the
    card. portable and device as in export_frozen_distance."""
    from torch._higher_order_ops import while_loop

    from dpdist_tpu_torch.eval.registration import init_stop_carry, stopping_step
    from dpdist_tpu_torch.geometry.se3 import apply_transform, invert_transform
    from dpdist_tpu_torch.models.pcrnet import (
        encode_template,
        pcrnet_iteration,
        template_feats_invariant,
    )

    if early_exit and stop_threshold is None:
        raise ValueError("early_exit requires stop_threshold: without a stopping criterion "
                         "nothing can freeze, so the artifact would silently run all "
                         "iterations")
    dev = resolve_device(device)
    num_point = num_point or pcfg.num_point
    iterations = iterations or pcfg.eval_iterations
    params = params_to_device(params, dev)
    state = params_to_device(state, dev) if state is not None else None
    stop = dict(stop_threshold=stop_threshold, stop_period=stop_period, stop_select=stop_select)

    def fn(template, source, *leaves):
        p, s = _unflatten(leaves, params, state)
        carry0 = tuple(t.clone() for t in init_stop_carry(
            source.dtype, source.shape[0], stop_period, source, template, stop_select))
        tfeats = (encode_template(p, pcfg, template, state=s)
                  if template_feats_invariant(pcfg, s, False) else None)

        def cond(src, T, hist, frozen, conv_iter, sc, i):
            go = i < iterations
            return go & ~torch.all(frozen) if early_exit else go

        def body(src, T, hist, frozen, conv_iter, sc, i):
            # Frozen cases go on evolving as in the fixed-length loop (only
            # their transform stops), so the two agree.
            pose, new_src, _ = pcrnet_iteration(p, pcfg, src, template, state=s,
                                                template_feats=tfeats)
            carry, _ = stopping_step((T, hist, frozen, conv_iter, sc), pose, i, source,
                                     template, **stop)
            return (new_src, *(t.clone() for t in carry), i + 1)

        i0 = torch.zeros((), dtype=torch.int64, device=source.device)
        # torch.export traces the loop's body through dynamo with every size
        # symbolic (assume_static_by_default=False), the weights' too; the
        # 3dmfv encoder's SAME padding, computed from its conv windows, then
        # did not trace (its branches' sizes parted). Static by default,
        # only the batch stays symbolic, as the carried clouds give it.
        with torch._dynamo.config.patch(assume_static_by_default=True):
            aligned, T_total = while_loop(cond, body, (source, *carry0, i0))[:2]
        if stop_threshold is not None:
            aligned = apply_transform(source, T_total)
        return invert_transform(T_total), aligned

    # The while_loop is traced through torch._dynamo, whose cache of an
    # earlier export's frames would add guards that pin the batch.
    torch._dynamo.reset()
    # A symbolic batch needs no bound here: row 7, the one kernel a policy
    # reaches, takes any batch (threedmfv_fits reads only the Gaussians;
    # the batch runs along the grid's x, up to 2^31 - 1 blocks, and
    # split_plan keeps the y dimension at most BLOCKS_PER_SM * SMs).
    with ops.exporting("portable" if portable else "native"), torch.no_grad():
        return _export(_Program(fn, _leaves(params, state)), num_point, batch, dev)


def save_exported(ep: torch.export.ExportedProgram, path: str) -> str:
    """Write a program (its graph and its weights) to `path`."""
    torch.export.save(ep, path)
    return path


def load_exported(path: str, device=None) -> torch.export.ExportedProgram:
    """Read a program written by save_exported; call it as
    `.module()(a, b)`. device: move it there (a portable program exported
    on the CPU serves on the card); None keeps the device it was exported
    on. A native program needs dpdist_tpu_torch.kernels.ops imported (this
    module imports it)."""
    ep = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    return ep


def exported_inputs(ep: torch.export.ExportedProgram):
    """(batch or None where it is symbolic, num_point) of a program's two
    (B, N, 3) cloud inputs, from its input specs."""
    from torch.export.graph_signature import InputKind

    specs = [s for s in ep.graph_signature.input_specs if s.kind == InputKind.USER_INPUT]
    if len(specs) != 2:
        raise ValueError(f"the program takes {len(specs)} inputs; the served programs take "
                         "two clouds")
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    shape = nodes[specs[0].arg.name].meta["val"].shape
    b = shape[0]
    return (int(b) if isinstance(b, int) else None), int(shape[1])
