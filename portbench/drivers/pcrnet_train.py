"""PCRNet training on the frozen DPDist loss:
train.pcrnet_trainer.PCRNetTrainer.train_step back to back with
train_single (the gradient through every refinement iteration, the loss
over the whole trajectory), reading the loss back every `log_every` steps
as the trainer's own loop logs.

The traffic: pairs of pair_pool (rotate "none": each template in its
canonical pose; the source an independent sample of the same surface
turned up to source_angle_deg), both scaled by `surface_scale`, as the
registration dataset scales its clouds.

Set-up builds the one trainer the window drives, checks its leaves
against the reference's, writes the weights the benchmark made from the
seed into them, and runs its first `checked_steps` steps through the same
call and feed as the window, on the pool's first batches: they are the
warm-up, and what the check holds against the plain reference. For the
first step it records the program's own values: the trajectory and the
poses of the refinement (read from the trainer's call of
models.pcrnet.pcrnet_refine), the loss, the gradient handed to the
optimizer, the BN state after the step and the update applied. The
reference recomputes that step teacher-forced on the program's trajectory
(the refinement in training mode is chaotic: two float32 chains side by
side part completely over 8 iterations) and is read against the later
steps' losses free-running, which are not compared.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile

import numpy as np
import torch

from portbench.core import counts, pcrnet_counts
from portbench.core.driver import Driver as Base
from portbench.core.traffic import pair_pool
from portbench.core.weights import initial_leaves, nest, read_checkpoint
from portbench.drivers.aue_train import NEGLIGIBLE, _norm

NUMBERS = ("pose_gap", "loss_gap", "grad_gap", "state_gap", "update_gap", "later_loss_gap")
BLOCK = 32          # clouds of the reference's frozen loss at a time


def _worst(got: dict, want: dict, keys=None) -> float:
    """The worst leaf's ||got - want||, over the larger of its ||want|| and
    the median leaf's."""
    keys = list(want) if keys is None else keys
    norms = {k: _norm(want[k]) for k in keys}
    med = statistics.median(norms.values())
    return max(_norm(got[k] - want[k]) / max(norms[k], med) for k in keys)


class Driver(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.units_per_step = ctx.traffic["batch"]

    def _config(self):
        from dpdist_tpu_torch.configs import PCRNetConfig

        cfg = self.ctx.config
        return PCRNetConfig(num_point=cfg["num_point"], encoder=cfg["encoder"],
                            out_features=cfg["out_features"], max_loops=cfg["max_loops"],
                            lim_rot=cfg["lim_rot"], head_widths=tuple(cfg["head_widths"]),
                            sigma3dmfv=cfg["sigma3dmfv"], mfv_grid=cfg["mfv_grid"])

    def setup(self):
        from dpdist_tpu_torch.configs import TrainConfig
        from dpdist_tpu_torch.models import pcrnet as pcrnet_model
        from dpdist_tpu_torch.train import pcrnet_trainer
        from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
        from dpdist_tpu_torch.train.logging import NullLogger

        from portbench.core.pairs import dpdist_config

        ctx, cfg, t = self.ctx, self.ctx.config, self.ctx.traffic
        got = (pcrnet_model.BN_MOMENTUM, pcrnet_model.BN_EPS)
        if got != (cfg["bn_momentum"], cfg["bn_eps"]):
            raise RuntimeError(f"the program's PCRNet BN (momentum, eps) {got} is not the "
                               "configuration's")
        self.frozen = ctx.config_named(cfg["frozen_loss"])
        self.arrays = read_checkpoint(str(ctx.root / self.frozen["checkpoint"]))
        self.param_shapes, self.state_shapes = ctx.reference().leaf_shapes(cfg)
        tcfg = TrainConfig(batch_size=t["batch"], learning_rate=cfg["learning_rate"],
                           decay_step=cfg["lr_decay_step"], decay_rate=cfg["lr_decay_rate"],
                           lr_floor=cfg["lr_floor"], optimizer=cfg["optimizer"],
                           grad_clip=cfg["grad_clip"], seed=0)
        self.trainer = pcrnet_trainer.PCRNetTrainer(
            self._config(), tcfg, loss_type=cfg["loss_type"],
            dpdist=(dpdist_config(self.frozen), nest(self.arrays), None),
            train_single=cfg["train_single"],
            run_dir=os.path.join(tempfile.gettempdir(), "portbench_pcrnet"),
            logger=NullLogger(), device=ctx.device)
        leaves = dict(tree_flatten_with_paths(self.trainer.params))
        states = dict(tree_flatten_with_paths(self.trainer.state))
        got = ({p: tuple(v.shape) for p, v in leaves.items()},
               {p: tuple(v.shape) for p, v in states.items()})
        if got != (self.param_shapes, self.state_shapes):
            raise RuntimeError("the program's PCRNet leaves differ from the configuration's")
        with torch.no_grad():
            for p, v in initial_leaves(self.param_shapes, ctx.seed, ctx.device).items():
                leaves[p].copy_(v)
            for p, v in initial_leaves(self.state_shapes, ctx.seed, ctx.device).items():
                states[p].copy_(v)
        tmpl, src = pair_pool(t, ctx.seed)
        scale = np.float32(t["surface_scale"])
        self.tmpl = torch.as_tensor(tmpl * scale, device=ctx.device)
        self.src = torch.as_tensor(src * scale, device=ctx.device)
        self.checked = t["checked_steps"]
        self.log_every = t["log_every"]
        self._windows = {}
        losses = [self._first_step(pcrnet_trainer, leaves)]
        for i in range(1, self.checked):
            losses.append(self.trainer.train_step(self.tmpl[i], self.src[i])["loss"])
        self.losses = [float(v) for v in losses]

    def _first_step(self, module, leaves):
        """The first checked step, recording the program's values (see the
        module docstring); returns its loss."""
        from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

        trainer, seen = self.trainer, {}
        refine, step = module.pcrnet_refine, trainer.optimizer.step

        def recording_refine(*args, **kwargs):
            out = refine(*args, **kwargs)
            seen["poses"], seen["trajectory"] = out[2].detach().clone(), out[3].detach().clone()
            return out

        def recording_step(params, grads, state):
            seen["grads"] = [g.detach().clone() for g in grads]
            return step(params, grads, state)

        module.pcrnet_refine, trainer.optimizer.step = recording_refine, recording_step
        try:
            loss = trainer.train_step(self.tmpl[0], self.src[0])["loss"]
        finally:
            module.pcrnet_refine = refine
            del trainer.optimizer.step
        start = initial_leaves(self.param_shapes, self.ctx.seed, self.ctx.device)
        self.record = {
            "poses": seen["poses"], "trajectory": seen["trajectory"],
            "grads": dict(zip(leaves, seen["grads"])),
            "state": {p: v.detach().clone() for p, v in tree_flatten_with_paths(trainer.state)},
            "update": {p: v.detach() - start[p] for p, v in leaves.items()},
        }
        return loss

    def step(self, i):
        spans = self.ctx.spans
        k = (i + self.checked) % len(self.tmpl)
        with spans("entry"):
            metrics = self.trainer.train_step(self.tmpl[k], self.src[k])
        if (i + 1) % self.log_every == 0:
            with spans("log"):
                self.failed += int(not math.isfinite(float(metrics["loss"])))

    def release(self):
        self.__dict__.pop("trainer", None)

    def step_flops(self):
        t = self.ctx.traffic
        return pcrnet_counts.step_flops(self.ctx.config, self.frozen, t["batch"], t["num_point"])

    def kernel_work(self, kernel, step):
        """Row 7: each iteration's encode of the 2B clouds, and the loss's
        encodes of the L * B sources and of their templates. Row 3: the
        loss's one adjoint, into the sources' volumes, queried by the
        templates' points (known from the batch)."""
        cfg, t, fz = self.ctx.config, self.ctx.traffic, self.frozen
        L, B, N = cfg["max_loops"], t["batch"], t["num_point"]
        C, G = counts.fv_channels(fz), fz["embedding_size"]
        if kernel == "threedmfv":
            works = ([counts.row7_work(2 * B, N, cfg["mfv_grid"] ** 3, C)] * L
                     + [counts.row7_work(L * B, N, G, C)] * 2)
            return sum(w[0] for w in works), sum(w[1] for w in works)
        if kernel == "table_gather_bwd":
            k = (step + self.checked) % len(self.tmpl)
            if k not in self._windows:
                self._windows[k] = counts.windows(self.tmpl[k].cpu().numpy(),
                                                  counts.grid_of(G), fz["k"])[1]
            return counts.row3_work(L * B, N, G, C, L * self._windows[k])
        return None

    # --- the check ---------------------------------------------------------

    def _reference_step(self, kind, params, state, i, trajectory=None):
        ref, ctx = self.ctx.reference(), self.ctx
        net = ctx.reference(self.ctx.config["frozen_loss"]).Net(self.frozen, self.arrays,
                                                               ctx.device)
        return ref.step(ctx.config, ref.Arith(kind, ctx.device), net, params, state,
                        self.tmpl[i], self.src[i], trajectory=trajectory, block=BLOCK)

    def _free_run(self, kind):
        """The reference's own run of the checked steps: (the first step's
        record, as the program's is kept, and every step's loss)."""
        ref, cfg, ctx = self.ctx.reference(), self.ctx.config, self.ctx
        params = initial_leaves(self.param_shapes, ctx.seed, ctx.device)
        state = initial_leaves(self.state_shapes, ctx.seed, ctx.device)
        mu = {p: torch.zeros_like(v) for p, v in params.items()}
        nu = {p: torch.zeros_like(v) for p, v in params.items()}
        losses, first = [], None
        for i in range(self.checked):
            out = self._reference_step(kind, params, state, i)
            update = ref.adam_update(cfg, ref.clip(cfg, out["grads"]), mu, nu, i)
            moved = {p: v + update[p] for p, v in params.items()}
            if first is None:
                first = {"poses": out["poses"], "trajectory": out["trajectory"],
                         "grads": out["grads"], "state": out["state"],
                         "update": {p: moved[p] - v for p, v in params.items()}}
            params = moved
            state = out["state"]
            losses.append(out["loss"])
        return first, losses

    def _gaps(self, record, losses, later):
        """Each number of the check for the program's (or the control's)
        first step `record` and step losses, against the float32 reference
        teacher-forced on its trajectory, and `later`, the reference's own
        losses of the later steps. pose_gap: the worst |pose - reference|
        of any iteration; loss_gap: the first step's loss against the
        reference's loss of the same trajectory, relative (the loss of the
        trajectory the reference's poses give would also read the loss's
        jumps: a point moved by rounding across a cell boundary);
        grad_gap: the worst leaf of the gradient handed to the optimizer,
        among the leaves whose reference gradient is not negligible (a conv
        bias before a BN has none in exact arithmetic); state_gap: the
        worst leaf of the BN state after the step; update_gap: the worst
        leaf of the update applied against the reference's clipped Adam
        step on the same gradient, both as changes of the float32 weights
        (whose rounding, not the step's, sets what a change can show);
        later_loss_gap (read, not compared): the later steps' losses
        against the free-running reference's, relative. A trajectory not of
        the fed batch's shape reads inf."""
        ref, cfg, ctx = self.ctx.reference(), self.ctx.config, self.ctx
        L = cfg["max_loops"]
        if tuple(record["trajectory"].shape) != (L,) + tuple(self.src[0].shape):
            return {n: math.inf for n in NUMBERS}
        params = initial_leaves(self.param_shapes, ctx.seed, ctx.device)
        state = initial_leaves(self.state_shapes, ctx.seed, ctx.device)
        want = self._reference_step("float32", params, state, 0, record["trajectory"])
        g = want["grads"]
        med = statistics.median(_norm(v) for v in g.values())
        moved = [p for p in g if _norm(g[p]) >= NEGLIGIBLE * med]
        zeros = {p: torch.zeros_like(v) for p, v in params.items()}
        step = ref.adam_update(cfg, ref.clip(cfg, record["grads"]), zeros, dict(zeros), 0)
        update = {p: (params[p] + u) - params[p] for p, u in step.items()}
        later_gap = [abs(a - b) / abs(b) for a, b in zip(losses[1:], later[1:])]
        return {
            "pose_gap": float((record["poses"] - want["poses"]).abs().max()),
            "loss_gap": abs(losses[0] - want["loss"]) / abs(want["loss"]),
            "grad_gap": _worst(record["grads"], g, moved),
            "state_gap": _worst(record["state"], want["state"]),
            "update_gap": _worst(record["update"], update),
            "later_loss_gap": max(later_gap) if later_gap else 0.0,
        }

    def check(self):
        return self._gaps(self.record, self.losses, self._free_run("float32")[1])

    def control(self):
        record, losses = self._free_run("tf32")
        return self._gaps(record, losses, self._free_run("float32")[1])
