"""AUE training: train.aue_trainer.AUETrainer.train_step back to back on
batches of same-surface pairs (the "ours" loss: the frozen DPDist loss of
the reconstruction of x1 against x2), reading the loss back every
`log_every` steps, as the trainer's own loop logs.

Set-up builds the one trainer the window drives, writes the weights the
benchmark made from the seed into its leaves, and runs its first
`checked_steps` steps through the same call and feed as the window, on
the pool's first batches: they are the warm-up, and what the check holds
against the plain reference (the first step's loss and BN state, the
change of each leaf over the steps; the later losses and the first
gradient's norm per leaf as Adam took it are read and not compared).
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile

import numpy as np
import torch

from portbench.core import counts
from portbench.core.driver import Driver as Base
from portbench.core.pairs import dpdist_config
from portbench.core.traffic import pair_pool
from portbench.core.weights import initial_leaves, nest, read_checkpoint

NEGLIGIBLE = 1e-3       # a leaf whose reference gradient is under this share of the median
                        # leaf's moves by rounding alone: its change is not compared


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach()))


class Driver(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.units_per_step = ctx.traffic["batch"]

    def _model_config(self):
        """The AUE configuration with what the reference needs of the frozen
        net's (its FV channels)."""
        cfg = dict(self.ctx.config)
        cfg["fv_channels"] = counts.fv_channels(self.frozen)
        return cfg

    def setup(self):
        from dpdist_tpu_torch.configs import AUEConfig, TrainConfig
        from dpdist_tpu_torch.models import aue as aue_model
        from dpdist_tpu_torch.train.aue_trainer import AUETrainer
        from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
        from dpdist_tpu_torch.train.logging import NullLogger

        ctx, cfg, t = self.ctx, self.ctx.config, self.ctx.traffic
        if (aue_model.SIGMA, aue_model.INCEPTION_FILTERS) != (cfg["sigma"], cfg["inception_filters"]):
            raise RuntimeError("the program's AUE is not the configuration's: sigma "
                               f"{aue_model.SIGMA}, inception filters {aue_model.INCEPTION_FILTERS}")
        self.frozen = ctx.config_named(cfg["frozen_loss"])
        self.arrays = read_checkpoint(str(ctx.root / self.frozen["checkpoint"]))
        self.param_shapes, self.state_shapes = ctx.reference().leaf_shapes(self._model_config())
        tcfg = TrainConfig(batch_size=t["batch"], learning_rate=cfg["learning_rate"],
                           decay_step=cfg["lr_decay_step"], decay_rate=cfg["lr_decay_rate"],
                           lr_floor=cfg["lr_floor"], optimizer="adam", seed=0)
        acfg = AUEConfig(num_point=cfg["num_point"], encoder=cfg["encoder"],
                         n_gaussians=cfg["n_gaussians"], use_bn=cfg["use_bn"])
        self.trainer = AUETrainer(acfg, tcfg, dpdist_config(self.frozen), nest(self.arrays), None,
                                  opt_type=cfg["opt_type"],
                                  run_dir=os.path.join(tempfile.gettempdir(), "portbench_aue"),
                                  logger=NullLogger(), device=ctx.device)
        leaves = dict(tree_flatten_with_paths(self.trainer.params))
        states = dict(tree_flatten_with_paths(self.trainer.state))
        got = ({p: tuple(v.shape) for p, v in leaves.items()},
               {p: tuple(v.shape) for p, v in states.items()})
        if got != (self.param_shapes, self.state_shapes):
            raise RuntimeError("the program's AUE leaves differ from the configuration's")
        with torch.no_grad():
            for p, v in initial_leaves(self.param_shapes, ctx.seed, ctx.device).items():
                leaves[p].copy_(v)
        x1, x2 = pair_pool(t, ctx.seed)
        self.x1, self.x2 = x1, x2
        # The dataset's batches: the surface block [x1, x2], then the
        # off-surface block that the trainer does not read.
        tail = np.zeros(x1.shape[:2] + (4 * x1.shape[2], 3), np.float32)
        self.data = np.concatenate([x1, x2, tail], axis=2)
        self.checked = t["checked_steps"]
        losses, b1 = [], cfg["adam_b1"]
        for i in range(self.checked):
            losses.append(self.trainer.train_step(self.data[i])["loss"])
            if i == 0:
                self.grad_norms = {p: _norm(m) / (1 - b1) for p, m in
                                   zip(leaves, self.trainer.opt_state["mu"])}
                self.state = {p: v.detach().clone()
                              for p, v in tree_flatten_with_paths(self.trainer.state)}
        self.losses = [float(v) for v in losses]
        start = initial_leaves(self.param_shapes, ctx.seed, ctx.device)
        self.changes = {p: _norm(v - start[p]) for p, v in
                        tree_flatten_with_paths(self.trainer.params)}
        del start
        self.log_every = t["log_every"]

    def step(self, i):
        spans = self.ctx.spans
        with spans("entry"):
            metrics = self.trainer.train_step(self.data[(i + self.checked) % len(self.data)])
        if (i + 1) % self.log_every == 0:
            with spans("log"):
                self.failed += int(not math.isfinite(float(metrics["loss"])))

    def step_flops(self):
        return counts.aue_step_flops(self.ctx.config, self.frozen, self.ctx.traffic["batch"])

    def release(self):
        self.__dict__.pop("trainer", None)

    def _reference(self, kind):
        """The reference's run of the checked steps: (losses, first gradient
        norms, changes, BN state after the first step), each leaf by its
        path."""
        ref, ctx = self.ctx.reference(), self.ctx
        dref = ctx.reference(self.ctx.config["frozen_loss"])
        cfg = self._model_config()
        net, arith = dref.Net(self.frozen, self.arrays, ctx.device), dref.Arith(kind, ctx.device)
        params = {p: v.clone() for p, v in
                  initial_leaves(self.param_shapes, ctx.seed, ctx.device).items()}
        state = initial_leaves(self.state_shapes, ctx.seed, ctx.device)
        batches = [(torch.as_tensor(self.x1[i], device=ctx.device),
                    torch.as_tensor(self.x2[i], device=ctx.device)) for i in range(self.checked)]
        losses, grads, first_state = ref.train(cfg, arith, net, params, state, batches)
        start = initial_leaves(self.param_shapes, ctx.seed, ctx.device)
        changes = {p: _norm(params[p] - start[p]) for p in params}
        return losses, grads, changes, first_state

    @staticmethod
    def _gaps(got, want):
        """loss_gap: the first step's loss, relative; state_gap: the worst BN
        state leaf after the first step, ||program - reference|| over the
        larger of its reference norm and the median leaf's; change_gap: the
        worst leaf's gap between the two norms of its change over the
        steps, over the larger of the reference's norm of that leaf and of
        the median leaf, among the leaves whose reference gradient is not
        negligible. Read and not compared (they swing from seed to seed in
        float32 alone, PERF.md): later_loss_gap, the later steps' losses;
        grad_gap, the first gradient's norms, by the worst leaf."""
        (lp, gp, cp, sp), (lr, gr, cr, sr) = got, want
        med_g = statistics.median(gr.values())
        moved = [p for p in gr if gr[p] >= NEGLIGIBLE * med_g]
        med_c = statistics.median(cr[p] for p in moved)
        s_norm = {p: _norm(v) for p, v in sr.items()}
        med_s = statistics.median(s_norm.values())
        loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
        return {
            "loss_gap": loss[0],
            "state_gap": max(_norm(sp[p] - sr[p]) / max(s_norm[p], med_s) for p in sr),
            "change_gap": max(abs(cp[p] - cr[p]) / max(cr[p], med_c) for p in moved),
            "later_loss_gap": max(loss[1:]),
            "grad_gap": max(abs(gp[p] - gr[p]) / max(gr[p], med_g) for p in gr),
        }

    def check(self):
        return self._gaps((self.losses, self.grad_norms, self.changes, self.state),
                          self._reference("float32"))

    def control(self):
        return self._gaps(self._reference("tf32"), self._reference("float32"))
