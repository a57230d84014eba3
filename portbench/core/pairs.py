"""What the frozen-distance drivers share: the DPDist configuration and
its committed weights, the pool of (template, source) pairs, and the
kernels' work on each batch of the pool."""

from __future__ import annotations

import dataclasses

import torch

from portbench.core import counts
from portbench.core.driver import Driver
from portbench.core.traffic import pair_pool
from portbench.core.weights import nest, read_checkpoint


def dpdist_config(cfg: dict):
    """The program's DPDistConfig of a configuration file."""
    from dpdist_tpu_torch.configs import DPDistConfig

    names = {f.name for f in dataclasses.fields(DPDistConfig)}
    return DPDistConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg.items() if k in names})


class PairDriver(Driver):
    """A call on one batch of (template, source) pairs of the pool; call i
    takes batch i % pool_batches."""

    def __init__(self, ctx):
        super().__init__(ctx)
        t = ctx.traffic
        self.units_per_step = t["batch"]
        self.pool = t["pool_batches"]
        self.answers = []
        self._windows = {}

    def load(self):
        """The configuration, the checkpoint's arrays, the program's params
        tree on the device and the pool of pairs on the device."""
        ctx = self.ctx
        self.dcfg = dpdist_config(ctx.config)
        self.arrays = read_checkpoint(str(ctx.root / ctx.config["checkpoint"]))
        self.params = nest(self.arrays, lambda a: torch.as_tensor(a, device=ctx.device))
        self.tmpl_np, self.src_np = pair_pool(ctx.traffic, ctx.seed)
        self.tmpl = torch.as_tensor(self.tmpl_np, device=ctx.device)
        self.src = torch.as_tensor(self.src_np, device=ctx.device)

    def batch(self, i: int) -> int:
        return i % self.pool

    def warm_up(self):
        for i in range(self.ctx.traffic["warmup_steps"]):
            self.step(i)
        self.ctx.sync()
        self.answers.clear()
        self.failed = 0

    def release(self):
        for name in ("model", "loss_fn", "params"):
            self.__dict__.pop(name, None)

    def net(self):
        return self.ctx.reference().Net(self.ctx.config, self.arrays, self.ctx.device)

    def arith(self, kind):
        return self.ctx.reference().Arith(kind, self.ctx.device)

    def windows(self, j: int, which: str):
        """(reached cells, in-grid windows) of batch j's template ("tmpl")
        or source ("src") points as queries."""
        if (j, which) not in self._windows:
            cfg = self.ctx.config
            pts = (self.tmpl_np if which == "tmpl" else self.src_np)[j]
            self._windows[j, which] = counts.windows(pts, counts.grid_of(cfg["embedding_size"]),
                                                     cfg["k"])
        return self._windows[j, which]

    def answered(self):
        """The pool batches the window's answers came from."""
        return sorted({a[0] for a in self.answers})

    def shape(self):
        cfg = self.ctx.config
        return (self.ctx.traffic["batch"], self.ctx.traffic["num_point"], cfg["embedding_size"],
                counts.fv_channels(cfg), counts.patch_dim(cfg))
