"""DPDist training: train.trainer.DPDistTrainer.train_step back to back on
batches laid out as the source's dataset gives them, reading the loss back
every `log_every` steps, as a training loop logs.

The traffic is the source's ground-truth protocol
(dataset_sample_with_gt.py:60-139, the program's data/gtgen.py) on the
benchmark's own surfaces, with distances computed here by numpy: each
surface a dense sample scaled by `surface_scale`; candidates drawn
uniformly in the unit ball, a "near" set at near[0] < d < near[1] and a
"far" set at d > far, where d is a candidate's distance to the nearest
dense point; the last `outside_share` of the far set replaced by cube
points outside the unit sphere. A pair is one surface: its (B, 6N, 3) row
holds 2N surface points (two samplings, A's and B's), 2N near and 2N far
points, all under one uniform rotation (the source's AUG1), and its (B,
4N) labels the near and far points' distances.

Set-up builds the one trainer the window drives, writes the weights the
benchmark made from the seed into its leaves, and runs its first
`checked_steps` steps through the same call and feed as the window, on
the pool's first batches: they are the warm-up, and what the check holds
against the plain reference (the first step's loss, the first gradient's
norm per leaf as Adam took it, each leaf's change over the steps, and the
later steps' losses, which see the direction of each update).
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.core import counts
from portbench.core.driver import Driver as Base
from portbench.core.pairs import dpdist_config
from portbench.core.traffic import rotations, synthetic_surface
from portbench.core.weights import initial_leaves
from portbench.drivers.aue_train import NEGLIGIBLE, _norm


def _nearest(points: np.ndarray, dense: np.ndarray) -> np.ndarray:
    """(P,) float32 distance from each point to the nearest dense point:
    min over the dense points of |d|^2 - 2 q.d, plus |q|^2."""
    d2 = np.sum(dense * dense, 1)[None, :]
    out = np.empty(len(points), np.float32)
    for s in range(0, len(points), 1024):
        q = points[s:s + 1024]
        m = q @ (-2.0 * dense.T)
        np.add(m, d2, out=m)
        out[s:s + 1024] = np.sqrt(np.maximum(m.min(1) + np.sum(q * q, 1), 0.0))
    return out


def _in_ball(rng, n: int) -> np.ndarray:
    """n points uniform in the unit ball (the source's dropped-coordinates draw)."""
    g = rng.standard_normal((5, n))
    return (g[2:] / np.sqrt((g * g).sum(0))).T.astype(np.float32)


def ground_truth(dense: np.ndarray, rng, t: dict):
    """(near, far): (gt_points, 4) float32 sets of xyz and distance."""
    m, (lo, hi), far_min = t["gt_points"], t["near"], t["far"]
    near, far, n_near, n_far = [], [], 0, 0
    while n_near < m or n_far < m:
        cand = _in_ball(rng, t["candidates"])
        d = _nearest(cand, dense)
        with_d = np.concatenate([cand, d[:, None]], 1)
        near.append(with_d[(d > lo) & (d < hi)])
        far.append(with_d[d > far_min])
        n_near, n_far = n_near + len(near[-1]), n_far + len(far[-1])
    near, far = np.concatenate(near)[:m], np.concatenate(far)[:m]
    n_out, outs, n_o = int(m * t["outside_share"]), [], 0
    while n_o < n_out:
        # About half the cube lies outside the unit sphere.
        cand = rng.uniform(-1, 1, (4 * n_out, 3)).astype(np.float32)
        cand = cand[np.linalg.norm(cand, axis=1) > 1]
        outs.append(np.concatenate([cand, _nearest(cand, dense)[:, None]], 1))
        n_o += len(cand)
    if n_out:
        far[-n_out:] = np.concatenate(outs)[:n_out]
    return near, far


def _pick(rng, rows: int, size: int, n: int) -> np.ndarray:
    """(rows, n) indices, each row n distinct draws from range(size) in random order."""
    keys = rng.random((rows, size), dtype=np.float32)
    idx = np.argpartition(keys, n - 1, axis=1)[:, :n]
    return np.take_along_axis(idx, np.argsort(np.take_along_axis(keys, idx, 1), 1), 1)


def _surface(t: dict, seed: int, i: int, surface_seed: int):
    """(dense, near, far) of surface i, its ground truth drawn by a generator
    of its own, (seed, i)."""
    fams = t["families"]
    dense = synthetic_surface(fams[i % len(fams)], surface_seed, t["surface_points"])
    dense = (dense * np.float32(t["surface_scale"])).astype(np.float32)
    return (dense, *ground_truth(dense, np.random.default_rng((seed, i)), t))


def training_pool(t: dict, seed: int):
    """(data (pool, B, 6N, 3), labels (pool, B, 4N)) float32. The surfaces
    are made on the host's cores side by side; each draws from its own
    generator, so the pool depends on the seed alone."""
    rng = np.random.default_rng(seed)
    n = t["num_point"]
    seeds = rng.integers(0, 2 ** 31, t["surfaces"])
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        sets = list(pool.map(lambda i: _surface(t, seed, i, int(seeds[i])), range(t["surfaces"])))
    dense = np.stack([s[0] for s in sets])
    near = np.stack([s[1] for s in sets])
    far = np.stack([s[2] for s in sets])
    B, P = t["batch"], t["pool_batches"]
    data = np.empty((P, B, 6 * n, 3), np.float32)
    labels = np.empty((P, B, 4 * n), np.float32)
    for b in range(P):
        which = rng.integers(0, t["surfaces"], B)[:, None]
        surf = dense[which, _pick(rng, B, dense.shape[1], 2 * n)]
        nr = near[which, _pick(rng, B, near.shape[1], 2 * n)]
        fr = far[which, _pick(rng, B, far.shape[1], 2 * n)]
        rot = (rotations(rng, B) if t["rotate"] == "uniform"
               else np.broadcast_to(np.eye(3), (B, 3, 3)))
        pts = np.concatenate([surf, nr[..., :3], fr[..., :3]], 1)
        data[b] = np.einsum("bij,bnj->bni", rot, pts)
        labels[b] = np.concatenate([nr[..., 3], fr[..., 3]], 1)
    return data, labels


def assemble(data: np.ndarray, labels: np.ndarray):
    """(pcA, pcB, labels_AB) of a (B, 6N, 3) batch, as the source's trainer
    reads it: A's N surface points; for B, the first half of its surface
    points, a quarter near and a quarter far points; their distances (0 on
    the surface)."""
    B, total, _ = data.shape
    n = total // 6
    h, q = n // 2, n // 4
    surface, near, far = data[:, :2 * n], data[:, 2 * n:4 * n], data[:, 4 * n:]
    near_d, far_d = labels[:, :2 * n], labels[:, 2 * n:]
    pcB = np.concatenate([surface[:, n:n + h], near[:, :q], far[:, q:h]], 1)
    lab = np.concatenate([np.zeros((B, h), np.float32), near_d[:, :q], far_d[:, q:h]], 1)
    return surface[:, :n], pcB, lab


class Driver(Base):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.units_per_step = ctx.traffic["batch"]

    def _start(self):
        """{path: tensor} the training starts from: the seeded leaves, the
        output bias offset as the program's init_dpdist starts a relu head."""
        cfg = self.ctx.config
        leaves = initial_leaves(self.param_shapes, self.ctx.seed, self.ctx.device)
        leaves[self.ctx.reference().head_bias(cfg)].add_(cfg["head_bias_offset"])
        return leaves

    def setup(self):
        from dpdist_tpu_torch.configs import TrainConfig
        from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
        from dpdist_tpu_torch.train.logging import NullLogger
        from dpdist_tpu_torch.train.trainer import DPDistTrainer

        ctx, cfg, t = self.ctx, self.ctx.config, self.ctx.traffic
        tcfg = TrainConfig(batch_size=t["batch"], learning_rate=cfg["learning_rate"],
                           decay_step=cfg["lr_decay_step"], decay_rate=cfg["lr_decay_rate"],
                           lr_floor=cfg["lr_floor"], optimizer=cfg["optimizer"],
                           weight_decay=cfg["weight_decay"], add_noise=cfg["add_noise"],
                           augment=False, seed=0)
        run_dir = os.path.join(tempfile.gettempdir(), "portbench_dpdist")
        self.trainer = DPDistTrainer(dpdist_config(cfg), tcfg, run_dir=run_dir,
                                     logger=NullLogger(), device=ctx.device)
        self.param_shapes = ctx.reference().leaf_shapes(cfg)
        leaves = dict(tree_flatten_with_paths(self.trainer.params))
        if {p: tuple(v.shape) for p, v in leaves.items()} != self.param_shapes:
            raise RuntimeError("the program's DPDist leaves differ from the configuration's")
        with torch.no_grad():
            for p, v in self._start().items():
                leaves[p].copy_(v)
        self.data, self.labels = training_pool(t, ctx.seed)
        self.checked = t["checked_steps"]
        losses = []
        for i in range(self.checked):
            losses.append(self.trainer.train_step(self.data[i], self.labels[i])["loss"])
            if i == 0:
                self.grad_norms = {p: _norm(m) / (1 - cfg["adam_b1"]) for p, m in
                                   zip(leaves, self.trainer.opt_state["mu"])}
        self.losses = [float(v) for v in losses]
        start = self._start()
        self.changes = {p: _norm(v - start[p]) for p, v in
                        tree_flatten_with_paths(self.trainer.params)}
        del start
        self.log_every = t["log_every"]

    def step(self, i):
        spans = self.ctx.spans
        k = (i + self.checked) % len(self.data)
        with spans("entry"):
            metrics = self.trainer.train_step(self.data[k], self.labels[k])
        if (i + 1) % self.log_every == 0:
            with spans("log"):
                self.failed += int(not math.isfinite(float(metrics["loss"])))

    def step_flops(self):
        """The AB direction's GEMMs at B x N rows: forward, the weight
        gradients, and the input gradients of every layer but the first
        (its input, the gathered patches, needs none)."""
        cfg, t = self.ctx.config, self.ctx.traffic
        rows = t["batch"] * t["num_point"]
        row = counts.decoder_row_flops(cfg)
        first = 2 * (cfg["dims"] + counts.patch_dim(cfg)) * cfg["mlp"][0]
        return rows * (3 * row - first)

    def release(self):
        self.__dict__.pop("trainer", None)

    def _reference(self, kind):
        """(losses, first gradient norms, changes) of the reference's run of
        the checked steps, each leaf by its path."""
        ref, ctx = self.ctx.reference(), self.ctx
        params = {p: v.clone() for p, v in self._start().items()}
        batches = [tuple(torch.as_tensor(a, device=ctx.device)
                         for a in assemble(self.data[i], self.labels[i]))
                   for i in range(self.checked)]
        losses, grads = ref.train(ctx.config, ref.Arith(kind, ctx.device), params, batches)
        start = self._start()
        return losses, grads, {p: _norm(params[p] - start[p]) for p in params}

    @staticmethod
    def _gaps(got, want):
        """loss_gap: the first step's loss, relative; change_gap: the worst
        leaf's gap between the two norms of its change over the steps, over
        the larger of the reference's norm of that leaf and of the median
        leaf, among the leaves whose reference gradient is not negligible;
        later_loss_gap: the worst of the later steps' losses, relative (the
        norms of the changes do not see an update's direction, as Adam's
        first steps move each weight by about lr * sign(g); the losses after
        them do); grad_gap: the worst leaf's gap between the norms of the
        first gradient, over the larger of the reference's norm of that
        leaf and of the median leaf."""
        (lp, gp, cp), (lr, gr, cr) = got, want
        med_g = statistics.median(gr.values())
        moved = [p for p in gr if gr[p] >= NEGLIGIBLE * med_g]
        med_c = statistics.median(cr[p] for p in moved)
        loss = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
        return {"loss_gap": loss[0],
                "change_gap": max(abs(cp[p] - cr[p]) / max(cr[p], med_c) for p in moved),
                "later_loss_gap": max(loss[1:]),
                "grad_gap": max(abs(gp[p] - gr[p]) / max(gr[p], med_g) for p in gr)}

    def check(self):
        return self._gaps((self.losses, self.grad_norms, self.changes),
                          self._reference("float32"))

    def control(self):
        return self._gaps(self._reference("tf32"), self._reference("float32"))
