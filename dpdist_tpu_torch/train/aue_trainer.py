"""The autoencoder trained on the frozen DPDist loss (port of AUETrainer,
dpdist_tpu/train/aue_trainer.py), on one device or data-parallel over a
mesh.

    trainer = AUETrainer(AUEConfig(encoder="3dmfv"), TrainConfig(), dcfg, dparams, dstate,
                         opt_type="ours")
    trainer.fit(train_dataset, test_dataset, max_epoch=300)

The reference's phases 2 and 3 (train_multi_gpu_pc_compare_dist.py:358-515)
splice the frozen DPDist graph onto the AUE and train the AUE alone; here
the splice is function composition:

    loss = dpdist_frozen(aue(params, x1), x2)        # opt_type="ours"
    loss = chamfer(x1, aue(params, x1), sqrt=False)  # opt_type="chamfer"

with x1, x2 two same-surface samples (the surface block of a dataset batch
halved). The frozen DPDist parameters are detached on every call
(losses/dpdist_loss.py): they get no gradient and no update. On the card
the "ours" step's frozen loss runs the table-gather kernel twice (both
directions) and its adjoint once (the gradient reaches the reconstruction
through surface(rec)); chamfer at 64 points is the plain path.

A step is the reference's sharded step body (dpdist_tpu/parallel/shard.py:
53-66): the loss and its gradients in the AUE's params, one optimizer
update (make_optimizer: Adam with the staircase LR by default), the new BN
state (EMA, detached) and the gradient's global norm, built by
parallel.build_sharded_train_step. On one device it makes no collective
(no pmean); on a mesh whose 'data' axis holds n > 1 processes every
process takes its rows of the pair batch and the step averages the
gradients, the loss and the state over the axis; rank 0 alone writes
checkpoints and logs. The monitor (DPDist and squared chamfer of the
eval-mode reconstruction, outside autograd) and the checkpoints
({"params", "state"}, aue_config and opt_type in the metadata) are the
reference's, so either package restores the other's checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import AUEConfig, DPDistConfig, TrainConfig
from dpdist_tpu_torch.losses.dpdist_loss import make_frozen_dpdist_loss
from dpdist_tpu_torch.models.aue import apply_aue, init_aue
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.ops.chamfer import chamfer_distance
from dpdist_tpu_torch.parallel import build_sharded_train_step, local_mesh, replicate, shard_batch
from dpdist_tpu_torch.train.checkpoint import (
    archive_checkpoint,
    archived_meta,
    archived_metric,
    restore_checkpoint,
    save_checkpoint,
    tree_flatten_with_paths,
)
from dpdist_tpu_torch.train.logging import NullLogger, RunLogger
from dpdist_tpu_torch.train.optim import make_optimizer

OPT_TYPES = ("ours", "chamfer")


def split_same_surface(batch_data: np.ndarray):
    """(B, 3*2N, 3) dataset batch -> x1, x2: two N-point same-surface samples."""
    B, total, _ = batch_data.shape
    n2 = total // 3
    N = n2 // 2
    surface = batch_data[:, :n2]
    return (surface[:, :N].astype(np.float32),
            surface[:, N:2 * N].astype(np.float32))


class AUETrainer:
    def __init__(self, aue_cfg: AUEConfig, train_cfg: TrainConfig, dpdist_cfg: DPDistConfig,
                 dpdist_params, dpdist_state=None, *, opt_type: str = "ours",
                 run_dir: str = "runs/aue", mesh=None, logger: Optional[RunLogger] = None,
                 device="cuda"):
        """dpdist_params, dpdist_state: the frozen net's params and BN state
        as load_dpdist_checkpoint returns them (numpy leaves) or as the
        port's tensors (the state None for a net without BN). The AUE starts
        from init_aue with a generator seeded with train_cfg.seed. mesh: a
        parallel.Mesh (None: one device)."""
        if opt_type not in OPT_TYPES:
            raise ValueError(f"opt_type must be one of {OPT_TYPES}, got {opt_type!r}")
        self.device = resolve_device(device)
        self.acfg = aue_cfg
        self.tcfg = train_cfg
        self.opt_type = opt_type
        self.run_dir = run_dir
        self.mesh = mesh if mesh is not None else local_mesh(self.device)
        self.logger = logger or (RunLogger(run_dir, config_json=aue_cfg.to_json(),
                                           name=f"train_aue_{opt_type}")
                                 if self.mesh.writes else NullLogger())
        self.params, self.state = init_aue(
            aue_cfg, torch.Generator().manual_seed(train_cfg.seed), self.device)
        for _, t in tree_flatten_with_paths(self.params):
            t.requires_grad_(True)
        replicate({"params": self.params, "state": self.state}, self.mesh)
        self.optimizer = make_optimizer(train_cfg, base_lr=train_cfg.learning_rate)
        init_opt, self._step = build_sharded_train_step(self.step_loss, self.optimizer, self.mesh)
        self.opt_state = init_opt(self.params)
        self.global_step = 0
        self._dp_loss = make_frozen_dpdist_loss(
            params_to_device(dpdist_params, self.device), dpdist_cfg,
            state=params_to_device(dpdist_state, self.device))

    # ------------------------------------------------------------------

    def _pair(self, batch_data):
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in split_same_surface(np.asarray(batch_data)))

    def loss(self, params, state, x1, x2):
        """(the train loss, the new BN state) of one pair batch."""
        rec, new_state = apply_aue(params, state, self.acfg, x1, train=True)
        if self.opt_type == "ours":
            return self._dp_loss(rec, x2), new_state
        # squared chamfer, the reference's chmafer_dist (:912-916)
        return chamfer_distance(x1, rec, sqrt=False), new_state

    def step_loss(self, params, state, batch):
        """(the train loss, the new BN state) of batch = (x1, x2)."""
        return self.loss(params, state, *batch)

    def loss_grads_state(self, x1, x2):
        """The train loss, its gradients in the params (in the order of
        tree_flatten_with_paths(self.params)) and the new BN state."""
        leaves = [t for _, t in tree_flatten_with_paths(self.params)]
        with torch.enable_grad():
            loss, new_state = self.loss(self.params, self.state, x1, x2)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads, new_state

    def train_step(self, batch_data):
        """One optimizer step on a dataset batch (B, 6N, 3); returns {"loss",
        "grad_norm"} as 0-d device tensors."""
        self.params, self.state, self.opt_state, metrics = self._step(
            self.params, self.state, self.opt_state,
            shard_batch(self._pair(batch_data), self.mesh))
        self.global_step += 1
        return metrics

    @torch.no_grad()
    def monitor(self, x1, x2):
        """(DPDist, squared chamfer) of the eval-mode reconstruction of x1
        against x2 and x1, whichever loss trains (the reference logs both,
        :466-469); 0-d device tensors."""
        rec, _ = apply_aue(self.params, self.state, self.acfg, x1, train=False)
        return self._dp_loss(rec, x2), chamfer_distance(x1, rec, sqrt=False)

    @torch.no_grad()
    def reconstruct(self, points):
        """The eval-mode reconstruction of (B, N, 3) points, as numpy."""
        x = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        rec, _ = apply_aue(self.params, self.state, self.acfg, x, train=False)
        return rec.cpu().numpy()

    def train_epoch(self, dataset, epoch: int, *, snapshot_every: int = 0):
        """Steps on every full batch; the monitor on the last one, and a
        reconstruction snapshot every snapshot_every epochs."""
        losses, bd = [], None
        dataset.reset()
        while dataset.has_next_batch():
            bd, _ = dataset.next_batch(augment=False)
            if bd.shape[0] < self.tcfg.batch_size:
                continue
            losses.append(self.train_step(bd)["loss"])
        if not losses:
            return float("nan")
        mean_loss = float(np.mean(torch.stack(losses).cpu().numpy(), dtype=np.float64))
        dp, ch = (float(v) for v in self.monitor(*self._pair(bd)))
        self.logger.log(f" ---- epoch: {epoch + 1:03d} ---- DPDist mean loss: {dp:f} "
                        f"chamf mean loss: {ch:f}")
        self.logger.metrics(self.global_step, epoch=epoch, train_loss=mean_loss,
                            dpdist_loss=dp, chamfer_loss=ch)
        if snapshot_every and epoch % snapshot_every == 0:
            from dpdist_tpu_torch.eval.viz import save_cloud_pair

            x1 = split_same_surface(bd)[0][:1]
            save_cloud_pair(os.path.join(self.run_dir, f"rec_epoch{epoch}.png"),
                            self.reconstruct(x1)[0], x1[0])
        return mean_loss

    def eval_epoch(self, dataset, epoch: int):
        """Held-out reconstruction quality: the DPDist and squared chamfer
        means over the split's batches (ragged ones count)."""
        scores = []
        dataset.reset()
        while dataset.has_next_batch():
            bd, _ = dataset.next_batch(augment=False)
            if bd.shape[0] > 0:
                scores.append(torch.stack(self.monitor(*self._pair(bd))))
        if scores:
            dp_m, ch_m = (float(v) for v in
                          np.mean(torch.stack(scores).cpu().numpy(), axis=0, dtype=np.float64))
        else:
            dp_m = ch_m = float("nan")
        self.logger.log(f"eval DPDist {dp_m:f} chamfer {ch_m:f}")
        self.logger.metrics(self.global_step, epoch=epoch, eval_dpdist=dp_m, eval_chamfer=ch_m)
        return dp_m, ch_m

    def fit(self, train_dataset, test_dataset=None, *, max_epoch: int, eval_every: int = 10,
            snapshot_every: int = 0, start_epoch: int = 0, archive_to=None):
        """Epoch loop keeping aue_ckpt_best on the held-out loss of the
        TRAINED objective (dpdist for "ours", chamfer for "chamfer"): a
        300-epoch "ours" run of the reference diverged after ~epoch 250.

        start_epoch > 0 resumes with coherent epoch numbering (the budget
        stays max_epoch). archive_to: copy the best checkpoint there on
        every improvement; the archive's eval_score is the bar to beat when
        it was trained with the same opt_type. Returns the best checkpoint's
        path, else the final one's."""
        best, best_path = float("inf"), None
        if archive_to is not None:
            prev = archived_metric(archive_to, "eval_score")
            if prev is not None and archived_meta(archive_to, "opt_type") == self.opt_type:
                best = prev
                self.logger.log(f"archive {archive_to}: eval_score {prev:f} is the bar to beat")
        for epoch in range(start_epoch, max_epoch):
            self.train_epoch(train_dataset, epoch, snapshot_every=snapshot_every)
            if test_dataset is not None and epoch % eval_every == 0:
                dp, ch = self.eval_epoch(test_dataset, epoch)
                score = dp if self.opt_type == "ours" else ch
                if np.isfinite(score) and score < best:
                    best = score
                    best_path = self.save(tag="best")
                    if archive_to is not None and self.mesh.writes:
                        archive_checkpoint(best_path, archive_to, metric=score,
                                           metric_name="eval_score",
                                           extra={"opt_type": self.opt_type})
                        self.logger.log(f"archived -> {archive_to} (eval_score {score:f})")
            if epoch % 10 == 0:
                self.save(tag=self.global_step)
        final = self.save(tag=self.global_step)
        return best_path or final

    def save(self, tag):
        """Write aue_ckpt_<tag>; on a mesh rank 0 writes and every process
        waits for it."""
        path = os.path.join(self.run_dir, f"aue_ckpt_{tag}")
        if self.mesh.writes:
            save_checkpoint(path, {"params": self.params, "state": self.state},
                            step=self.global_step,
                            metadata={"aue_config": self.acfg.to_json(),
                                      "opt_type": self.opt_type})
        self.mesh.barrier()
        self.logger.log(f"checkpoint saved: {path}")
        return path

    def restore(self, path):
        """Load an AUE checkpoint of either package (params and BN state);
        the optimizer state is kept, as the reference keeps it."""
        tree, step, _ = restore_checkpoint(path, {"params": self.params, "state": self.state})
        self.params = params_to_device(tree["params"], self.device, requires_grad=True)
        self.state = params_to_device(tree["state"], self.device)
        if step:
            self.global_step = step
