"""DPDist training (port of DPDistTrainer, dpdist_tpu/train/trainer.py), on
one device or data-parallel over a mesh.

    trainer = DPDistTrainer(DPDistConfig(), TrainConfig(), run_dir="runs/dpdist")
    trainer.fit(train_dataset, test_dataset)

A dataset is any object with reset(), has_next_batch() and
next_batch(augment=) -> (batch_data (B, 6N, 3), batch_labels (B, 4N)), the
reference's iterator protocol; assemble_dpdist_batch turns a batch into
(pcA, pcB, labels_AB).

The train step is the l1 loss on pred_AB against the labels, its gradient
in the parameters (the decoder's, and the pointnet encoder's), and one
optimizer update (make_optimizer: Adam with the staircase LR and its floor
by default). Without BN it runs the AB direction alone
(models.apply_direction, train=True): the loss reads nothing else, and
eager PyTorch would not drop the other direction the way XLA does. With BN
it runs both (models.forward_dpdist, train=True), since the decoder's
batch statistics cover the 2B rows [xAB; xBA], and keeps the new state
(the EMA of the batch statistics at decay 0.9, the reference's default;
the pointnet encoder's from its second run, pcB's). It resolves
fused_gather for a gradient context (the table-gather kernel on the card);
the 3DmFV encoder has no parameters, so the step never needs the adjoint
kernel. With dtype="bfloat16" the master parameters stay float32 and the
decoder runs in bfloat16 (the reference's bf16 train step,
bench.py:173-190): the gather writes a bf16 decoder input, forward only,
and the gradients return to float32 through the decoder's casts.
Evaluation keeps the configured dispatch, forward only, in eval mode.

Encoder occlusion (train_cfg.encoder_occlusion and _prob) corrupts the
encoder's copy of pcA only, through the noise channel, with the
reference's draws in its order (dpdist_tpu/train/trainer.py:83-106): one
uniform per item, then data.registration.add_occlusions_np on the
selected items, then the gaussian noise of add_noise.

Data parallelism: with a mesh whose 'data' axis holds n > 1 processes
(parallel.make_mesh; batch_size must divide by n) every process builds the
same global batch, its draws included, and a step runs on the process's
rows: the gradients, the loss and the new BN state averaged over the axis,
BN normalising with local batch statistics as the reference's shard_map
does. The params start from rank 0's (one broadcast). Rank 0 alone writes
checkpoints and logs, and every process waits for a checkpoint's writing
before going on. mesh=None is the single-device path, with no collective.
Either way the step is the one parallel.build_sharded_train_step builds.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data.batching import assemble_dpdist_batch
from dpdist_tpu_torch.data.registration import add_occlusions_np
from dpdist_tpu_torch.losses.standard import l1_sample_loss
from dpdist_tpu_torch.models.dpdist import (
    apply_direction,
    check_ported,
    forward_dpdist,
    init_dpdist,
    resolve_for_grad,
)
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.parallel import build_sharded_train_step, local_mesh, replicate, shard_batch
from dpdist_tpu_torch.train.checkpoint import (
    archive_checkpoint,
    archived_metric,
    latest_checkpoint,
    load_checkpoint,
    params_from_jax,
    params_to_numpy,
    save_checkpoint,
    tree_flatten_with_paths,
)
from dpdist_tpu_torch.train.logging import NullLogger, RunLogger
from dpdist_tpu_torch.train.optim import make_optimizer


class DPDistTrainer:
    def __init__(self, model_cfg: DPDistConfig, train_cfg: TrainConfig, *,
                 run_dir: str = "runs/dpdist", mesh=None, logger: Optional[RunLogger] = None,
                 device="cuda"):
        """Parameters and state start from init_dpdist with a generator
        seeded with train_cfg.seed; restore() loads a checkpoint over them.
        mesh: a parallel.Mesh (None: one device)."""
        check_ported(model_cfg)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else local_mesh(self.device)
        ndata = self.mesh.shape["data"]
        if train_cfg.batch_size % ndata:
            raise ValueError(f"batch_size {train_cfg.batch_size} not divisible by data axis "
                             f"{ndata}")
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.run_dir = run_dir
        self.logger = logger or (RunLogger(
            run_dir, config_json='{"model": %s, "train": %s}' % (model_cfg.to_json(),
                                                                 train_cfg.to_json()))
            if self.mesh.writes else NullLogger())
        params, self.state = init_dpdist(
            model_cfg, torch.Generator().manual_seed(train_cfg.seed), self.device)
        self._set_params(params)
        replicate({"params": self.params, "state": self.state}, self.mesh)
        self.optimizer = make_optimizer(train_cfg)
        init_opt, self._step = build_sharded_train_step(self.step_loss, self.optimizer, self.mesh)
        self.opt_state = init_opt(self.params)
        self.global_step = 0
        self._np_rng = np.random.default_rng(train_cfg.seed + 1)
        self._grad_cfg = resolve_for_grad(model_cfg, self.device)

    def _set_params(self, params):
        self.params = params_to_device(params, self.device, requires_grad=True)

    # ------------------------------------------------------------------

    def make_batch(self, batch_data, batch_labels):
        """(pcA, pcB, labels, noise) on the device from one dataset batch
        (the global batch on a mesh); noise is None unless train_cfg asks
        for encoder occlusion or add_noise > 0."""
        pcA, pcB, labels = assemble_dpdist_batch(batch_data, batch_labels)
        noise = None
        tc = self.tcfg
        if tc.encoder_occlusion > 0 and tc.encoder_occlusion_prob > 0:
            sel = self._np_rng.uniform(size=pcA.shape[0]) < tc.encoder_occlusion_prob
            occluded = pcA.copy()
            if sel.any():
                occluded[sel] = add_occlusions_np(pcA[sel], tc.encoder_occlusion, self._np_rng)
            noise = occluded - pcA   # zeros where nothing was selected
        if tc.add_noise > 0:
            gauss = (self._np_rng.standard_normal(pcA.shape) * tc.add_noise).astype(np.float32)
            noise = gauss if noise is None else noise + gauss
        if noise is not None:
            noise = noise.astype(np.float32)
        return tuple(None if a is None else torch.as_tensor(a, device=self.device)
                     for a in (pcA, pcB, labels, noise))

    def step_loss(self, params, state, batch):
        """(the train loss, the new BN state) of batch = (pcA, pcB, labels,
        noise)."""
        pcA, pcB, labels, noise = batch
        if self.mcfg.use_bn:
            pred_AB, _, new_state = forward_dpdist(params, state, self._grad_cfg, pcA, pcB,
                                                   noise=noise, train=True)
        else:
            pcA_enc = pcA if noise is None else pcA + noise
            pred_AB = apply_direction(params, self._grad_cfg, pcA_enc, pcB, state=state,
                                      train=True)
            new_state = state
        return l1_sample_loss(pred_AB, labels), new_state

    def loss_and_grads(self, pcA, pcB, labels, noise=None):
        """The train loss and its gradients in the parameters, in the
        order of tree_flatten_with_paths(self.params); with BN the new state
        replaces self.state."""
        leaves = [t for _, t in tree_flatten_with_paths(self.params)]
        with torch.enable_grad():
            loss, new_state = self.step_loss(self.params, self.state, (pcA, pcB, labels, noise))
            grads = torch.autograd.grad(loss, leaves)
        self.state = new_state
        return loss.detach(), grads

    def train_step(self, batch_data, batch_labels):
        """One optimizer step; returns {"loss", "grad_norm"} as 0-d device
        tensors (read them when the host needs them). On a mesh the loss
        and the norm are those of the averaged step."""
        batch = shard_batch(self.make_batch(batch_data, batch_labels), self.mesh)
        self.params, self.state, self.opt_state, metrics = self._step(
            self.params, self.state, self.opt_state, batch)
        self.global_step += 1
        return metrics

    def train_epoch(self, dataset, epoch: int, *, prefetch: bool = True):
        # Per-step losses stay on the device and are read once per epoch;
        # with prefetch, host batch assembly overlaps the device's steps.
        if prefetch:
            from dpdist_tpu_torch.data.prefetch import PrefetchingLoader

            batches = PrefetchingLoader(dataset, augment=self.tcfg.augment).epoch()
        else:
            def _iter():
                dataset.reset()
                while dataset.has_next_batch():
                    yield dataset.next_batch(augment=self.tcfg.augment)

            batches = _iter()
        device_losses = []
        for bd, bl in batches:
            if bd.shape[0] < self.tcfg.batch_size:
                continue   # tails are dropped, as the reference's fixed-size step does
            device_losses.append(self.train_step(bd, bl)["loss"])
        if not device_losses:
            raise ValueError(f"epoch {epoch} produced no full batches: check that "
                             f"batch_size ({self.tcfg.batch_size}) does not exceed the "
                             "split size")
        losses = torch.stack(device_losses).cpu().numpy()
        if not np.isfinite(losses).all():
            bad = int(np.argmin(np.isfinite(losses)))
            raise FloatingPointError(
                f"non-finite train loss at epoch {epoch}, batch {bad} "
                f"(step ~{self.global_step - len(losses) + bad}); losses around "
                f"failure: {losses[max(0, bad - 2): bad + 1].tolist()}")
        mean_loss = float(np.mean(losses))
        self.logger.log(f" ---- epoch: {epoch + 1:03d} ---- mean loss: {mean_loss:f}")
        self.logger.metrics(self.global_step, epoch=epoch, train_loss=mean_loss)
        return mean_loss

    @torch.no_grad()
    def eval_epoch(self, dataset, epoch: int):
        """L1 on the held-out split, no augmentation; ragged batches count."""
        losses = []
        dataset.reset()
        while dataset.has_next_batch():
            bd, bl = dataset.next_batch(augment=False)
            if bd.shape[0] == 0:
                continue
            pcA, pcB, labels = (torch.as_tensor(a, device=self.device)
                                for a in assemble_dpdist_batch(bd, bl))
            pred_AB = apply_direction(self.params, self.mcfg, pcA, pcB, state=self.state)
            losses.append(float(l1_sample_loss(pred_AB, labels)))
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        self.logger.log(f"eval mean loss: {mean_loss:f}")
        self.logger.metrics(self.global_step, epoch=epoch, eval_loss=mean_loss)
        return mean_loss

    # ------------------------------------------------------------------

    def fit(self, train_dataset, test_dataset=None, *, max_epoch=None,
            eval_every: int = 10, archive_to: Optional[str] = None):
        """Epoch loop with periodic eval; keeps ckpt_best on the lowest
        held-out loss.

        archive_to: optional base path to copy ckpt_best to on every
        improvement; the bar starts at the archive's recorded eval_l1, so a
        resumed run overwrites the archive only with a strictly better
        checkpoint."""
        max_epoch = max_epoch if max_epoch is not None else self.tcfg.max_epoch
        best = float("inf")
        if archive_to is not None:
            prev = archived_metric(archive_to, "eval_l1")
            if prev is not None:
                best = prev
                self.logger.log(f"archive {archive_to}: eval_l1 {prev:f} is the bar to beat")
        for epoch in range(max_epoch):
            self.train_epoch(train_dataset, epoch)
            if (epoch % eval_every == 0) and test_dataset is not None:
                ev = self.eval_epoch(test_dataset, epoch)
                if np.isfinite(ev) and ev < best:
                    best = ev
                    path = self.save(tag="best")
                    if archive_to is not None and self.mesh.writes:
                        archive_checkpoint(path, archive_to, metric=ev, metric_name="eval_l1")
                        self.logger.log(f"archived -> {archive_to} (eval_l1 {ev:f})")
            if epoch % self.tcfg.checkpoint_every_epochs == 0:
                self.save(tag=self.global_step)
        self.save(tag=self.global_step)
        return best

    def save(self, tag):
        """Write ckpt_<tag> in the reference's format ({"params", "state"};
        the state of a BN-off model is empty and has no leaves); on a mesh
        rank 0 writes and every process waits for it."""
        path = os.path.join(self.run_dir, f"ckpt_{tag}")
        if self.mesh.writes:
            save_checkpoint(path, {"params": params_to_numpy(self.params),
                                   "state": params_to_numpy(self.state)},
                            step=self.global_step,
                            metadata={"model_config": self.mcfg.to_json()})
        self.mesh.barrier()
        self.logger.log(f"checkpoint saved: {path}")
        return path

    def restore(self, path: Optional[str] = None):
        """Load ckpt params and state (default: the newest under run_dir);
        the optimizer state is kept, as the reference keeps it."""
        path = path or latest_checkpoint(self.run_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.run_dir}")
        tree, step, _ = load_checkpoint(path)
        tree = {"params": tree.get("params", {}), "state": tree.get("state", {})}
        want = [p for p, _ in tree_flatten_with_paths({"params": self.params,
                                                        "state": self.state})]
        got = [p for p, _ in tree_flatten_with_paths(tree)]
        if got != want:
            raise ValueError("checkpoint structure mismatch:\n saved: %s...\n template: %s..."
                             % (got[:5], want[:5]))
        self._set_params(params_from_jax(tree["params"], self.device))
        if tree_flatten_with_paths(self.state):
            self.state = params_from_jax(tree["state"], self.device)
        if step:
            self.global_step = step
        self.logger.log(f"restored checkpoint: {path} (step {step})")
