"""Iterative PCRNet training (port of PCRNetTrainer,
dpdist_tpu/train/pcrnet_trainer.py), on one device or data-parallel over a
mesh.

    trainer = PCRNetTrainer(PCRNetConfig(num_point=64), TrainConfig(),
                            loss_type="dpdist", dpdist=load_dpdist_checkpoint(ckpt))
    trainer.fit(RegistrationDataset(...), epochs=..., eval_dataset=...)

Loss types (the reference's experiment matrix):
  "dpdist"  : the frozen DPDist loss(transformed source, template)
              (losses/dpdist_loss.py; on the card its forward runs the
              table-gather kernel twice and its backward the adjoint once)
  "chamfer" : chamfer(template, transformed source)
  "emd"     : Sinkhorn EMD(template, transformed source)

A step refines the batch for max_loops iterations on the device. In the
default mode only the last iteration carries gradient. With
train_single every iteration's transformed source is supervised and the
gradient runs through the whole refinement: the reference maps the loss
over the trajectory with jax.vmap, one batched program; the port puts the
max_loops iterations through ONE loss call on (max_loops * B, N, 3) with
the template repeated, the same mean in exact arithmetic (each loss is a
mean over its batch), and one kernel launch per call where the reference
has one batched grid.

action_reg (train_single only) adds the L1 magnitude of the late half of
the rollout's poses; fp_reg adds that of an fp_steps rollout started from
the source with its ground-truth pose undone. Their norms follow torch at
exactly zero (gradient 0, where JAX's is NaN); anywhere else the two agree.

The 3dmfv encoder's BN state rides along as the reference's does: the
step's refinement runs in training mode with the state, so BN normalises
with batch statistics and the state's EMA advances on every iteration
(the step keeps the last); the fp_reg rollout uses the state and drops
its update; the chamfer monitor and the evaluation run on the running
statistics. The pointnet encoders' state is {}.

The optimizer, the metrics (loss, and the gradient's global norm before
clipping) and the checkpoint format ({"params", "state"} with
pcrnet_config and loss_type in the metadata) are the reference's, so
either package restores the other's checkpoints. Dropout is never applied,
as in the reference, whose trainer passes no dropout key.

Every step runs through parallel.build_sharded_train_step, which makes
no collective on one device. Data parallelism (mesh with a 'data' axis of
n > 1 processes): every process samples the same global batch and steps
on its rows of template, source and (under fp_reg) pose6, the gradients,
the loss and the BN state averaged over the axis before clipping and the
update; rank 0 alone writes checkpoints and logs (train/trainer.py).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
from dpdist_tpu_torch.geometry.rotations import normalize_quat
from dpdist_tpu_torch.geometry.se3 import apply_transform, invert_transform, pose6_to_matrix
from dpdist_tpu_torch.losses.dpdist_loss import make_frozen_dpdist_loss
from dpdist_tpu_torch.models.pcrnet import init_pcrnet, init_pcrnet_state, pcrnet_refine
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.ops.chamfer import chamfer_distance
from dpdist_tpu_torch.ops.emd import earth_mover_distance
from dpdist_tpu_torch.parallel import build_sharded_train_step, local_mesh, replicate, shard_batch
from dpdist_tpu_torch.train.checkpoint import (
    archive_checkpoint,
    archived_meta,
    archived_metric,
    restore_params_maybe_state,
    save_checkpoint,
    tree_flatten_with_paths,
)
from dpdist_tpu_torch.train.logging import NullLogger, RunLogger
from dpdist_tpu_torch.train.optim import make_optimizer

LOSS_TYPES = ("dpdist", "chamfer", "emd")


def _action_magnitude(poses):
    """mean(|t| + |vec(normalize(q))|) over poses (..., 7): translation
    plus sin(angle / 2), the rotation's distance from the identity."""
    t_mag = torch.linalg.vector_norm(poses[..., :3], dim=-1)
    r_mag = torch.linalg.vector_norm(normalize_quat(poses[..., 3:7])[..., 1:], dim=-1)
    return torch.mean(t_mag + r_mag)


class PCRNetTrainer:
    def __init__(self, pcfg: PCRNetConfig, tcfg: TrainConfig, *, loss_type: str = "chamfer",
                 dpdist: Optional[tuple] = None, train_single: bool = False,
                 action_reg: float = 0.0, fp_reg: float = 0.0, fp_steps: int = 4,
                 run_dir: str = "runs/pcrnet", mesh=None, logger: Optional[RunLogger] = None,
                 device="cuda"):
        """dpdist: (cfg, params, state) of the frozen net (state None for a
        net without BN), as load_dpdist_checkpoint returns it (numpy
        leaves) or with the port's tensors. The policy starts from init_pcrnet with a generator seeded
        with tcfg.seed; restore() loads a checkpoint over it. mesh: a
        parallel.Mesh (None: one device)."""
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type must be one of {LOSS_TYPES}, got {loss_type!r}")
        if loss_type == "dpdist" and dpdist is None:
            raise ValueError("loss_type='dpdist' needs dpdist=(cfg, params, state)")
        if action_reg and not train_single:
            raise ValueError("action_reg needs --train_single (it penalizes per-iteration "
                             "poses, which only the full-BPTT trajectory exposes to the loss)")
        self.device = resolve_device(device)
        self.pcfg = pcfg
        self.tcfg = tcfg
        self.loss_type = loss_type
        self.train_single = train_single
        self.action_reg = action_reg
        self.fp_reg = fp_reg
        self.fp_steps = fp_steps
        self.run_dir = run_dir
        self.mesh = mesh if mesh is not None else local_mesh(self.device)
        self.logger = logger or (RunLogger(run_dir, config_json=pcfg.to_json(),
                                           name=f"train_pcrnet_{loss_type}")
                                 if self.mesh.writes else NullLogger())
        self.params = params_to_device(
            init_pcrnet(pcfg, torch.Generator().manual_seed(tcfg.seed), self.device),
            self.device, requires_grad=True)
        self.state = init_pcrnet_state(pcfg, self.device)
        replicate({"params": self.params, "state": self.state}, self.mesh)
        self.optimizer = make_optimizer(tcfg, base_lr=tcfg.learning_rate)
        init_opt, self._step = build_sharded_train_step(self.step_loss, self.optimizer, self.mesh)
        self.opt_state = init_opt(self.params)
        self.global_step = 0
        self._dp_loss = None
        if loss_type == "dpdist":
            dcfg, dparams, dstate = dpdist
            self._dp_loss = make_frozen_dpdist_loss(params_to_device(dparams, self.device), dcfg,
                                                    state=params_to_device(dstate, self.device))
        # The chamfer monitor's batch, frozen at the first train batch so the
        # logged curve is comparable across epochs.
        self._probe = None

    # ------------------------------------------------------------------

    def _single_loss(self, src, template):
        if self.loss_type == "dpdist":
            return self._dp_loss(src, template)
        if self.loss_type == "chamfer":
            return chamfer_distance(template, src, sqrt=True)
        return earth_mover_distance(template, src)

    def _fp_penalty(self, params, state, template, source, pose6):
        """The actions of an fp_steps rollout from the source with its
        ground-truth pose undone: at the true fixed point any action is
        drift."""
        aligned = apply_transform(source, invert_transform(pose6_to_matrix(pose6)))
        _, _, poses = pcrnet_refine(params, self.pcfg, aligned, template,
                                    iterations=self.fp_steps, stop_gradient_iters=False,
                                    state=state, train=True)
        return _action_magnitude(poses)

    def loss(self, params, template, source, pose6=None, state=None):
        """(the train loss of one batch, the new BN state); tensors on the
        device, `state` the BN state before the step."""
        if self.fp_reg and pose6 is None:
            raise ValueError("fp_reg training needs the gt pose6 batch")
        cfg = self.pcfg
        if self.train_single:
            _, _, poses, traj, new_state = pcrnet_refine(
                params, cfg, source, template, iterations=cfg.max_loops,
                stop_gradient_iters=False, return_trajectory=True, state=state, train=True,
                return_state=True)
            # (L, B, N, 3) -> (L * B, N, 3), case l * B + b against template b.
            loss = self._single_loss(traj.flatten(0, 1), template.repeat(cfg.max_loops, 1, 1))
            if self.action_reg:
                loss = loss + self.action_reg * _action_magnitude(poses[cfg.max_loops // 2:])
        else:
            src_out, _, _, new_state = pcrnet_refine(
                params, cfg, source, template, iterations=cfg.max_loops,
                stop_gradient_iters=True, state=state, train=True, return_state=True)
            loss = self._single_loss(src_out, template)
        if self.fp_reg:
            loss = loss + self.fp_reg * self._fp_penalty(params, state, template, source, pose6)
        return loss, new_state

    def step_loss(self, params, state, batch):
        """(the train loss, the new BN state) of batch = (template, source,
        pose6)."""
        return self.loss(params, *batch, state=state)

    def _batch(self, *arrays):
        """numpy arrays or tensors as float32 tensors on the device."""
        return tuple(None if a is None else
                     a.to(self.device, torch.float32) if isinstance(a, torch.Tensor) else
                     torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                     for a in arrays)

    def loss_grads_state(self, template, source, pose6=None):
        """The train loss, its gradients in the parameters (in the order of
        tree_flatten_with_paths(self.params)) and the new BN state."""
        leaves = [t for _, t in tree_flatten_with_paths(self.params)]
        with torch.enable_grad():
            loss, new_state = self.loss(self.params, template, source, pose6, self.state)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads, new_state

    def loss_and_grads(self, template, source, pose6=None):
        """The train loss and its gradients; the state is left as it is."""
        return self.loss_grads_state(template, source, pose6)[:2]

    def train_step(self, template, source, pose6=None):
        """One optimizer step on a numpy (or tensor) batch; returns {"loss",
        "grad_norm"} as 0-d device tensors, the norm before clipping."""
        template, source, pose6 = self._batch(template, source,
                                              pose6 if self.fp_reg else None)
        self.params, self.state, self.opt_state, metrics = self._step(
            self.params, self.state, self.opt_state,
            shard_batch((template, source, pose6), self.mesh))
        self.global_step += 1
        return metrics

    @torch.no_grad()
    def monitor(self, template, source):
        """Chamfer of the template and the source refined for max_loops
        iterations, the train loop's comparison metric."""
        src_out, _, _ = pcrnet_refine(self.params, self.pcfg, source, template,
                                      iterations=self.pcfg.max_loops, state=self.state)
        return chamfer_distance(template, src_out, sqrt=True)

    def train_epoch(self, dataset, epoch: int, *, batches_per_epoch: int = 32,
                    random_points_prob: float = 0.0, noise_prob: float = 0.0,
                    occlusion_fraction: float = 0.0):
        """batches_per_epoch steps on fresh batches; losses and gradient
        norms stay on the device until the epoch's end."""
        metrics = []
        for _ in range(batches_per_epoch):
            template, source, pose6 = dataset.sample_batch(
                self.tcfg.batch_size, random_points_prob=random_points_prob,
                noise_prob=noise_prob, occlusion_fraction=occlusion_fraction)
            if self._probe is None:
                self._probe = self._batch(template, source)
            m = self.train_step(template, source, pose6=pose6)
            metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
        losses, gnorms = torch.stack(metrics).cpu().numpy().T
        mean_loss = float(np.mean(losses))
        ch = float(self.monitor(*self._probe))
        self.logger.log(f" ---- epoch: {epoch + 1:03d} ---- mean loss: {mean_loss:f} "
                        f"(chamfer {ch:f})")
        self.logger.metrics(self.global_step, epoch=epoch, train_loss=mean_loss, chamfer=ch,
                            grad_norm_mean=float(np.mean(gnorms)),
                            grad_norm_max=float(np.max(gnorms)))
        return mean_loss

    def evaluate(self, dataset, *, num_cases: int = 64, iterations: Optional[int] = None,
                 report_dir: Optional[str] = None):
        """In-training evaluation through the standard protocol."""
        from dpdist_tpu_torch.eval.registration import evaluate_registration

        rep = evaluate_registration(self.params, self.pcfg, dataset, num_cases=num_cases,
                                    iterations=iterations or self.pcfg.eval_iterations,
                                    report_dir=report_dir, state=self.state,
                                    device=self.device)
        self.logger.log(f"eval: rot {rep['rot_err_mean_deg']:.2f} deg, trans "
                        f"{rep['trans_err_mean']:.4f}, acc@(5,0.05) "
                        f"{rep['acc_rot5.0_trans0.05']:.3f}")
        self.logger.metrics(self.global_step, eval_rot_err=rep["rot_err_mean_deg"],
                            eval_trans_err=rep["trans_err_mean"])
        return rep

    def fit(self, train_dataset, *, epochs: int, batches_per_epoch: int = 32,
            eval_dataset=None, eval_every: int = 10, eval_cases: int = 64,
            select_family: Optional[str] = None, archive_to: Optional[str] = None,
            **epoch_kw):
        """Train, keeping pcrnet_ckpt_best on the lowest validation rotation
        error (at 2 * max_loops iterations) every eval_every epochs.

        select_family: select on that family's slice of the report, never
        on the pooled error, which rotationally symmetric families dilute.
        archive_to: copy the best checkpoint there on every improvement; the
        archive's recorded select_err is the bar to beat when it was
        selected on the same family. Returns the best checkpoint's path, or
        the final one's without an eval_dataset."""
        best_err = float("inf")
        best_path = None
        if archive_to is not None:
            prev = archived_metric(archive_to, "select_err")
            prev_fam = archived_meta(archive_to, "select_family")
            if prev is not None and prev_fam == (select_family or ""):
                best_err = prev
                self.logger.log(f"archive {archive_to}: select_err {prev:f} is the bar to beat")
        for epoch in range(epochs):
            self.train_epoch(train_dataset, epoch, batches_per_epoch=batches_per_epoch,
                             **epoch_kw)
            if eval_dataset is not None and (epoch + 1) % eval_every == 0:
                rep = self.evaluate(eval_dataset, num_cases=eval_cases,
                                    iterations=self.pcfg.max_loops * 2)
                err = rep["rot_err_mean_deg"]
                if select_family:
                    fam = rep.get("per_family", {}).get(select_family)
                    if fam is None:
                        self.logger.log(f"eval report lacks family {select_family!r}; "
                                        "skipping best-ckpt comparison this epoch")
                        continue
                    err = fam["rot_err_mean_deg"]
                if err < best_err:
                    best_err = err
                    best_path = self.save(tag="best")
                    if archive_to is not None and self.mesh.writes:
                        archive_checkpoint(best_path, archive_to, metric=err,
                                           metric_name="select_err",
                                           extra={"select_family": select_family or ""})
                        self.logger.log(f"archived -> {archive_to} (select_err {err:f})")
        final = self.save(tag="final")
        return best_path or final

    def save(self, tag):
        """Write pcrnet_ckpt_<tag>; on a mesh rank 0 writes and every
        process waits for it."""
        path = os.path.join(self.run_dir, f"pcrnet_ckpt_{tag}")
        if self.mesh.writes:
            save_checkpoint(path, {"params": self.params, "state": self.state},
                            step=self.global_step,
                            metadata={"pcrnet_config": self.pcfg.to_json(),
                                      "loss_type": self.loss_type})
        self.mesh.barrier()
        self.logger.log(f"checkpoint saved: {path}")
        return path

    def restore(self, path):
        """Load a PCRNet checkpoint of either package over the params and
        the BN state (a checkpoint without a state keeps the current one);
        the optimizer state is kept, as the reference keeps it."""
        params, state, step = restore_params_maybe_state(path, self.params, self.state)
        self.params = params_to_device(params, self.device, requires_grad=True)
        if state is not None:
            self.state = params_to_device(state, self.device)
        if step:
            self.global_step = step
