#!/usr/bin/env python3
"""How far the port's registration evaluator parts from the JAX package's
over many iterations, both on the CPU.

    PYTHONPATH=. python scripts/torch_registration_spread.py [--cases 256] [--train]

Runs the production policy (results/policy_mf_tsn1200clip_dpdist_final)
under the production protocol's dataset (5 families, 125 templates,
sparse split, seed 777, the committed 5,070 poses, batches of 64) through
both evaluators' device programs on the same batches, at 8 and at 50
iterations, without a stop and with the period0 stop (threshold 1e-3,
period 2), and prints per case the largest rotation and translation
difference of the final errors, how many cases part by more than 0.01,
0.1, 1 and 10 degrees, how many cases change an accuracy bucket, and at
which iteration the first case parts by more than 0.01 degrees. A single
step agrees to float32 rounding; a case near a decision (a ~180 degree
flip cycle, a stop that fires one period earlier) can amplify that over
50 iterations.

--train: the production recipe's first step (B = 16, 8 loops, resumed
from the policy, the dpdist loss on results/dpdist_multi_r4_ckpt_best, or
chamfer) in both packages: the loss, and per parameter leaf the relative
norm of the gradient difference (JAX's gradient read from a momentum-SGD
step at learning rate 1); and how much the port's own gradient moves when
the source moves by gaussian noise of 1e-6 (a few float32 ulps), the
problem's conditioning.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig  # noqa: E402
from dpdist_tpu.eval.registration import _eval_program as jax_program  # noqa: E402
from dpdist_tpu.models import init_pcrnet as jax_init  # noqa: E402
from dpdist_tpu.train.checkpoint import restore_params_maybe_state as jax_restore  # noqa: E402

from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint  # noqa: E402
from dpdist_tpu_torch.data.registration import (  # noqa: E402
    RegistrationDataset,
    default_eval_poses,
)
from dpdist_tpu_torch.eval.registration import ACCURACY_BUCKETS  # noqa: E402
from dpdist_tpu_torch.eval.registration import _eval_program as port_program  # noqa: E402
from dpdist_tpu_torch.nn.layers import params_to_device  # noqa: E402

POLICY = str(ROOT / "results" / "policy_mf_tsn1200clip_dpdist_final")
MF = dict(n_templates=125, families=("chair", "sphere", "box", "cylinder", "torus"),
          sparse=1, s_rand_points=1.0, centroid_sub=False, seed=777)
BATCH = 64
STOP = dict(stop_threshold=1e-3, stop_period=2, stop_select="period0")


def batches(n_cases, num_point):
    ds = RegistrationDataset(pose_file=default_eval_poses(), num_point=num_point, **MF)
    done = 0
    while done < n_cases:
        b = min(BATCH, n_cases - done)
        yield ds.sample_batch(b)
        done += b


def buckets(re, te):
    return np.stack([(re < r) & (te < t) for r, t in ACCURACY_BUCKETS], -1)


def train_spread():
    """The --train measurement (see the module docstring)."""
    import tempfile

    from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
    from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
    from dpdist_tpu.parallel import make_mesh
    from dpdist_tpu.train.pcrnet_trainer import PCRNetTrainer as JaxTrainer

    from dpdist_tpu_torch.configs import TrainConfig
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, tree_flatten_with_paths
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    net = str(ROOT / "results" / "dpdist_multi_r4_ckpt_best")
    with open(POLICY + ".json") as f:
        jcfg = JaxPCRNetConfig.from_json(json.load(f)["metadata"]["pcrnet_config"])
    cfg = load_pcrnet_checkpoint(POLICY)[0]
    ds = RegistrationDataset(num_point=cfg.num_point, **{**MF, "seed": 0})
    template, source, pose6 = ds.sample_batch(16, random_points_prob=1.0, noise_prob=1.0)
    noisy = source + np.random.default_rng(0).normal(0, 1e-6, source.shape).astype(np.float32)
    tc = dict(batch_size=16, grad_clip=0.0, optimizer="momentum", learning_rate=1.0)
    out = {}
    for loss_type, single in (("chamfer", True), ("dpdist", False), ("dpdist", True)):
        d = tempfile.mkdtemp()
        jtr = JaxTrainer(jcfg, JaxTrainConfig(**tc), loss_type=loss_type, train_single=single,
                         dpdist=jax_load_dpdist(net) if loss_type == "dpdist" else None,
                         run_dir=d, mesh=make_mesh(data=1))
        ttr = PCRNetTrainer(cfg, TrainConfig(**tc), loss_type=loss_type, train_single=single,
                            dpdist=load_dpdist_checkpoint(net) if loss_type == "dpdist" else None,
                            run_dir=d, device="cpu", logger=RunLogger(d, echo=False))
        jtr.restore(POLICY)
        ttr.restore(POLICY)
        loss, grads = ttr.loss_and_grads(torch.tensor(template), torch.tensor(source))
        _, moved = ttr.loss_and_grads(torch.tensor(template), torch.tensor(noisy))
        before = dict(tree_flatten_with_paths(jax.device_get(jtr.params)))
        jm = jtr.train_step(template, source)
        after = dict(tree_flatten_with_paths(jax.device_get(jtr.params)))
        leaf_rel = {}
        for (path, _), g in zip(tree_flatten_with_paths(ttr.params), grads):
            want = np.asarray(before[path]) - np.asarray(after[path])
            leaf_rel[path] = float(np.linalg.norm(g.numpy() - want) / np.linalg.norm(want))

        def norm(gs):
            return float(torch.sqrt(sum(torch.sum(x * x) for x in gs)))

        key = f"{loss_type}, {'full BPTT' if single else 'last iteration'}"
        out[key] = {"loss_port": float(loss), "loss_jax": float(jm["loss"]),
                    "grad_norm_port": norm(grads), "grad_norm_jax": float(jm["grad_norm"]),
                    "worst_leaf_rel_diff": max(leaf_rel.values()),
                    "port_grad_rel_change_from_1e-6_noise":
                        norm([a - b for a, b in zip(grads, moved)]) / norm(grads)}
        print(key, json.dumps(out[key]), flush=True)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cases", type=int, default=256)
    p.add_argument("--train", action="store_true")
    a = p.parse_args()
    if a.train:
        print(json.dumps({"train_step": train_spread()}))
        return

    with open(POLICY + ".json") as f:
        jcfg = JaxPCRNetConfig.from_json(json.load(f)["metadata"]["pcrnet_config"])
    tp, ts = jax_init(jax.random.PRNGKey(0), jcfg)
    jparams, jstate, _ = jax_restore(POLICY, tp, ts)
    cfg, params = load_pcrnet_checkpoint(POLICY)
    params = params_to_device(params, "cpu")
    program = jax.jit(jax_program, static_argnames=("cfg", "iterations", "stop_threshold",
                                                    "stop_period", "stop_select"))
    out = {}
    for iterations in (8, 50):
        for stop_name, stop in (("no stop", {}), ("period0", STOP)):
            curves = {"jax": [], "port": []}
            for template, source, gt in batches(a.cases, cfg.num_point):
                _, te, re, *_ = program(jparams, jstate, jcfg, jnp.asarray(template),
                                        jnp.asarray(source), jnp.asarray(gt),
                                        iterations=iterations, **stop)
                curves["jax"].append((np.asarray(re), np.asarray(te)))
                _, te, re, *_ = port_program(params, cfg,
                                             *(torch.as_tensor(x) for x in
                                               (template, source, gt)),
                                             iterations, **stop)
                curves["port"].append((re.numpy(), te.numpy()))
            (jre, jte), (pre, pte) = (
                tuple(np.concatenate([c[k] for c in curves[side]], axis=1) for k in (0, 1))
                for side in ("jax", "port"))
            d_rot = np.abs(pre[-1] - jre[-1])
            d_trans = np.abs(pte[-1] - jte[-1])
            parted = np.abs(pre - jre) > 0.01
            first = int(np.argmax(parted.any(axis=1))) if parted.any() else None
            flips = int((buckets(pre[-1], pte[-1]) != buckets(jre[-1], jte[-1])).any(-1).sum())
            key = f"{iterations} iterations, {stop_name}"
            out[key] = {
                "max_d_rot_deg": float(d_rot.max()), "max_d_trans": float(d_trans.max()),
                **{f"cases_d_rot_above_{t}": int((d_rot > t).sum()) for t in
                   (0.01, 0.1, 1.0, 10.0)},
                "cases_changing_a_bucket": flips,
                "first_iteration_a_case_parts_by_0.01_deg": first,
            }
            print(key, json.dumps(out[key]), flush=True)
    print(json.dumps({"cases": a.cases, "spread": out}))


if __name__ == "__main__":
    main()
