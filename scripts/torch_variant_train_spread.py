#!/usr/bin/env python3
"""How far the DPDist variants' golden train steps part from JAX's, against
how far they part on their own and how far a known fault moves them.

    python scripts/torch_variant_train_spread.py [--device cuda] [--seeds 8] [--noise 1e-6]
        [--dtype float32|float16]

For each variant that dpdist_tpu_torch/assets/golden_variants.json trains
(the BN decoder, conv_version=3 and the pointnet encoder; full width, B =
16, Adam at lr 1e-4, 3 steps from the seeded weights on the golden batch;
in float32, or with --dtype float16 a float16 decoder on float32 master
weights against the golden file's float16 steps), on one device:
  - the port's steps against JAX's golden ones ("jax"), and the same run
    again against the first ("rerun": whether the device repeats itself);
  - the same steps with gaussian noise of --noise added to the batch's
    points, once per seed, against the port's own noiseless run ("own":
    the largest over the seeds), the problem's conditioning at this point;
    and the same with momentum SGD in place of Adam at the same learning
    rate ("own_momentum"): Adam's first steps move every weight by about
    lr * sign(g), also where g is rounding noise, and momentum SGD does
    not;
  - two known faults against JAX's: BN momentum 0.99 in place of 0.9
    ("momentum"), and the unbiased batch variance in place of the biased
    one ("unbiased_var").
Each reading gives the first step's loss (relative), the later steps'
losses (the largest relative), the first gradient norm (relative), and the
BN state after the first step and after the last, each the largest |d| of
a leaf's sampled entries over the larger of 1 and the leaf's largest entry
(chip_smoke.py's measures). Prints a line per reading and, last, one JSON
object with them all.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import dpdist_tpu_torch.nn.layers as layers  # noqa: E402
import dpdist_tpu_torch.train.trainer as trainer_module  # noqa: E402
from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig  # noqa: E402
from dpdist_tpu_torch.data.golden import (  # noqa: E402
    VARIANTS_GOLDEN_PATH,
    dpdist_train_batch,
    state_gap,
    state_sample,
)
from dpdist_tpu_torch.train.logging import RunLogger  # noqa: E402
from dpdist_tpu_torch.train.trainer import DPDistTrainer  # noqa: E402


def run_steps(cfg, golden, device, data, labels, n_state, optimizer="adam"):
    """The golden steps: losses, gradient norms, and the sampled BN state
    after the first step and after the last."""
    with tempfile.TemporaryDirectory() as tmp:
        tr = DPDistTrainer(cfg, TrainConfig(batch_size=golden["train"]["batch_size"],
                                            augment=False, seed=golden["seed"],
                                            optimizer=optimizer),
                           run_dir=tmp, device=device, logger=RunLogger(tmp, echo=False))
        losses, gnorms, first = [], [], None
        for _ in range(golden["train"]["steps"]):
            m = tr.train_step(data, labels)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            if first is None:
                first = state_sample(tr.state, n_state)
        return {"loss": losses, "grad_norm": gnorms, "state_first": first,
                "state": state_sample(tr.state, n_state)}


def gaps(got, want):
    return {"first_loss": abs(got["loss"][0] - want["loss"][0]) / want["loss"][0],
            "later_loss": max(abs(a - b) / b for a, b in zip(got["loss"][1:], want["loss"][1:])),
            "grad_norm": abs(got["grad_norm"][0] - want["grad_norm"][0]) / want["grad_norm"][0],
            "state_first": state_gap(got["state_first"], want["state_first"]),
            "state": state_gap(got["state"], want["state"])}


def unbiased_moments(x):
    mean, var = ORIGINAL_MOMENTS(x)
    n = x.numel() // x.shape[-1]
    return mean, var * (n / (n - 1))


ORIGINAL_MOMENTS = layers.batch_moments
ORIGINAL_FORWARD = trainer_module.forward_dpdist


def with_fault(name):
    """Install fault `name` (None: none) in the modules the trainer calls."""
    layers.batch_moments = unbiased_moments if name == "unbiased_var" else ORIGINAL_MOMENTS
    trainer_module.forward_dpdist = (functools.partial(ORIGINAL_FORWARD, bn_momentum=0.99)
                                     if name == "momentum" else ORIGINAL_FORWARD)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float16"))
    a = ap.parse_args(argv)
    golden = json.loads(VARIANTS_GOLDEN_PATH.read_text())
    device = torch.device(a.device)
    out = {}
    for name, want_all in golden["variants"].items():
        if "train" not in want_all:
            continue
        want = want_all["train" if a.dtype == "float32" else "train_fp16"]
        cfg = DPDistConfig.from_json(want_all["config"]).replace(dtype=a.dtype)
        n_state = len(next(iter(want["state"].values()), []))
        data, labels = dpdist_train_batch({"seed": want["batch_seed"],
                                           "batch_size": golden["train"]["batch_size"],
                                           "num_point": golden["train"]["num_point"]})
        run = functools.partial(run_steps, cfg, golden, device, labels=labels, n_state=n_state)
        with_fault(None)
        base = run(data=data)
        rows = {"jax": gaps(base, want), "rerun": gaps(run(data=data), base)}
        noisy = [data + np.random.default_rng(s).normal(0.0, a.noise, data.shape)
                 .astype(np.float32) for s in range(a.seeds)]
        for reading, optimizer in (("own", "adam"), ("own_momentum", "momentum")):
            ref = base if optimizer == "adam" else run(data=data, optimizer=optimizer)
            own = [gaps(run(data=d, optimizer=optimizer), ref) for d in noisy]
            rows[reading] = {k: max(g[k] for g in own) for k in own[0]}
        for fault in ("momentum", "unbiased_var"):
            with_fault(fault)
            rows[fault] = gaps(run(data=data), want)
        with_fault(None)
        out[name] = rows
        for reading, g in rows.items():
            print(f"{name} {reading}: " + ", ".join(f"{k} {v:.3e}" for k, v in g.items()),
                  flush=True)
    print(json.dumps({"device": str(device), "dtype": a.dtype, "noise": a.noise, "seeds": a.seeds,
                      "variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
