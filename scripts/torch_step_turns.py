#!/usr/bin/env python3
"""Times the PyTorch port's gradient steps of the checkout under --root on
one NVIDIA GPU and prints one JSON line, with the card's name and power
limit: the frozen loss's source-gradient step (the committed net
results/dpdist_multi_r4_ckpt_best, B = 256 pairs, np = 64 and 256, float32
and bfloat16) and the DPDist train step with Adam (the default config,
B = 256 in float32, B = 16 and 256 in bfloat16). Per step: `ms`, the
CUDA-event median of single calls (host enqueue included), and `loop_ms`,
the wall time of LOOP calls issued back to back, per call, which also
shows where the host waits for the card. A step the checkout does not
run (it raises NotImplementedError) reads null.

    python3 scripts/torch_step_turns.py --root .
    python3 scripts/torch_step_turns.py --root path/to/other/checkout

To compare checkouts, run them in turns (A, B, B, A) in one session on one
card: two sessions may land on cards that differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

NET = "results/dpdist_multi_r4_ckpt_best"
B, B_SMALL, NP, NL = 256, 16, 64, 256
RUNS, LOOP, WARMUP = 30, 20, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose dpdist_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
    from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
    from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    rng = np.random.default_rng(0)

    def clouds(n, batch=B):
        return tuple(torch.as_tensor(rng.uniform(-0.8, 0.8, (batch, n, 3)).astype(np.float32),
                                     device=dev) for _ in range(2))

    def timed(fn):
        try:
            for _ in range(WARMUP):
                fn()
        except NotImplementedError:
            return None
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        for _ in range(LOOP):
            fn()
        torch.cuda.synchronize()
        return {"ms": statistics.median(times), "loop_ms": (time.perf_counter() - t0) * 1e3 / LOOP}

    def src_grad(loss_fn, a, b):
        a = a.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(a, b), a)
        return g

    cfg, np_params, _ = load_dpdist_checkpoint(f"{args.root}/{NET}")
    params = params_from_jax(np_params, dev)
    out = {"root": args.root, "card": card, "steps": {}}
    for n in (NP, NL):
        a, b = clouds(n)
        for dtype in ("float32", "bfloat16"):
            try:
                loss_fn = make_frozen_dpdist_loss(params, cfg.replace(dtype=dtype))
            except NotImplementedError:
                loss_fn = None
            out["steps"][f"src_grad_{dtype}_B{B}_np{n}"] = (
                None if loss_fn is None else timed(lambda: src_grad(loss_fn, a, b)))
    for dtype, batch in (("float32", B), ("bfloat16", B_SMALL), ("bfloat16", B)):
        key = f"train_{dtype}_B{batch}"
        a, b = clouds(NP, batch)
        labels = torch.as_tensor(rng.uniform(0.0, 0.3, (batch, NP)).astype(np.float32),
                                 device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            try:
                trainer = DPDistTrainer(DPDistConfig(dtype=dtype),
                                        TrainConfig(batch_size=batch, augment=False),
                                        run_dir=tmp, device=dev,
                                        logger=RunLogger(tmp, echo=False))
            except NotImplementedError:
                out["steps"][key] = None
                continue

            def step():
                _, grads = trainer.loss_and_grads(a, b, labels)
                trainer.opt_state = trainer.optimizer.step(trainer.params, grads,
                                                           trainer.opt_state)

            out["steps"][key] = timed(step)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
