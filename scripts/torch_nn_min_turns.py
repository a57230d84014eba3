#!/usr/bin/env python3
"""Times the PyTorch port's NN-min kernel (nn_min_sqdist, PERF.md row 8)
of the checkout under --root on one NVIDIA GPU, at eval_pair's shape and
three others, and prints one JSON line: per shape the CUDA-event median of
single calls (host enqueue included) and torch.profiler's device time per
call of the CUDA kernels (memsets apart), with the card's name and power
limit.

    python3 scripts/torch_nn_min_turns.py --root .
    python3 scripts/torch_nn_min_turns.py --root path/to/other/checkout

To compare two checkouts, run them in turns (A, B, B, A) in one session on
one card: two sessions may land on cards that differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SHAPES = ((1, 10000, 10000), (2, 1000, 4099), (256, 64, 64), (1, 50000, 10000))
RUNS, CALLS = 50, 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose dpdist_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    rng = np.random.default_rng(0)
    out = {"root": args.root, "card": card, "shapes": []}
    with torch.no_grad():
        for B, N, M in SHAPES:
            a, p = (torch.as_tensor(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32), device=dev)
                    for n in (N, M))
            for _ in range(5):
                nn_min_sqdist(a, p)
            torch.cuda.synchronize()
            times = []
            for _ in range(RUNS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                nn_min_sqdist(a, p)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(CALLS):
                    nn_min_sqdist(a, p)
                torch.cuda.synchronize()
            kernels = {e.key: e.self_device_time_total / CALLS / 1e3 for e in prof.key_averages()
                       if e.self_device_time_total > 0 and not e.key.startswith("Memset")}
            memset = sum(e.self_device_time_total for e in prof.key_averages()
                         if e.key.startswith("Memset")) / CALLS / 1e3
            out["shapes"].append({"B": B, "N": N, "M": M, "event_ms": statistics.median(times),
                                  "device_ms": sum(kernels.values()), "memset_ms": memset,
                                  "kernels": sorted(kernels)})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
