#!/usr/bin/env python3
"""Times rows 6 and 3 of the PyTorch port (the patch-only gather
`table_gather` and its adjoint `table_gather_bwd`) of the checkout under
--root on one NVIDIA GPU, and prints one JSON line with the card's name
and power limit: each kernel's device time a launch (torch.profiler, the
mean over PROFILED calls) and its CUDA-event median over RUNS calls, at
B = 256 clouds, N = 256 queries, the committed grid (8^3 cells, k = 5,
C = 20), on inputs drawn from a fixed seed (queries uniform in
[-1.2, 1.2]^3, a contiguous grad as row 6's backward hands row 3).

    python3 scripts/torch_kernel_turns.py --root .
    python3 scripts/torch_kernel_turns.py --root path/to/other/checkout

To compare checkouts, run them in turns (A, B, B, A) in one session on one
card: two sessions may land on cards that differ.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

B, N, GRID, K, C = 256, 256, 8, 5, 20
RUNS, PROFILED, WARMUP = 50, 20, 5


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose dpdist_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_bwd
    from dpdist_tpu_torch.ops import voxel_assign

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    rng = np.random.default_rng(0)
    fv = torch.as_tensor(rng.normal(size=(B, GRID ** 3, C)).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32), device=dev)
    vox = voxel_assign(q, GRID)[0]
    grad = torch.as_tensor(rng.normal(size=(B, N, K ** 3 * C)).astype(np.float32), device=dev)

    def event_ms(fn):
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(fn, name):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in kept)
        return sum(e.self_device_time_total for e in kept) / n / 1e3 if n else None

    rows = {"table_gather": (lambda: table_gather(fv, vox, GRID, K), "table_gather_kernel<float"),
            "table_gather_bwd": (lambda: table_gather_bwd(vox, grad, GRID, K),
                                 "table_gather_bwd_kernel<float")}
    out = {"root": args.root, "card": card}
    for name, (fn, kernel) in rows.items():
        out[name] = {"ms": event_ms(fn), "device_ms": device_ms(fn, kernel)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
