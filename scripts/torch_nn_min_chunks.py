#!/usr/bin/env python3
"""Device time of the PyTorch port's NN-min kernel (nn_min_sqdist, PERF.md
row 8) over forced chunks of p, at the four shapes its launch plan's cost
model (dpdist_tpu_torch/kernels/chamfer.py:plan_nn_min) was fitted to and
at a ground-truth generator's size (N = 50,000, M = 10,000), on one NVIDIA
GPU. Prints one JSON line: per shape the plan's own choice and
torch.profiler's device time per call for each chunk, with the card's name
and power limit.

    python3 scripts/torch_nn_min_chunks.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((1, 10000, 10000), (2, 1000, 4099), (256, 64, 64), (1, 1, 10000), (1, 50000, 10000))
CHUNKS = (4, 8, 16, 32, 64, 128, 256, 288, 480, 1024)
CALLS = 20


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dpdist_tpu_torch.kernels import chamfer

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    sms, per_sm = chamfer.sm_occupancy(0)
    planned = chamfer.plan_nn_min
    rng = np.random.default_rng(0)
    out = {"card": card, "sm_count": sms, "blocks_per_sm": per_sm, "shapes": []}
    for B, N, M in SHAPES:
        a, p = (torch.as_tensor(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32), device=dev)
                for n in (N, M))
        row = {"B": B, "N": N, "M": M, "plan": vars(planned(B, N, M, sms, per_sm)),
               "device_ms": {}}
        for chunk in CHUNKS + (row["plan"]["chunk"],):
            if chunk > -(-M // 4) * 4:
                continue
            tiles, splits = -(-N // chamfer.TILE_N), -(-M // chunk)
            units = B * tiles * splits
            plan = chamfer.NNMinPlan(tiles, splits, chunk, units, min(units, sms * per_sm))
            chamfer.plan_nn_min = lambda *_, plan=plan: plan
            with torch.no_grad():
                chamfer.nn_min_sqdist(a, p)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(CALLS):
                        chamfer.nn_min_sqdist(a, p)
                    torch.cuda.synchronize()
            row["device_ms"][chunk] = sum(e.self_device_time_total for e in prof.key_averages()
                                          if "nn_min_kernel" in e.key) / CALLS / 1e3
        chamfer.plan_nn_min = planned
        out["shapes"].append(row)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
