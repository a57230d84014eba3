#!/usr/bin/env python3
"""Times rows 6 and 3 of the PyTorch port (the patch-only gather
`table_gather` and its adjoint `table_gather_bwd`) and row 10
(`gather_patches_fused`, which shares row 6's persistent gather) of the
checkout under --root on one NVIDIA GPU, and prints one JSON line with the
card's name and power limit: each kernel's device time a launch
(torch.profiler, the mean over PROFILED calls) and its CUDA-event median
over RUNS calls, at B = 256 clouds, N = 256 queries, the committed grid
(8^3 cells, k = 5, C = 20), on inputs drawn from a fixed seed (queries
uniform in [-1.2, 1.2]^3, a contiguous grad as row 6's backward hands row
3); row 6 also with a bf16 output ("table_gather_bf16"), each row 6 entry
with its byte bound (`bound_ms`: the reached cells of fv and vox read once,
the rows written once, at 3.35 TB/s, as chip_smoke.py counts it); row 3 on
a bf16 grad ("table_gather_bwd_bf16"), at N = 64 on the strided patch part
of a bf16 x's gradient as rows 2 and 1 hand it (queries uniform in
[-1, 1]^3) and at N = 256 on the contiguous grad in bf16; row 10 at N =
64 on those queries with their mask; and row 6 on one cloud of N_DENSE
queries uniform in [-1, 1]^3, as dense evaluation hands it
("table_gather_dense", float32).

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
N_BF16 = 64
N_DENSE = 64 ** 3   # a 64^3 distance field's queries, one cloud
RUNS, PROFILED, WARMUP = 50, 20, 5
HBM_BYTES_PER_S = 3.35e12   # chip_smoke.py's H100 SXM device memory rate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="checkout whose dpdist_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused
    from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_bwd
    from dpdist_tpu_torch.ops import voxel_assign
    from dpdist_tpu_torch.ops.voxel import neighbor_ids

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
    q64 = torch.as_tensor(rng.uniform(-1, 1, (B, N_BF16, 3)).astype(np.float32), device=dev)
    vox64, mask64 = voxel_assign(q64, GRID)[:2]
    grad64 = torch.as_tensor(rng.normal(size=(B, N_BF16, 3 + K ** 3 * C)).astype(np.float32),
                             device=dev).to(torch.bfloat16)[..., 3:]
    grad16 = grad.to(torch.bfloat16)
    q_dense = torch.as_tensor(rng.uniform(-1, 1, (1, N_DENSE, 3)).astype(np.float32), device=dev)
    vox_dense = voxel_assign(q_dense, GRID)[0]

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

    def device_ms(fn, names):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        kept = [e for e in prof.key_averages() if any(name in e.key for name in names)]
        n = sum(e.count for e in kept)
        return sum(e.self_device_time_total for e in kept) / n / 1e3 if n else None

    def bound_ms(out_bytes):
        """Row 6's byte bound on (fv, vox): each reached cell of fv and each
        vox read once, the (B, N, k^3 C) rows written once."""
        nid = neighbor_ids(vox, torch.ones_like(vox, dtype=torch.float32), GRID, K).long()
        reached = torch.zeros(B, GRID ** 3 + 1, dtype=torch.bool, device=dev)
        reached.scatter_(1, torch.where(nid >= 0, nid, GRID ** 3).view(B, -1), True)
        n_reached = int(reached[:, :GRID ** 3].sum())
        moved = 4 * (n_reached * C + B * N) + out_bytes * B * N * K ** 3 * C
        return moved / HBM_BYTES_PER_S * 1e3

    # Kernel names: the bf16 adjoint's since it is the two-byte kernel's
    # bf16 instantiation, while it had its own design, and before (row 3's
    # kernel instantiated on bf16); row 6's on the persistent gather, and
    # before (one warp a row).
    bf16_names = ("table_gather_bwd_b16_kernel<__nv_bfloat16", "table_gather_bwd_bf16_kernel",
                  "table_gather_bwd_kernel<__nv_bfloat16")
    bf = torch.bfloat16
    rows = {"table_gather": (lambda: table_gather(fv, vox, GRID, K),
                             ("table_gather_rows_kernel<float", "table_gather_kernel<float")),
            "table_gather_bf16": (lambda: table_gather(fv, vox, GRID, K, dtype=bf),
                                  ("table_gather_rows_kernel<__nv_bfloat16",
                                   "table_gather_kernel<__nv_bfloat16")),
            "table_gather_bwd": (lambda: table_gather_bwd(vox, grad, GRID, K),
                                 ("table_gather_bwd_kernel<float",)),
            "table_gather_bwd_bf16": (lambda: table_gather_bwd(vox64, grad64, GRID, K), bf16_names),
            "table_gather_bwd_bf16_n256": (lambda: table_gather_bwd(vox, grad16, GRID, K),
                                           bf16_names),
            "gather_patches_fused": (lambda: gather_patches_fused(fv, vox64, mask64, GRID, K),
                                     ("gather_fused_kernel",)),
            "table_gather_dense": (lambda: table_gather(fv[:1], vox_dense, GRID, K),
                                   ("table_gather_rows_kernel<float", "table_gather_kernel<float"))}
    out = {"root": args.root, "card": card}
    for name, (fn, kernel) in rows.items():
        out[name] = {"ms": event_ms(fn), "device_ms": device_ms(fn, kernel)}
    out["table_gather"]["bound_ms"] = bound_ms(4)
    out["table_gather_bf16"]["bound_ms"] = bound_ms(2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
