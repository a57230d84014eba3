#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their hand-written kernels and checks
them: the frozen DPDist distance served from the committed nets (fused
kernel at 64 points; streaming 3DmFV encode and patch-only gather at 256),
served in bfloat16 (the fused gather + decoder kernel, fused_gather="full";
the composed bf16 path, "auto") and through the per-query gather
(fused_gather="on"), the frozen loss with its source gradient (table-gather
kernels and the adjoint; "on"), DPDist training (table-gather kernel), and
eval_pair on two 10,000-point clouds (encode, patch-only gather and the
NN-min kernel).

  1. device        the card's name and power limit; fails without CUDA.
  2. build         compiles dpdist_tpu_torch/csrc (one nvcc per source,
                   all started together, and one link).
  3. kernel        the fused 3DmFV + patch-gather kernel against its plain
                   PyTorch version at 2B = 512 clouds, M = N = 64, with
                   off-grid queries and points on cell edges (x within
                   2e-5, vox exact).
  4. table_kernels the table-gather kernel and its adjoint against their
                   plain versions at B = 256, N = 64, with off-grid and
                   cell-edge queries carrying gradient (x and vox exact;
                   dfv within 1e-6 of its largest entry, the same from run
                   to run, and equal bit for bit to the ordered plain sum,
                   one index_add_ per query in query order), and the fused
                   kernel's backward against autograd through the plain
                   composition.
  5. encode_kernel the streaming 3DmFV encode against the plain encode at
                   B = 256, N = 256 (one pass per cloud that finalises);
                   B = 4, N = 1,000 and B = 1, N = 10,000 (each cloud split
                   over blocks, then merged), with points on cell edges and
                   a few far outside the grid (within 2e-5); its backward
                   (the plain encode's replay) against autograd through the
                   plain encode at B = 16, N = 256.
  6. gather6_kernel the patch-only table gather against its plain version
                   at B = 256, N = 256 with off-grid queries (exact).
  7. chamfer_kernel the NN-min kernel against its plain version at B = 1,
                   N = M = 10,000, B = 2, N = 1,000, M = 4,099, N = 1,
                   M = 1, M below one float4 group, N and M one past a tile
                   and a chunk, B = 3 at N = 10,000, coordinates x100, and
                   points duplicated (d = 0 exactly) (within 1e-6 +
                   1e-5 |d|; over 5 calls torch.profiler sees
                   nn_min_kernel and no other kernel, at most once a call;
                   two calls equal bit for bit), and chamfer_distance on the
                   card at 10,000 x 10,000 against the plain path (within
                   1e-5).
  8. serving       per committed net: three requests of B = 256 synthetic
                   pairs through load_frozen_distance (launch counters
                   reset before and read after), outputs finite and in
                   [0, 2], the kernel path against the plain path
                   (fused_gather="off") within 1e-4, and the golden pairs
                   against the JAX values within 1e-4.
  9. serving_large the same at np = 256 (2 encode and 2 patch-only gather
                   launches per request, none of the others), with the
                   golden np = 256 pairs.
 10. frozen_grad   per committed net: the frozen loss and its gradient in
                   pcA on the golden pairs against the JAX values; three
                   source-gradient calls at B = 256 (counters reset before,
                   read after: 2 table-gather and 1 adjoint launch per
                   call), against the plain path and the fused-kernel
                   path; the parameters unchanged and without .grad.
 11. frozen_grad_large the same at np = 256: per call 2 encode, 2
                   patch-only gather and 1 adjoint launch, and one encode
                   replay (pcA's; none for pcB); against the plain path
                   and the golden np = 256 values.
 12. train         DPDistTrainer at the canonical config, B = 16: 30 steps
                   on one synthetic batch whose labels are distances to a
                   10k-point surface (counters reset before, read after:
                   one table-gather launch per step, no adjoint); the loss
                   falls; one step on the kernel path against the plain
                   path; save -> restore gives equal params.
 13. eval_pair_large cli.eval_pair.main in-process on two 10,000-point
                   synthetic surfaces written as csv (counters: 2 encode,
                   2 patch-only gather, 2 NN-min launches); each key
                   against the port's plain path on the same clouds; the
                   golden np = 256 pairs' chamfer and EMD on the card.
 14. fused_forward_kernel the fused gather + decoder kernel against its
                   plain version on the first np = 64 request (2B = 512
                   clouds, the committed net's decoder in bf16) with 5 % of
                   the queries pushed off the grid, and on the first
                   np = 256 request (within 2e-2 on pre-activation outputs,
                   all finite); both against the same rounding points with
                   float64 sums, printed.
 15. gather_fused_kernel the per-query gather against its plain version on
                   the first np = 64 request's pcA volumes and pcB queries,
                   partly off the grid (exact), and its backward (the
                   adjoint kernel on the masked gradient) against autograd
                   through the plain version (within 1e-6 of its largest
                   entry).
 16. bf16_kernels  the bf16 outputs of the fused mfv kernel, the table
                   gather and the patch-only gather against their float32
                   outputs rounded (within one bf16 ulp; equal expected).
 17. serving_bf16  per committed net, "full" and "auto" in bf16 at np = 64
                   and np = 256: three requests of B = 256 (counters: "full"
                   1 fused forward per request, plus 2 encodes at 256;
                   "auto" 1 fused mfv at 64, 2 encodes and 2 patch-only
                   gathers at 256); the golden pairs against the JAX bf16
                   values within 2e-3 and the float32 ones within 0.03;
                   "full" against "auto" within 2e-3; off-grid queries
                   exactly 0.
 18. serving_on    per committed net, "on" in float32 at np = 64 and 256
                   (counters: 2 per-query gathers per request, plus 2
                   encodes at 256); against the plain path and the golden
                   pairs within 1e-4.
 19. frozen_grad_on the frozen loss with "on" at np = 64 and 256 as in
                   frozen_grad: per call 2 per-query gathers and 1 adjoint
                   launch (plus 2 encodes and one replay at 256); d/dpcA
                   against the table path's by the per-point criterion.
 20. route_limits  configs past the fused kernels' limits, served from the
                   first np = 64 request (counters reset before, read
                   after): the committed decoder at embedding_size=1000
                   (past the mfv kernel's 992 Gaussians) in f32 and bf16
                   "auto" (2 table-gather launches) and bf16 "full" (1 fused
                   forward), and a random bf16 "full" net with hidden widths
                   40 (2 table-gather launches); each against the plain
                   path (1e-4; bf16 2e-3). A ValueError fails the phase.
 21. times         CUDA-event medians of 20 runs after warm-up: each kernel
                   with its bound, its plain version and a PyTorch library
                   call computing the same function where there is one
                   (rows 2 and 3 on the first request's pcB, the queries
                   the frozen loss gives them; row 6 on the np = 256
                   request's pcB; row 8 on eval_pair's clouds); the encode
                   kernel against the plain encode at B = 256, N = 64 and
                   256, and at B = 1, N = 10,000; row 9 at np = 256 and its
                   TFLOP/s at both sizes; the cuBLAS bf16 decoder with the
                   first layer's K padded to the pack's (a yardstick the
                   port never runs); the device time of each CUDA kernel
                   that rows 9 and 7 launch (torch.profiler); rows 2 (also
                   with its bf16 output) and 3 with their device times
                   (torch.profiler) and % of bound on both times, as rows 1
                   (also with its bf16 output and at M = N = 128, checked
                   against its plain version there), 10, 6 and 8 have
                   theirs, row 8 also with the issue-slot floor of its
                   per-dimension form at the card's top SM clock and at
                   B = 2, N = 1,000, M = 4,099 and B = 256, N = M = 64;
                   row 3
                   at N = 256 on the np = 256 frozen loss's inputs (the
                   patch part of row 6's gradient) with its bound,
                   index_add_, the ordered plain sum (bit for bit) and
                   float64 sums (within 1e-6 of the largest entry); the
                   forward, the frozen source-gradient step and the train
                   step at B = 256, np = 64, and the forward and the
                   source-gradient step at np = 256; the bf16 forwards
                   ("full", "auto") and the "on" forward at np = 64 and
                   256; eval_pair at 10,000 points, end to end and per key.

Every phase prints a start and an end line. A wall-clock guard ends the
run with a non-zero exit naming the phase. The last lines are the
kernels' JSON record, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}, printed only when every phase passed.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 300
NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
B_SERVE = 256            # pairs per request
REQUESTS = 3
B_KERNEL = 2 * B_SERVE   # the 2B stacked clouds one forward hands the fused kernel
NP = 64                  # points per cloud (the committed nets' num_point)
G, GRID, K, SIGMA, C = 512, 8, 5, 0.125, 20
TOL_X = 2e-5             # fused kernel vs plain: the encode sums in another order
# Adjoint vs plain, relative to the largest |dfv|: the sums run in another
# order, and their rounding grows with their size (cell 0 collects every
# off-grid query). On the H100 the error read 2.7e-7 of the largest entry
# at B = 256, N = 64 (7.63e-6 of 28.6) and at N = 200 (1.14e-5 of 42.6).
REL_BWD = 1e-6
TOL_DIST = 1e-4          # distances and losses: kernel path vs plain path and vs JAX
# Input gradients, per point relative to the largest entry: within
# REL_GRAD on all but OUTLIERS of the points and within REL_GRAD_FEW on
# every point. The encode's signed sqrt magnifies rounding differences on
# a few points (tests/test_torch_losses_optim.py says why).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05
B_TRAIN, TRAIN_STEPS, SURFACE_POINTS = 16, 30, 10000
NP_LARGE = 256           # the JAX bench's second forward size (bench.py:133-138)
EVAL_POINTS = 10000      # eval_pair's clouds, dense enough for the NN-min kernel
FAR = 4.5                # far outside the grid: Q underflows to 0 there
# NN-min kernel vs plain: the kernel sums the per-dimension squares with
# FMAs, so the last bits may differ.
TOL_NN_ABS, TOL_NN_REL = 1e-6, 1e-5
# The NN-min kernel's checks: (B, N, M, coordinate scale, points of a
# duplicated in p): eval_pair's clouds, N = 1, M = 1, M below one float4
# group of p, N and M one past a tile of a and a chunk of p, B = 3 at
# N = 10,000, coordinates x100, and d = 0 exactly.
NN_PROFILED_CALLS = 5
NN_SHAPES = ((1, EVAL_POINTS, EVAL_POINTS, 1, False), (2, 1000, 4099, 1, False),
             (1, 1, 777, 1, False), (2, 500, 1, 1, False), (2, 3000, 3, 1, False),
             (2, 1025, 1025, 1, False), (3, EVAL_POINTS, 2000, 1, False),
             (1, 4000, 3000, 100.0, False), (2, 2000, 2500, 1, True))
# chamfer and EMD on the card against the plain path: both sides sum in
# float32 (tests/test_torch_chamfer_emd.py's tolerance against JAX).
TOL_CHAMFER = TOL_EMD = 1e-5
# Float32 operations per (point, Gaussian) pair of the encode: the logit
# (3 subtractions, 3 divisions, 3 products, 3 additions), the softmax's
# exp, division and sum, and the 20 pools (d_pi 4, d_mu 12, d_sigma 18).
ENCODE_OPS_PER_PAIR = 50
NN_OPS_PER_PAIR = 9      # 3 subtractions, 3 products, 2 additions, 1 minimum
# Its issue slots: 3 FADD, 1 FMUL, 2 FFMA and 1 FMNMX a pair, a warp
# instruction covering 32 pairs, one a clock on each of an SM's 4
# schedulers.
NN_INSTRUCTIONS_PER_PAIR = 7
TIMED_RUNS = 20
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): device
# memory rate, float32 outside the tensor cores, and bf16 on the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# Fused gather + decoder kernel vs its plain version, on pre-activation
# outputs: both sum exact bf16 products in float32, in other orders (the
# tensor cores' float32 accumulation does not round to nearest at each
# add), and a hidden activation at a bf16 rounding edge may round the other
# way. On the H100, against the same rounding points with float64 sums,
# the plain version strayed by up to 8.7e-3 and the kernel by up to 9.8e-3
# on off-grid rows, where |y| reaches 31 (in-grid rows: 2.8e-3 and
# 3.7e-3); the phase prints both each run.
TOL_FF = 2e-2
# bf16 served distances against the JAX golden bf16 values and "full"
# against the composed bf16 path: the JAX package's own bound between its
# two bf16 paths (tests/test_kernels.py:146-166); against float32: its
# bf16-vs-f32 tolerance (tests/test_dpdist_model.py:37-56).
TOL_BF16, TOL_BF16_VS_F32 = 2e-3, 0.03
OFF_GRID_SHARE = 0.05    # queries pushed off the grid in the kernel checks

_phase = "start"


def _time_out(*_):
    print(f"chip_smoke: FAILED, time limit of {TIME_LIMIT_S} s hit in phase "
          f"'{_phase}'", flush=True)
    os._exit(124)


def _watchdog():
    # Backstop for a main thread stuck in native code, where the SIGALRM
    # handler cannot run.
    time.sleep(TIME_LIMIT_S + 15)
    _time_out()


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _phase
        _phase = self.name
        self.t0 = time.perf_counter()
        print(f"[phase {self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        print(f"[phase {self.name}] end {status} after {dt:.2f} s", flush=True)
        return False


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_grad_rows(got, want, what):
    """Per-point gradient agreement (see REL_GRAD); returns the largest
    relative error."""
    err = (got - want).abs().amax(dim=-1).flatten() / float(want.abs().max())
    worst, share = float(err.max()), float((err > REL_GRAD).float().mean())
    check(worst <= REL_GRAD_FEW and share <= OUTLIERS,
          f"{what}: worst point {worst:.3e}, share above {REL_GRAD}: {share:.3f}")
    return worst


def cuda_median_ms(fn, runs=TIMED_RUNS, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, match, calls=5):
    """Mean device time (ms) per call of fn of the CUDA kernels whose name
    holds `match` (or one of the names in a tuple), over `calls` calls under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    matches = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if any(m in e.key for m in matches))
    check(us > 0, f"torch.profiler saw no device time of {match}")
    return us / calls / 1e3


def cuda_kernel_names(fn, calls):
    """Names of the CUDA kernels that `calls` calls of fn launch, as
    torch.profiler records them (memsets and copies are not kernels; the
    profiler may drop a record of a short run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memset", "Memcpy"))]


def sass_loop_counts(lib_path, kernel):
    """The instruction counts of the innermost loop of `kernel` that holds
    the most FMNMX, in the built library's SASS (cuobjdump): {opcode: n}."""
    import collections
    import re

    from dpdist_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    body = sass[sass.index(kernel):]
    body = body[:body.find("Function :")] if "Function :" in body else body
    code = [(int(m.group(1), 16), m.group(2), m.group(0)) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;",
                        body)]
    loops = []   # (first, last) address of each backward branch's loop
    for addr, op, text in code:
        target = re.search(r"0x([0-9a-f]+)", text)
        if op.startswith("BRA") and target and int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    best = collections.Counter()
    for lo, hi in loops:
        if any(lo <= a < hi for a2, a in loops if (a2, a) != (lo, hi)):
            continue   # holds another loop
        loop = collections.Counter(op.split(".")[0] for a, op, _ in code if lo <= a <= hi)
        if loop["FMNMX"] > best["FMNMX"]:
            best = loop
    return dict(best)


def bound(bytes_moved, flops, peak=F32_FLOP_PER_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    with the operations at `peak` per second."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_kernel_inputs(rng, torch, dev, n_clouds):
    """Encoded clouds inside the grid with some coordinates exactly on cell
    edges; queries partly off-grid, with edges at -1, +1 and in between."""
    import numpy as np

    edges = (-1.0 + (2.0 / GRID) * np.arange(GRID + 1)).astype(np.float32)  # -1 .. 1
    pts = rng.uniform(-0.95, 0.95, (n_clouds, NP, 3)).astype(np.float32)
    on_edge = rng.random(pts.shape) < 0.1
    pts[on_edge] = rng.choice(edges[1:-1], on_edge.sum())
    q = rng.uniform(-1.2, 1.2, (n_clouds, NP, 3)).astype(np.float32)
    on_edge = rng.random(q.shape) < 0.15
    q[on_edge] = rng.choice(edges, on_edge.sum())
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(q, device=dev))


def make_encode_inputs(rng, torch, dev, B, N):
    """Clouds inside the grid with 10 % of their coordinates on cell edges,
    and about 1 % of their points (the first one at least) far outside."""
    import numpy as np

    edges = (-1.0 + (2.0 / GRID) * np.arange(GRID + 1)).astype(np.float32)
    pts = rng.uniform(-0.95, 0.95, (B, N, 3)).astype(np.float32)
    on_edge = rng.random(pts.shape) < 0.1
    pts[on_edge] = rng.choice(edges[1:-1], on_edge.sum())
    far = rng.random((B, N)) < 0.01
    far[:, 0] = True
    pts[far] = (rng.choice([-1.0, 1.0], (far.sum(), 3)) * FAR).astype(np.float32)
    return torch.as_tensor(pts, device=dev)


def make_requests(rng, torch, dev, n_points=NP):
    """REQUESTS batches of B_SERVE synthetic pairs (chair/box/sphere, x0.8)."""
    import numpy as np
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    fams = ("chair", "box", "sphere")
    reqs = []
    for r in range(REQUESTS):
        a, b = [], []
        for i in range(B_SERVE):
            seed = int(rng.integers(0, 2 ** 31 - 2))
            a.append(synthetic_surface(fams[i % 3], seed=seed, n_points=n_points) * 0.8)
            b.append(synthetic_surface(fams[(i + r) % 3], seed=seed + 1,
                                       n_points=n_points) * 0.8)
        reqs.append(tuple(torch.as_tensor(np.stack(x).astype(np.float32), device=dev)
                          for x in (a, b)))
    return reqs


def make_train_batch(rng, torch, dev):
    """One dataset batch in the reference's layout: batch_data (B, 6N, 3) =
    [surface(2N), near(2N), far(2N)] and labels (B, 4N) = [near_d, far_d],
    the distances of the near and far points to a SURFACE_POINTS-point
    synthetic surface, taken by torch.cdist on the card."""
    import numpy as np
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    fams = ("chair", "box", "sphere", "torus")
    surf = np.stack([synthetic_surface(fams[i % 4], seed=100 + i, n_points=SURFACE_POINTS) * 0.8
                     for i in range(B_TRAIN)]).astype(np.float32)
    n2 = 2 * NP
    pick = np.stack([rng.choice(SURFACE_POINTS, 2 * n2, replace=False) for _ in range(B_TRAIN)])
    samples = np.take_along_axis(surf, pick[..., None], axis=1)
    on_surface = samples[:, :n2]
    near = samples[:, n2:] + rng.normal(0.0, 0.05, (B_TRAIN, n2, 3)).astype(np.float32)
    far = rng.uniform(-1.0, 1.0, (B_TRAIN, n2, 3)).astype(np.float32)
    surf_t = torch.as_tensor(surf, device=dev)
    probes = torch.as_tensor(np.concatenate([near, far], axis=1), device=dev)
    labels = torch.cdist(probes, surf_t).amin(dim=-1).cpu().numpy()
    return np.concatenate([on_surface, near, far], axis=1), labels


def reset_counters(*wrappers):
    for w in wrappers:
        w.launches = 0


def neighbour_rows(torch, vox, n_cells):
    """For each (query, offset) of the k^3 window, the row of its neighbour
    cell in a (B*(V+1), C) volume whose last row per cloud is a zero
    (gather) or sink (scatter) row; and which windows lie inside the grid.
    The index a library call needs to compute a patch gather or its adjoint."""
    kh = K // 2
    dev = vox.device
    o = torch.arange(K ** 3, device=dev)
    shift = torch.stack([o // (K * K) - kh, (o // K) % K - kh, o % K - kh], -1)
    v = vox.long()
    digits = torch.stack([v // (GRID * GRID), (v // GRID) % GRID, v % GRID], -1)
    nb = digits[:, :, None, :] + shift                                  # (B, N, K3, 3)
    inside = ((nb >= 0) & (nb < GRID)).all(-1)
    flat = nb[..., 0] * GRID * GRID + nb[..., 1] * GRID + nb[..., 2]
    base = (torch.arange(vox.shape[0], device=dev) * (n_cells + 1))[:, None, None]
    rows = (base + torch.where(inside, flat, torch.full_like(flat, n_cells))).reshape(-1)
    return rows, inside


def write_cloud(path, pts):
    import numpy as np

    np.savetxt(path, pts, delimiter=",", fmt="%.8g")


def main() -> int:
    signal.signal(signal.SIGALRM, _time_out)
    signal.alarm(TIME_LIMIT_S)
    threading.Thread(target=_watchdog, daemon=True).start()
    t_start = time.perf_counter()

    with Phase("device"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: FAILED, no CUDA device "
                             "(torch.cuda.is_available() is False)")
        sys.path.insert(0, str(ROOT))
        import numpy as np

        import dpdist_tpu_torch  # noqa: F401  (sets TF32 off)
        from dpdist_tpu_torch.cli import eval_pair
        from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
        from dpdist_tpu_torch.data.golden import golden_clouds, load_golden
        from dpdist_tpu_torch.data.synthetic import synthetic_surface
        from dpdist_tpu_torch.kernels import build
        from dpdist_tpu_torch.kernels import chamfer as chamfer_kernels
        from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist, nn_min_sqdist_plain
        from dpdist_tpu_torch.kernels.fused_forward import (
            fused_forward,
            fused_forward_plain,
            pack_decoder,
        )
        from dpdist_tpu_torch.kernels.gather_fused import (
            gather_patches_fused,
            gather_patches_fused_plain,
        )
        from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
        from dpdist_tpu_torch.kernels.table_gather import (
            table_gather,
            table_gather_bwd,
            table_gather_bwd_ordered,
            table_gather_bwd_plain,
            table_gather_plain,
            table_gather_x,
            table_gather_x_plain,
        )
        from dpdist_tpu_torch.kernels.threedmfv import split_plan, threedmfv_kernel
        from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
        from dpdist_tpu_torch.models import apply_dpdist, init_dpdist
        from dpdist_tpu_torch.models.dpdist import route as route_of
        from dpdist_tpu_torch.nn import mlp_apply
        from dpdist_tpu_torch.ops import (
            chamfer_distance,
            earth_mover_distance,
            neighbor_ids,
            sinkhorn_emd,
            threedmfv,
            threedmfv_plain,
            voxel_assign,
        )
        from dpdist_tpu_torch.serving import FrozenDistance, load_frozen_distance
        from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
        from dpdist_tpu_torch.train.logging import RunLogger
        from dpdist_tpu_torch.train.trainer import DPDistTrainer

        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        smi = smi.splitlines()[0]
        card = f"{name}, power limit {smi.split(',')[-1].strip()}"
        print(f"device: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")

    with Phase("build"):
        t0 = time.perf_counter()
        lib_path = build.build()
        build.library()
        print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s "
              f"(nvcc: {build.build_seconds} s; None = found built)", flush=True)

    def nn_plan(B, N, M):
        """The NN-min kernel's launch plan for these sizes on this card."""
        return chamfer_kernels.plan_nn_min(B, N, M, *chamfer_kernels.sm_occupancy(dev.index))

    rng = np.random.default_rng(0)
    with Phase("kernel"):
        pts, q = make_kernel_inputs(rng, torch, dev, B_KERNEL)
        with torch.no_grad():
            x, vox = mfv_x(pts, q, G, SIGMA, GRID, K)
            torch.cuda.synchronize()
            x_ref, vox_ref = mfv_x_plain(pts, q, G, SIGMA, GRID, K)
        check(x.shape == (B_KERNEL, NP, 3 + K ** 3 * C), f"x shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), "x has non-finite values")
        err_mfv = float((x - x_ref).abs().max())
        vox_equal = bool(torch.equal(vox, vox_ref.to(torch.int32)))
        off_grid = int((vox_ref == 0).sum())
        print(f"mfv kernel vs plain: max |dx| = {err_mfv:.3e} (tol {TOL_X}), vox equal: "
              f"{vox_equal}, queries in cell 0 (off-grid or cell 0): {off_grid}", flush=True)
        check(err_mfv <= TOL_X, f"max |dx| {err_mfv} > {TOL_X}")
        check(vox_equal, "vox differs from the plain version")
        del x, x_ref

    with Phase("table_kernels"):
        fv = torch.as_tensor(rng.normal(size=(B_SERVE, G, C)).astype(np.float32), device=dev)
        tq = q[:B_SERVE].contiguous()
        with torch.no_grad():
            x, vox = table_gather_x(fv, tq, GRID, K)
            torch.cuda.synchronize()
            x_ref, vox_ref = table_gather_x_plain(fv, tq, GRID, K)
        err_tgx = float((x - x_ref).abs().max())
        check(torch.equal(vox, vox_ref), "table_gather_x: vox differs from the plain version")
        check(torch.equal(x, x_ref), f"table_gather_x: x differs from the plain version "
              f"(max |dx| {err_tgx})")
        gx = torch.as_tensor(rng.normal(size=(B_SERVE, NP, 3 + K ** 3 * C)).astype(np.float32),
                             device=dev)
        grad = gx[..., 3:]            # the patch part of x's gradient, off-grid rows included
        dfv = table_gather_bwd(vox, grad, GRID, K)
        dfv_again = table_gather_bwd(vox, grad, GRID, K)
        torch.cuda.synchronize()
        dfv_ref = table_gather_bwd_plain(vox, grad, GRID, K)
        ordered_equal = bool(torch.equal(dfv, table_gather_bwd_ordered(vox, grad, GRID, K)))
        err_bwd = float((dfv - dfv_ref).abs().max())
        tol_bwd = REL_BWD * float(dfv_ref.abs().max())
        print(f"table_gather_x vs plain: x and vox equal ({int((vox == 0).sum())} queries in "
              f"cell 0); table_gather_bwd vs plain: max |d dfv| = {err_bwd:.3e} (tol "
              f"{tol_bwd:.3e} = {REL_BWD} x max |dfv|), run to run equal: "
              f"{bool(torch.equal(dfv, dfv_again))}, equal to the ordered plain sum: "
              f"{ordered_equal}", flush=True)
        check(err_bwd <= tol_bwd, f"table_gather_bwd: max |d dfv| {err_bwd} > {tol_bwd}")
        check(torch.equal(dfv, dfv_again), "table_gather_bwd differs from run to run")
        check(ordered_equal, "table_gather_bwd differs from the ordered plain sum")
        # The fused kernel's backward against autograd through the plain composition.
        co = torch.as_tensor(rng.normal(size=(B_SERVE, NP, 3 + K ** 3 * C)).astype(np.float32),
                             device=dev)
        grads = []
        for fn in (mfv_x, mfv_x_plain):
            p_, q_ = pts[:B_SERVE].clone().requires_grad_(), tq.clone().requires_grad_()
            xx = fn(p_, q_, G, SIGMA, GRID, K)[0]
            grads.append(torch.autograd.grad((xx * co).sum(), (p_, q_)))
        (dp, dq), (dp_ref, dq_ref) = grads
        check(torch.equal(dq, dq_ref), "mfv backward: dq differs")
        err_mfv_bwd = check_grad_rows(dp, dp_ref, "mfv backward: d points")
        print(f"mfv backward vs plain composition: dq equal, d points worst point "
              f"{err_mfv_bwd:.3e} of max", flush=True)
        del x_ref, gx, grad, dfv_ref, co, grads, dp, dp_ref

    with Phase("encode_kernel"):
        err_enc = 0.0
        for B, N in ((B_SERVE, NP_LARGE), (4, 1000), (1, EVAL_POINTS)):
            pe = make_encode_inputs(rng, torch, dev, B, N)
            with torch.no_grad():
                fve = threedmfv_kernel(pe, G, SIGMA)
                torch.cuda.synchronize()
                fve_ref = threedmfv_plain(pe, G, SIGMA)
            check(fve.shape == (B, G, C), f"encode shape {tuple(fve.shape)}")
            check(bool(torch.isfinite(fve).all()), "encode has non-finite values")
            err = float((fve - fve_ref).abs().max())
            err_enc = max(err_enc, err)
            S, chunk = split_plan(B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
            print(f"encode kernel vs plain at B={B}, N={N} ({S} chunk(s) of {chunk} points per "
                  f"cloud): max |d fv| = {err:.3e} (tol {TOL_X})", flush=True)
            check(err <= TOL_X, f"encode at B={B}, N={N}: max |d fv| {err} > {TOL_X}")
            del fve, fve_ref
        pe = make_encode_inputs(rng, torch, dev, 16, NP_LARGE)
        co = torch.as_tensor(rng.normal(size=(16, G, C)).astype(np.float32), device=dev)
        grads = []
        for fn in (threedmfv_kernel, threedmfv_plain):
            p_ = pe.clone().requires_grad_()
            grads.append(torch.autograd.grad((fn(p_, G, SIGMA) * co).sum(), p_)[0])
        err_enc_bwd = float((grads[0] - grads[1]).abs().max())
        print(f"encode backward (replay) vs autograd through the plain encode at B=16, "
              f"N={NP_LARGE}: max |d| = {err_enc_bwd:.3e} (equal expected)", flush=True)
        check(torch.equal(grads[0], grads[1]), "encode backward differs from the plain encode's")
        del pe, co, grads

    with Phase("gather6_kernel"):
        fv6 = torch.as_tensor(rng.normal(size=(B_SERVE, G, C)).astype(np.float32), device=dev)
        q6 = torch.as_tensor(rng.uniform(-1.2, 1.2, (B_SERVE, NP_LARGE, 3)).astype(np.float32),
                             device=dev)
        vox6 = voxel_assign(q6, GRID)[0]
        with torch.no_grad():
            out6 = table_gather(fv6, vox6, GRID, K)
            torch.cuda.synchronize()
            ref6 = table_gather_plain(fv6, vox6, GRID, K)
        err_tg6 = float((out6 - ref6).abs().max())
        off6 = int((voxel_assign(q6, GRID)[1] == 0).sum())
        print(f"table_gather vs plain at B={B_SERVE}, N={NP_LARGE}: max |d| = {err_tg6:.3e} "
              f"(exact expected), {off6} off-grid queries", flush=True)
        check(off6 > 0, "no off-grid query in the gather check")
        check(torch.equal(out6, ref6), f"table_gather differs from its plain version ({err_tg6})")
        del fv6, q6, vox6, out6, ref6

    with Phase("chamfer_kernel"):
        err_nn = 0.0
        # The first two shapes draw from the run's generator, the others from
        # their own, so that the later phases' inputs do not depend on this list.
        r_nn = np.random.default_rng(8)
        for i, (B, N, M, scale, dup) in enumerate(NN_SHAPES):
            gen = rng if i < 2 else r_nn
            a_, p_ = (gen.uniform(-1.0, 1.0, (B, n, 3)).astype(np.float32) * np.float32(scale)
                      for n in (N, M))
            if dup:
                p_[:, :min(N, M):2] = a_[:, :min(N, M):2]
            a_, p_ = (torch.as_tensor(t, device=dev) for t in (a_, p_))
            with torch.no_grad():
                d = nn_min_sqdist(a_, p_)
                torch.cuda.synchronize()
                d_ref = nn_min_sqdist_plain(a_, p_)
                again = torch.equal(nn_min_sqdist(a_, p_), d)
                names = cuda_kernel_names(lambda: nn_min_sqdist(a_, p_), NN_PROFILED_CALLS)
            err = float((d - d_ref).abs().max())
            err_nn = max(err_nn, err)
            bad = int(((d - d_ref).abs() > TOL_NN_ABS + TOL_NN_REL * d_ref.abs()).sum())
            zeros = bool((d[:, :min(N, M):2] == 0).all()) if dup else None
            print(f"nn_min_sqdist vs plain at B={B}, N={N}, M={M}, x{scale}"
                  f"{', duplicated points' if dup else ''}: max |d| = {err:.3e}, entries "
                  f"outside {TOL_NN_ABS} + {TOL_NN_REL}|d|: {bad}; run to run equal: {again}; "
                  f"CUDA kernels of {NN_PROFILED_CALLS} calls: {sorted(set(names))} x "
                  f"{len(names)}" + (f"; d = 0 where duplicated: {zeros}" if dup else ""),
                  flush=True)
            check(bad == 0, f"nn_min_sqdist at B={B}, N={N}, M={M} disagrees on {bad} entries")
            check(again, f"nn_min_sqdist at B={B}, N={N}, M={M} differs from run to run")
            # nn_min_kernel and nothing else, at most once a call; at least
            # once shows in dist, which the memset fills with NaN bits.
            check(1 <= len(names) <= NN_PROFILED_CALLS
                  and all("nn_min_kernel" in n for n in names),
                  f"nn_min_sqdist at B={B}, N={N}, M={M}: CUDA kernels {names}")
            check(zeros is not False, "nn_min_sqdist: a duplicated point is not at distance 0")
        a10, b10 = (torch.as_tensor(rng.uniform(-1.0, 1.0, (1, EVAL_POINTS, 3)).astype(np.float32),
                                    device=dev) for _ in range(2))
        with torch.no_grad():
            for sq in (True, False):
                got = float(chamfer_distance(a10, b10, sqrt=sq))
                want = float(chamfer_distance(a10, b10, sqrt=sq, impl="plain"))
                print(f"chamfer_distance (sqrt={sq}) at {EVAL_POINTS} x {EVAL_POINTS}: kernel "
                      f"path {got:.7f}, plain path {want:.7f}, |d| = {abs(got - want):.3e} "
                      f"(tol {TOL_CHAMFER})", flush=True)
                check(abs(got - want) <= TOL_CHAMFER, "chamfer_distance: kernel vs plain path")
        del a_, p_, d, d_ref, a10, b10

    counters = {"mfv_gather_x": mfv_x, "table_gather_x": table_gather_x,
                "table_gather_bwd": table_gather_bwd, "threedmfv": threedmfv_kernel,
                "table_gather": table_gather, "nn_min_sqdist": nn_min_sqdist,
                "fused_forward": fused_forward, "gather_patches_fused": gather_patches_fused}
    launches = dict.fromkeys(counters, 0)

    def start_count():
        reset_counters(*counters.values())
        threedmfv_kernel.replays = 0

    def read_count():
        """The launches since start_count, added to the run's main-path totals."""
        torch.cuda.synchronize()
        launched = {k: w.launches for k, w in counters.items()}
        for k in launches:
            launches[k] += launched[k]
        return launched

    def expected(**nonzero):
        return {k: nonzero.get(k, 0) for k in counters}

    golden = load_golden()
    large = golden["np256"]
    gA, gB = (torch.as_tensor(a, device=dev) for a in golden_clouds(golden))
    gA_large, gB_large = (torch.as_tensor(a, device=dev)
                          for a in golden_clouds(golden, large["num_point"]))

    def serve(requests, section, clouds, want):
        """Per committed net: the requests through load_frozen_distance,
        counted; outputs against the plain path and the section's golden
        distances. Returns the last net's model."""
        n_points = requests[0][0].shape[1]
        for net in NETS:
            model = load_frozen_distance(str(ROOT / net), device=dev)
            plain = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="off")
            start_count()
            with torch.no_grad():
                outs = [model(a, b) for a, b in requests]
            launched = read_count()
            print(f"{net}: {REQUESTS} requests of {B_SERVE} pairs at np={n_points}, kernel "
                  f"launches {launched}", flush=True)
            check(launched == want, f"{net}: unexpected launches")
            with torch.no_grad():
                refs = [plain(a, b) for a, b in requests]
                got_golden = model(*clouds).cpu().numpy()
            for out in outs:
                check(out.shape == (B_SERVE,), f"output shape {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()), "non-finite distance")
                check(float(out.min()) >= 0.0 and float(out.max()) <= 2.0,
                      f"distance outside [0, 2]: {float(out.min())}..{float(out.max())}")
            err_plain = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
            err_golden = float(np.abs(got_golden - np.asarray(section["distance"][net])).max())
            print(f"{net}: distances {float(outs[0].min()):.4f}..{float(outs[0].max()):.4f}; "
                  f"kernel path vs plain path max |d| = {err_plain:.3e}; vs JAX golden "
                  f"max |d| = {err_golden:.3e} (tol {TOL_DIST})", flush=True)
            check(err_plain <= TOL_DIST, f"{net}: kernel vs plain path {err_plain}")
            check(err_golden <= TOL_DIST, f"{net}: vs golden {err_golden}")
        return model

    with Phase("serving"):
        requests = make_requests(rng, torch, dev)
        fwd_model = serve(requests, golden, (gA, gB), expected(mfv_gather_x=REQUESTS))

    with Phase("serving_large"):
        requests_large = make_requests(rng, torch, dev, NP_LARGE)
        fwd_model_large = serve(requests_large, large, (gA_large, gB_large),
                                expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS))

    def src_grad(loss_fn, a, b):
        a = a.detach().requires_grad_(True)
        value = loss_fn(a, b)
        (g,) = torch.autograd.grad(value, a)
        return value.detach(), g

    def frozen_grad(requests, section, clouds, want, replays, other_modes, mode=None):
        """Per committed net: the frozen loss and d/dpcA on the section's
        golden pairs against the JAX values; source-gradient calls on the
        requests, counted, against the paths of other_modes; the parameters
        unchanged and without .grad. `mode` sets fused_gather (default: the
        checkpoint's, "auto", which a gradient context resolves as
        "table")."""
        gold = section["frozen_loss"]
        rows = gold["grad_pairs"]
        n_points = requests[0][0].shape[1]
        label = mode or "table"
        for net in NETS:
            cfg, np_params = load_dpdist_checkpoint(str(ROOT / net))
            if mode:
                cfg = cfg.replace(fused_gather=mode)
            params = params_from_jax(np_params, dev)
            leaves = [t.requires_grad_(True) for lp in params["decoder"]["layers"]
                      for t in lp.values()]
            before = [t.detach().clone() for t in leaves]
            loss_fn = make_frozen_dpdist_loss(params, cfg,
                                              out_of_grid_penalty=gold["out_of_grid_penalty"])
            value, g = src_grad(loss_fn, *clouds)
            err_value = abs(float(value) - gold[net]["value"])
            worst = check_grad_rows(g[rows], torch.as_tensor(gold[net]["grad_pcA"], device=dev),
                                    f"{net}: golden d/dpcA")
            print(f"{net}: golden frozen loss at np={clouds[0].shape[1]} |d| = {err_value:.3e} "
                  f"(tol {TOL_DIST}); d/dpcA worst point {worst:.3e} of max", flush=True)
            check(err_value <= TOL_DIST, f"{net}: golden frozen loss off by {err_value}")

            start_count()
            outs = [src_grad(loss_fn, a, b) for a, b in requests]
            launched = read_count()
            print(f"{net}: {REQUESTS} source-gradient calls of {B_SERVE} pairs at "
                  f"np={n_points}, kernel launches {launched}, encode replays "
                  f"{threedmfv_kernel.replays}", flush=True)
            check(launched == want, f"{net}: unexpected launches")
            check(threedmfv_kernel.replays == replays, f"{net}: unexpected encode replays")
            for other_mode in other_modes:
                other = make_frozen_dpdist_loss(params, cfg.replace(fused_gather=other_mode))
                for (v, g), (a, b) in zip(outs, requests):
                    v_ref, g_ref = src_grad(other, a, b)
                    check(bool(torch.isfinite(g).all()), "non-finite gradient")
                    d = abs(float(v - v_ref))
                    worst = check_grad_rows(g, g_ref, f"{net}: {label} vs {other_mode} path")
                    check(d <= TOL_DIST, f"{net}: loss, {label} vs {other_mode} path: {d}")
                print(f"{net}: {label} path vs {other_mode} path: loss |d| = {d:.3e}, d/dpcA "
                      f"worst point {worst:.3e} of max (last request)", flush=True)
            check(all(t.grad is None for t in leaves), f"{net}: a parameter received .grad")
            check(all(torch.equal(t, b) for t, b in zip(leaves, before)),
                  f"{net}: a parameter changed")

    with Phase("frozen_grad"):
        frozen_grad(requests, golden, (gA, gB),
                    expected(table_gather_x=2 * REQUESTS, table_gather_bwd=REQUESTS), 0,
                    ("off", "mfv"))

    with Phase("frozen_grad_large"):
        # One encode replay per call: pcA's. pcB needs no gradient, so its
        # encode is not replayed, and its surface needs no adjoint.
        frozen_grad(requests_large, large, (gA_large, gB_large),
                    expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS,
                             table_gather_bwd=REQUESTS), REQUESTS, ("off",))

    with Phase("train"), tempfile.TemporaryDirectory() as tmp:
        mcfg, tcfg = DPDistConfig(), TrainConfig(batch_size=B_TRAIN, augment=False)
        data, labels = make_train_batch(rng, torch, dev)
        trainer = DPDistTrainer(mcfg, tcfg, run_dir=os.path.join(tmp, "run"), device=dev,
                                logger=RunLogger(os.path.join(tmp, "run"), echo=False))
        start = [t.detach().clone() for lp in trainer.params["decoder"]["layers"]
                 for t in lp.values()]
        start_count()
        losses = [trainer.train_step(data, labels)["loss"] for _ in range(TRAIN_STEPS)]
        launched = read_count()
        losses = torch.stack(losses).cpu().numpy()
        print(f"train: {TRAIN_STEPS} steps at B={B_TRAIN}, kernel launches {launched}; loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f} (first 5 mean {losses[:5].mean():.5f}, last "
              f"5 mean {losses[-5:].mean():.5f})", flush=True)
        check(launched == expected(table_gather_x=TRAIN_STEPS), "train: unexpected launches")
        check(bool(np.isfinite(losses).all()), "train: non-finite loss")
        check(losses[-5:].mean() < losses[:5].mean(), "train: the loss did not fall")

        # One step on the kernel path and on the plain path from the same
        # params, restored from a checkpoint of the trained ones.
        path = trainer.save(tag="smoke")
        steps = []
        for mode in ("auto", "off"):
            t = DPDistTrainer(mcfg.replace(fused_gather=mode), tcfg,
                              run_dir=os.path.join(tmp, mode), device=dev,
                              logger=RunLogger(os.path.join(tmp, mode), echo=False))
            t.restore(path)
            loss, grads = t.loss_and_grads(*t.make_batch(data, labels))
            t.train_step(data, labels)
            steps.append((float(loss), grads, [p.detach() for lp in t.params["decoder"]["layers"]
                                               for p in (lp["b"], lp["w"])]))
        (l_k, g_k, p_k), (l_p, g_p, p_p) = steps
        err_loss = abs(l_k - l_p)
        err_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_k, g_p))
        lr = tcfg.learning_rate
        bad = 0
        for a, b, gref in zip(p_k, p_p, g_p):
            diff = (a - b).abs()
            bad += int((diff[gref.abs() > 1e-6] > 1e-6).sum()) + int((diff > 2 * lr + 1e-6).sum())
        print(f"train step, kernel path vs plain path: loss |d| = {err_loss:.3e}, grads worst "
              f"{err_g:.3e} of max, params after the step outside tolerance: {bad}", flush=True)
        check(err_loss <= 1e-5 and err_g <= REL_GRAD and bad == 0,
              "train step: kernel path and plain path disagree")

        restored = DPDistTrainer(mcfg, tcfg, run_dir=os.path.join(tmp, "restored"), device=dev,
                                 logger=RunLogger(os.path.join(tmp, "restored"), echo=False))
        restored.restore(path)
        same = all(torch.equal(a, b) for la, lb in zip(trainer.params["decoder"]["layers"],
                                                       restored.params["decoder"]["layers"])
                   for a, b in ((la["w"], lb["w"]), (la["b"], lb["b"])))
        moved = any(not torch.equal(v, t) for v, t in zip(
            start, (t for lp in trainer.params["decoder"]["layers"] for t in lp.values())))
        print(f"train: save -> restore equal: {same}; params moved from init: {moved}", flush=True)
        check(same and moved and restored.global_step == trainer.global_step,
              "train: save -> restore")
        del restored, steps

    with Phase("eval_pair_large"), tempfile.TemporaryDirectory() as tmp:
        files = []
        for fname, family, seed in (("a.txt", "chair", 7), ("b.txt", "box", 8)):
            files.append(os.path.join(tmp, fname))
            write_cloud(files[-1], synthetic_surface(family, seed=seed,
                                                     n_points=EVAL_POINTS) * 0.8)
        eval_args = ["--dpdist_ckpt", str(ROOT / NETS[0]), "--cloud_a", files[0],
                     "--cloud_b", files[1], "--num_point", str(EVAL_POINTS)]
        start_count()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            t0 = time.perf_counter()
            result = eval_pair.main(eval_args)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
        launched = read_count()
        print(f"eval_pair on two {EVAL_POINTS}-point clouds: {result} in {eval_s:.3f} s "
              f"(first call), kernel launches {launched}", flush=True)
        check(json.loads(printed.getvalue()) == result, "eval_pair printed another result")
        check(launched == expected(threedmfv=2, table_gather=2, nn_min_sqdist=2),
              "eval_pair: unexpected launches")
        # The same clouds through the port's plain path.
        eA, eB = (torch.as_tensor(np.loadtxt(f, delimiter=",")[None].astype(np.float32),
                                  device=dev) for f in files)
        plain = load_frozen_distance(str(ROOT / NETS[0]), device=dev, fused_gather="off")
        with torch.no_grad():
            want = {"dpdist": float(plain(eA, eB).mean()),
                    "chamfer": float(chamfer_distance(eA, eB, impl="plain")),
                    "emd": float(earth_mover_distance(eA, eB))}
        diffs = {k: abs(result[k] - want[k]) for k in want}
        print(f"eval_pair vs the plain path: {want}; |d| {diffs} (tol dpdist {TOL_DIST}, "
              f"chamfer {TOL_CHAMFER}, emd {TOL_EMD})", flush=True)
        check(all(np.isfinite(list(result.values()))), "eval_pair: non-finite result")
        check(diffs["dpdist"] <= TOL_DIST and diffs["chamfer"] <= TOL_CHAMFER
              and diffs["emd"] <= TOL_EMD, "eval_pair: kernel path vs plain path")
        # The golden np = 256 pairs' chamfer and EMD on the card.
        with torch.no_grad():
            g_chamfer = [float(chamfer_distance(gA_large[i:i + 1], gB_large[i:i + 1]))
                         for i in range(gA_large.shape[0])]
            g_emd = sinkhorn_emd(gA_large, gB_large).cpu().numpy()
        err_c = float(np.abs(np.asarray(g_chamfer) - np.asarray(large["chamfer"])).max())
        err_e = float(np.abs(g_emd - np.asarray(large["emd"])).max())
        print(f"golden np={NP_LARGE} pairs vs JAX: chamfer max |d| = {err_c:.3e} (tol "
              f"{TOL_CHAMFER}), EMD max |d| = {err_e:.3e} (tol {TOL_EMD})", flush=True)
        check(err_c <= TOL_CHAMFER and err_e <= TOL_EMD, "golden chamfer / EMD")
        del plain
        # End to end (checkpoint load, file parse, the three keys), host
        # clock, warm.
        walls = []
        for _ in range(3):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                eval_pair.main(eval_args)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        eval_e2e_ms = statistics.median(walls) * 1e3

    def push_off_grid(clouds):
        """A copy with OFF_GRID_SHARE of each cloud's points (the first one
        at least) moved far outside the grid."""
        out = clouds.clone()
        far = torch.as_tensor(rng.random(out.shape[:2]) < OFF_GRID_SHARE, device=dev)
        far[:, 0] = True
        out[far] = FAR
        return out

    def ff_inputs(a, b, off_grid):
        """Row 9's inputs for one request, as the "full" route builds them:
        the bf16 volumes [A; B] and the queries [B; A] (pushed partly off
        the grid if asked)."""
        with torch.no_grad():
            fv2 = torch.cat([threedmfv(a, G, SIGMA), threedmfv(b, G, SIGMA)]).to(torch.bfloat16)
        q2 = torch.cat([b, a])
        if off_grid:
            q2 = push_off_grid(q2)
        vox2, mask2, delta2 = voxel_assign(q2, GRID)
        return fv2, vox2, mask2, delta2

    cfg0, np_params0 = load_dpdist_checkpoint(str(ROOT / NETS[0]))
    params0 = params_from_jax(np_params0, dev)
    packed0 = pack_decoder(params0["decoder"]["layers"])

    def fused_forward_f64(fv2, vox2, delta2, packed):
        """fused_forward_plain's rounding points with float64 sums: the
        yardstick for how far float32 summation moves the outputs. The
        pack holds each W as W^T, padded with zeros."""
        x = torch.cat([table_gather_plain(fv2.float(), vox2, GRID, K).double(),
                       delta2.to(torch.bfloat16).double()], -1)
        h = torch.relu(x @ packed.w[0][:, :packed.in_dim].double().t() + packed.b[0].double())
        for w_, b_ in zip(packed.w[1:], packed.b[1:]):
            h = torch.relu(h.to(torch.bfloat16).double() @ w_.double().t() + b_.double())
        return h.to(torch.bfloat16).double() @ packed.w_out.t().double() + packed.b_out.double()

    with Phase("fused_forward_kernel"):
        err_ff = 0.0
        for reqs in (requests, requests_large):
            fv2, vox2, mask2, delta2 = ff_inputs(*reqs[0], off_grid=True)
            with torch.no_grad():
                y = fused_forward(fv2, vox2, delta2, packed0, GRID, K)
                torch.cuda.synchronize()
                y_ref = fused_forward_plain(fv2, vox2, delta2, packed0, GRID, K)
                y64 = fused_forward_f64(fv2, vox2, delta2, packed0)
            n_q = vox2.shape[1]
            check(y.shape == (2 * B_SERVE, n_q, 3), f"fused_forward shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), "fused_forward has non-finite values")
            err = float((y - y_ref).abs().max())
            err_ff = max(err_ff, err)
            inside = mask2 > 0
            vs64 = {k_: ((v_.double() - y64).abs()[inside].max().item(),
                         (v_.double() - y64).abs()[~inside].max().item())
                    for k_, v_ in (("kernel", y), ("plain", y_ref))}
            print(f"fused_forward vs plain at 2B={2 * B_SERVE}, N={n_q} ({NETS[0]}): max |dy| = "
                  f"{err:.3e} (tol {TOL_FF}; max |y| {float(y_ref.abs().max()):.2f}), "
                  f"{int((~inside).sum())} off-grid queries; against float64 sums (in-grid, "
                  f"off-grid rows): kernel {vs64['kernel'][0]:.3e}, {vs64['kernel'][1]:.3e}; "
                  f"plain {vs64['plain'][0]:.3e}, {vs64['plain'][1]:.3e}", flush=True)
            check(err <= TOL_FF, f"fused_forward: max |dy| {err} > {TOL_FF}")
            del y, y_ref, y64

    with Phase("gather_fused_kernel"):
        a, b = requests[0]
        fv10 = threedmfv(a, G, SIGMA).detach()
        vox10, mask10, _ = voxel_assign(push_off_grid(b), GRID)
        with torch.no_grad():
            out10 = gather_patches_fused(fv10, vox10, mask10, GRID, K)
            torch.cuda.synchronize()
            ref10 = gather_patches_fused_plain(fv10, vox10, mask10, GRID, K)
        err_g10 = float((out10 - ref10).abs().max())
        check(torch.equal(out10, ref10), f"gather_patches_fused differs from its plain version "
              f"({err_g10})")
        grad10 = torch.as_tensor(rng.normal(size=out10.shape).astype(np.float32), device=dev)
        dfvs = []
        for fn in (gather_patches_fused, gather_patches_fused_plain):
            f = fv10.clone().requires_grad_()
            dfvs.append(torch.autograd.grad(fn(f, vox10, mask10, GRID, K), f, grad10)[0])
        err_g10_bwd = float((dfvs[0] - dfvs[1]).abs().max())
        tol_g10_bwd = REL_BWD * float(dfvs[1].abs().max())
        print(f"gather_patches_fused vs plain at B={B_SERVE}, N={NP}: equal, "
              f"{int((mask10 == 0).sum())} off-grid queries; backward (adjoint on the masked "
              f"grad) vs autograd: max |d dfv| = {err_g10_bwd:.3e} (tol {tol_g10_bwd:.3e})",
              flush=True)
        check(err_g10_bwd <= tol_g10_bwd, "gather_patches_fused backward vs autograd")
        del out10, ref10, grad10, dfvs

    with Phase("bf16_kernels"):
        # The main path's shapes: row 1 over the np = 64 2B stack, row 2 on
        # a request's queries, row 6 at np = 256.
        bf = torch.bfloat16
        aL, bL = requests_large[0]
        fvL6 = threedmfv(aL, G, SIGMA).detach()
        voxL6 = voxel_assign(push_off_grid(bL), GRID)[0]
        with torch.no_grad():
            pairs = {
                "mfv_gather_x": (mfv_x(pts, q, G, SIGMA, GRID, K, dtype=bf)[0],
                                 mfv_x(pts, q, G, SIGMA, GRID, K)[0]),
                "table_gather_x": (table_gather_x(fv, b, GRID, K, dtype=bf)[0],
                                   table_gather_x(fv, b, GRID, K)[0]),
                "table_gather": (table_gather(fvL6, voxL6, GRID, K, dtype=bf),
                                 table_gather(fvL6, voxL6, GRID, K)),
            }
        torch.cuda.synchronize()
        bf16_equal = {}
        for name_, (got, f32) in pairs.items():
            rounded = f32.to(bf)
            # One bf16 ulp of the rounded value: 2^(exponent - 7).
            ulp = torch.ldexp(torch.ones_like(f32), torch.frexp(rounded.float())[1] - 8)
            off = ((got.float() - rounded.float()).abs() > ulp).sum()
            bf16_equal[name_] = bool(torch.equal(got, rounded))
            print(f"{name_} bf16 output vs its float32 output rounded: equal "
                  f"{bf16_equal[name_]}, entries beyond one ulp {int(off)}", flush=True)
            check(got.dtype == bf and int(off) == 0, f"{name_}: bf16 output off by > 1 ulp")
        del pairs

    def serve_bf16(reqs, n_key, clouds, want):
        """Per committed net, "full" and "auto" in bf16: the requests,
        counted; the golden pairs against the JAX bf16 and float32 values;
        "full" against "auto"; off-grid queries exactly 0."""
        n_points = reqs[0][0].shape[1]
        f32_gold = golden if n_points == golden["num_point"] else large
        for net in NETS:
            outs, gold = {}, {}
            for mode in ("full", "auto"):
                model = load_frozen_distance(str(ROOT / net), device=dev, dtype="bfloat16",
                                             fused_gather=mode)
                start_count()
                with torch.no_grad():
                    outs[mode] = [model(a, b) for a, b in reqs]
                launched = read_count()
                print(f"{net} bf16 {mode}: {REQUESTS} requests of {B_SERVE} pairs at "
                      f"np={n_points}, kernel launches {launched}", flush=True)
                check(launched == want[mode], f"{net} bf16 {mode}: unexpected launches")
                for out in outs[mode]:
                    check(out.shape == (B_SERVE,) and bool(torch.isfinite(out).all()),
                          "bf16: non-finite distance or wrong shape")
                    check(float(out.min()) >= 0.0 and float(out.max()) <= 2.0,
                          "bf16: distance outside [0, 2]")
                with torch.no_grad():
                    gold[mode] = model(*clouds).cpu().numpy()
                    a, b = reqs[0]
                    b_off = push_off_grid(b)
                    pred_AB, _ = apply_dpdist(model.params(), model.cfg, a, b_off)
                off_mask = voxel_assign(b_off, GRID)[1] == 0
                check(bool((pred_AB[off_mask] == 0).all()), f"bf16 {mode}: off-grid queries "
                      f"not exactly 0")
                err_g = float(np.abs(gold[mode] - np.asarray(golden["bf16"][mode][n_key][net]))
                              .max())
                err_f32 = float(np.abs(gold[mode] - np.asarray(f32_gold["distance"][net])).max())
                print(f"{net} bf16 {mode} at np={n_points}: vs JAX golden bf16 max |d| = "
                      f"{err_g:.3e} (tol {TOL_BF16}); vs float32 golden max |d| = {err_f32:.3e} "
                      f"(tol {TOL_BF16_VS_F32}); {int(off_mask.sum())} off-grid queries "
                      f"exactly 0", flush=True)
                check(err_g <= TOL_BF16, f"{net} bf16 {mode}: vs golden {err_g}")
                check(err_f32 <= TOL_BF16_VS_F32, f"{net} bf16 {mode}: vs float32 {err_f32}")
            err_fc = max(float((f - c).abs().max()) for f, c in zip(outs["full"], outs["auto"]))
            print(f"{net} bf16 at np={n_points}: full vs auto max |d| = {err_fc:.3e} (tol "
                  f"{TOL_BF16})", flush=True)
            check(err_fc <= TOL_BF16, f"{net}: bf16 full vs auto {err_fc}")

    with Phase("serving_bf16"):
        serve_bf16(requests, "np64", (gA, gB),
                   {"full": expected(fused_forward=REQUESTS),
                    "auto": expected(mfv_gather_x=REQUESTS)})
        serve_bf16(requests_large, "np256", (gA_large, gB_large),
                   {"full": expected(threedmfv=2 * REQUESTS, fused_forward=REQUESTS),
                    "auto": expected(threedmfv=2 * REQUESTS, table_gather=2 * REQUESTS)})

    with Phase("serving_on"):
        for reqs, section, clouds, enc in ((requests, golden, (gA, gB), 0),
                                           (requests_large, large, (gA_large, gB_large),
                                            2 * REQUESTS)):
            for net in NETS:
                model = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="on")
                plain = load_frozen_distance(str(ROOT / net), device=dev, fused_gather="off")
                start_count()
                with torch.no_grad():
                    outs = [model(a, b) for a, b in reqs]
                launched = read_count()
                print(f"{net} on: {REQUESTS} requests at np={reqs[0][0].shape[1]}, kernel "
                      f"launches {launched}", flush=True)
                check(launched == expected(gather_patches_fused=2 * REQUESTS, threedmfv=enc),
                      f"{net} on: unexpected launches")
                with torch.no_grad():
                    err_plain = max(float((o - plain(a, b)).abs().max())
                                    for o, (a, b) in zip(outs, reqs))
                    got_golden = model(*clouds).cpu().numpy()
                err_golden = float(np.abs(got_golden - np.asarray(section["distance"][net])).max())
                print(f"{net} on: vs plain path max |d| = {err_plain:.3e}; vs JAX golden max "
                      f"|d| = {err_golden:.3e} (tol {TOL_DIST})", flush=True)
                check(err_plain <= TOL_DIST and err_golden <= TOL_DIST, f"{net} on: distances")

    with Phase("frozen_grad_on"):
        frozen_grad(requests, golden, (gA, gB),
                    expected(gather_patches_fused=2 * REQUESTS, table_gather_bwd=REQUESTS), 0,
                    ("table",), mode="on")
        frozen_grad(requests_large, large, (gA_large, gB_large),
                    expected(threedmfv=2 * REQUESTS, gather_patches_fused=2 * REQUESTS,
                             table_gather_bwd=REQUESTS), REQUESTS, ("table",), mode="on")

    with Phase("route_limits"):
        # Configs past the fused kernels' limits, which the route sends
        # elsewhere: the committed decoder at embedding_size=1000 (the mfv
        # kernel takes at most 992 Gaussians; the decoder's input is
        # 3 + k^3 * 20 wide whatever the grid), f32 and bf16 "auto" and bf16
        # "full", and a bf16 "full" net with hidden widths 40 (the fused
        # forward takes multiples of 16). Each serves the first np = 64
        # request through the route's kernels and matches the plain path.
        a, b = requests[0]
        cfg40 = DPDistConfig(mlp=(40, 40, 40))
        params40 = init_dpdist(cfg40, generator=torch.Generator().manual_seed(40), device=dev)

        def at_1000(over):
            return load_frozen_distance(str(ROOT / NETS[0]), device=dev, embedding_size=1000,
                                        **over)

        def net_40(over):
            return FrozenDistance(cfg40.replace(**over), params40).eval()

        bf16_full = {"dtype": "bfloat16", "fused_gather": "full"}
        for what, make, over, want, tol in (
                ("embedding_size=1000, f32", at_1000, {}, expected(table_gather_x=2), TOL_DIST),
                ("embedding_size=1000, bf16 auto", at_1000, {"dtype": "bfloat16"},
                 expected(table_gather_x=2), TOL_BF16),
                ("embedding_size=1000, bf16 full", at_1000, bf16_full,
                 expected(fused_forward=1), TOL_BF16),
                ("mlp=(40, 40, 40), bf16 full", net_40, bf16_full, expected(table_gather_x=2),
                 TOL_BF16)):
            model, plain = make(over), make({**over, "fused_gather": "off"})
            start_count()
            with torch.no_grad():
                d = model(a, b)
            launched = read_count()
            with torch.no_grad():
                err = float((d - plain(a, b)).abs().max())
            print(f"{what}: route {route_of(model.cfg, 'cuda', NP, NP)}, kernel launches "
                  f"{ {k: v for k, v in launched.items() if v} }; vs plain path max |d| = "
                  f"{err:.3e} (tol {tol})", flush=True)
            check(launched == want, f"{what}: unexpected launches")
            check(d.shape == (B_SERVE,) and bool(torch.isfinite(d).all()), f"{what}: output")
            check(err <= tol, f"{what}: kernel path vs plain path {err}")
        del model, plain, params40

    with Phase("times"):
        records = []
        B, N, V, E = B_SERVE, NP, G, K ** 3 * C
        # Rows 2 and 3 are timed on the queries the frozen loss hands them:
        # pcB of the first request, the AB direction, whose surface(A) is
        # the one that needs dfv. The clouds lie inside the grid.
        a, b = requests[0]
        with torch.no_grad():
            x, vox = table_gather_x(fv, b, GRID, K)
        # Neighbour rows of each (query, offset) for the library calls,
        # built outside the timed region.
        rows_idx, inside = neighbour_rows(torch, vox, V)
        fv_pad = torch.cat([fv, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
        grad_rows = torch.as_tensor(rng.normal(size=(B, N, 3 + E)).astype(np.float32),
                                    device=dev)
        grad_patch = grad_rows[..., 3:]
        src_rows = grad_patch.reshape(-1, C).contiguous()
        sink = torch.zeros(B * (V + 1), C, device=dev)
        # The cells some query's window reaches: the part of fv row 2 must read.
        reached = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
        reached[rows_idx] = True
        n_reached = int(reached.view(B, V + 1)[:, :V].sum())
        # The library calls compute the kernels' functions (checked once here).
        check(torch.equal(fv_pad.index_select(0, rows_idx).view(B, N, E), x[..., 3:]),
              "index_select does not reproduce table_gather_x's patches")
        lib_dfv = sink.zero_().index_add_(0, rows_idx, src_rows).view(B, V + 1, C)[:, :V]
        dfv_t = table_gather_bwd(vox, grad_patch, GRID, K)
        err_lib = float((lib_dfv - dfv_t).abs().max())
        check(err_lib <= REL_BWD * float(lib_dfv.abs().max()),
              f"index_add_ does not reproduce table_gather_bwd ({err_lib})")
        check(torch.equal(dfv_t, table_gather_bwd_ordered(vox, grad_patch, GRID, K)),
              "table_gather_bwd differs from the ordered plain sum on the timed inputs")
        del dfv_t
        print(f"timed inputs: {B} clouds x {N} queries, {int((~inside).sum())} of "
              f"{inside.numel()} (query, offset) windows off the grid, {n_reached} of {B * V} "
              f"cells reached", flush=True)

        with torch.no_grad():
            ms = cuda_median_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K))
            plain_ms = cuda_median_ms(lambda: mfv_x_plain(pts, q, G, SIGMA, GRID, K))
            # points, queries and two grid tables in; x and vox out; ~40 float32
            # operations per (point, Gaussian) pair in the encode.
            b_ms, b_by = bound(4 * (B_KERNEL * NP * 6 + 2 * G * 3
                                    + B_KERNEL * NP * (3 + E) + B_KERNEL * NP),
                               40 * B_KERNEL * NP * G)
            dev_ms = device_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K), "mfv_gather_x_kernel<float")
            # The bf16 output: x in half the bytes.
            ms_bf = cuda_median_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K, dtype=bf))
            dev_bf = device_ms(lambda: mfv_x(pts, q, G, SIGMA, GRID, K, dtype=bf),
                               "mfv_gather_x_kernel<__nv_bfloat16")
            b_bf, _ = bound(4 * (B_KERNEL * NP * 6 + 2 * G * 3 + B_KERNEL * NP)
                            + 2 * B_KERNEL * NP * (3 + E), 40 * B_KERNEL * NP * G)
            # N = 128, the most the route sends to row 1: 2B clouds of 128
            # points and 128 queries (inputs of their own, so that the
            # other phases' draws stay as they were).
            N1 = 2 * NP
            r128 = np.random.default_rng(128)
            p128 = torch.as_tensor(r128.uniform(-0.95, 0.95, (B_KERNEL, N1, 3)).astype(np.float32),
                                   device=dev)
            q128 = torch.as_tensor(r128.uniform(-1.2, 1.2, (B_KERNEL, N1, 3)).astype(np.float32),
                                   device=dev)
            x128, vox128 = mfv_x(p128, q128, G, SIGMA, GRID, K)
            x128_ref, vox128_ref = mfv_x_plain(p128, q128, G, SIGMA, GRID, K)
            err128 = float((x128 - x128_ref).abs().max())
            check(err128 <= TOL_X and torch.equal(vox128, vox128_ref),
                  f"mfv_x at N={N1}: max |dx| {err128} > {TOL_X} or vox differs")
            del x128, x128_ref, vox128, vox128_ref
            ms128 = cuda_median_ms(lambda: mfv_x(p128, q128, G, SIGMA, GRID, K))
            dev128 = device_ms(lambda: mfv_x(p128, q128, G, SIGMA, GRID, K),
                               "mfv_gather_x_kernel<float")
            b128, _ = bound(4 * (B_KERNEL * N1 * 6 + 2 * G * 3 + B_KERNEL * N1 * (3 + E)
                                 + B_KERNEL * N1), 40 * B_KERNEL * N1 * G)
            records.append({"name": "mfv_gather_x", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/mfv_gather.cu",
                            "replaces": "dpdist_tpu/kernels/mfv_gather_pallas.py:209",
                            "launches": launches["mfv_gather_x"], "max_abs_err": err_mfv,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None, "device_ms": dev_ms,
                            "bf16": {"ms": ms_bf, "device_ms": dev_bf, "bound_ms": b_bf},
                            f"n{N1}": {"ms": ms128, "device_ms": dev128, "bound_ms": b128,
                                       "max_abs_err": err128}})
            print(f"mfv_gather_x with a bf16 output: {ms_bf:.4f} ms, {dev_bf:.4f} ms on the "
                  f"device; bound {b_bf:.4f} ms = {b_bf / ms_bf:.1%} / {b_bf / dev_bf:.1%} of "
                  f"bound; on {card}", flush=True)
            print(f"mfv_gather_x at 2B={B_KERNEL}, M=N={N1}: {ms128:.4f} ms, {dev128:.4f} ms on "
                  f"the device; bound {b128:.4f} ms = {b128 / ms128:.1%} / {b128 / dev128:.1%} "
                  f"of bound; max |dx| {err128:.3e} (tol {TOL_X}), vox equal; on {card}",
                  flush=True)
            del p128, q128

            ms = cuda_median_ms(lambda: table_gather_x(fv, b, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_x_plain(fv, b, GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad.index_select(0, rows_idx))
            # The reached cells of fv, queries and centres in; x and vox out;
            # no arithmetic but q - centre.
            b_ms, b_by = bound(4 * (n_reached * C + B * N * 3 + V * 3 + B * N * (3 + E) + B * N),
                               3 * B * N)
            dev_ms = device_ms(lambda: table_gather_x(fv, b, GRID, K), "table_gather_x_kernel<float")
            # The bf16 output: x in half the bytes.
            ms_bf = cuda_median_ms(lambda: table_gather_x(fv, b, GRID, K, dtype=bf))
            dev_bf = device_ms(lambda: table_gather_x(fv, b, GRID, K, dtype=bf),
                               "table_gather_x_kernel<__nv_bfloat16")
            b_bf, _ = bound(4 * (n_reached * C + B * N * 3 + V * 3 + B * N) + 2 * B * N * (3 + E),
                            3 * B * N)
            records.append({"name": "table_gather_x", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:539",
                            "launches": launches["table_gather_x"], "max_abs_err": err_tgx,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            "bf16": {"ms": ms_bf, "device_ms": dev_bf, "bound_ms": b_bf}})
            print(f"table_gather_x with a bf16 output: {ms_bf:.4f} ms, {dev_bf:.4f} ms on the "
                  f"device; bound {b_bf:.4f} ms = {b_bf / ms_bf:.1%} / {b_bf / dev_bf:.1%} of "
                  f"bound; on {card}", flush=True)

            ms = cuda_median_ms(lambda: table_gather_bwd(vox, grad_patch, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_bwd_plain(vox, grad_patch, GRID, K))
            lib_ms = cuda_median_ms(lambda: sink.zero_().index_add_(0, rows_idx, src_rows))
            # The grad entries of in-grid (query, offset) windows and vox in,
            # dfv out; one add per such entry.
            adds = int(inside.sum()) * C
            b_ms, b_by = bound(4 * (adds + B * N + B * V * C), adds)
            dev_ms = device_ms(lambda: table_gather_bwd(vox, grad_patch, GRID, K),
                               "table_gather_bwd_kernel")
            records.append({"name": "table_gather_bwd", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:237",
                            "launches": launches["table_gather_bwd"], "max_abs_err": err_bwd,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            # Rows 4 and 5: the same adjoint in two TPU lane layouts.
                            "covers": ["dpdist_tpu/kernels/table_gather_pallas.py:379",
                                       "dpdist_tpu/kernels/table_gather_pallas.py:425"]})

            # Rows 7 and 6 on the np = 256 path's inputs: pcA of the first
            # large request is encoded, and pcB queries that surface.
            aL, bL = requests_large[0]
            NL = NP_LARGE
            fvL = threedmfv_kernel(aL, G, SIGMA)
            ms = cuda_median_ms(lambda: threedmfv_kernel(aL, G, SIGMA))
            plain_ms = cuda_median_ms(lambda: threedmfv_plain(aL, G, SIGMA))
            # Points and Gaussian centres in, the volumes out.
            b_ms, b_by = bound(4 * (B * NL * 3 + G * 3 + B * G * C),
                               ENCODE_OPS_PER_PAIR * B * NL * G)
            records.append({"name": "threedmfv", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/threedmfv.cu",
                            "replaces": "dpdist_tpu/kernels/threedmfv_pallas.py:192",
                            "launches": launches["threedmfv"], "max_abs_err": err_enc,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": None})
            # The crossover against the plain encode, and eval_pair's one
            # large cloud (one block on one SM).
            for cloud in (a, aL, eA):
                k_ms = cuda_median_ms(lambda: threedmfv_kernel(cloud, G, SIGMA))
                p_ms = cuda_median_ms(lambda: threedmfv_plain(cloud, G, SIGMA))
                print(f"encode at B={cloud.shape[0]}, N={cloud.shape[1]}: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms (kernel / plain = {k_ms / p_ms:.3f}); on {card}",
                      flush=True)

            voxL = voxel_assign(bL, GRID)[0]
            rows6, inside6 = neighbour_rows(torch, voxL, V)
            fv_pad6 = torch.cat([fvL, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
            reached6 = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
            reached6[rows6] = True
            n_reached6 = int(reached6.view(B, V + 1)[:, :V].sum())
            check(torch.equal(fv_pad6.index_select(0, rows6).view(B, NL, E),
                              table_gather(fvL, voxL, GRID, K)),
                  "index_select does not reproduce table_gather")
            print(f"row 6 timed inputs: {B} clouds x {NL} queries, {int((~inside6).sum())} of "
                  f"{inside6.numel()} windows off the grid, {n_reached6} of {B * V} cells "
                  f"reached", flush=True)
            ms = cuda_median_ms(lambda: table_gather(fvL, voxL, GRID, K))
            plain_ms = cuda_median_ms(lambda: table_gather_plain(fvL, voxL, GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad6.index_select(0, rows6))
            # The reached cells of fv and vox in, the patch rows out; no arithmetic.
            b_ms, b_by = bound(4 * (n_reached6 * C + B * NL + B * NL * E), 0)
            dev_ms = device_ms(lambda: table_gather(fvL, voxL, GRID, K), "table_gather_kernel<float")
            records.append({"name": "table_gather", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/table_gather.cu",
                            "replaces": "dpdist_tpu/kernels/table_gather_pallas.py:106",
                            "launches": launches["table_gather"], "max_abs_err": err_tg6,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms})

            # Row 3 at N = 256 on the np = 256 frozen loss's inputs: pcB's
            # voxels, and a contiguous grad as row 6's backward hands it.
            gradL = torch.as_tensor(rng.normal(size=(B, NL, E)).astype(np.float32), device=dev)
            srcL = gradL.reshape(-1, C)
            sinkL = torch.zeros(B * (V + 1), C, device=dev)
            # Against float64 sums: two float32 orders of up to 4x as many
            # terms a slot as at N = 64 differ by up to ~8e-7 of the largest
            # entry; each alone strays from the exact sum by less.
            dfvL = table_gather_bwd(voxL, gradL, GRID, K)
            refL = table_gather_bwd_plain(voxL, gradL.double(), GRID, K)
            libL = sinkL.zero_().index_add_(0, rows6, srcL).view(B, V + 1, C)[:, :V]
            tolL = REL_BWD * float(refL.abs().max())
            errL = float((dfvL.double() - refL).abs().max())
            check(errL <= tolL, f"table_gather_bwd at N={NL}: max |d dfv| {errL} > {tolL}")
            check(float((libL.double() - refL).abs().max()) <= tolL,
                  f"index_add_ does not compute table_gather_bwd's function at N={NL}")
            check(torch.equal(dfvL, table_gather_bwd_ordered(voxL, gradL, GRID, K)),
                  f"table_gather_bwd at N={NL} differs from the ordered plain sum")
            del refL, libL
            msL = cuda_median_ms(lambda: table_gather_bwd(voxL, gradL, GRID, K))
            devL = device_ms(lambda: table_gather_bwd(voxL, gradL, GRID, K),
                             "table_gather_bwd_kernel")
            libL_ms = cuda_median_ms(lambda: sinkL.zero_().index_add_(0, rows6, srcL))
            addsL = int(inside6.sum()) * C
            bnd_L, _ = bound(4 * (addsL + B * NL + B * V * C), addsL)
            next(r for r in records if r["name"] == "table_gather_bwd")[f"n{NL}"] = {
                "ms": msL, "device_ms": devL, "bound_ms": bnd_L, "library_ms": libL_ms,
                "max_abs_err": errL}
            print(f"table_gather_bwd at B={B}, N={NL} (contiguous grad): {msL:.4f} ms, "
                  f"{devL:.4f} ms on the device; bound {bnd_L:.4f} ms = {bnd_L / msL:.1%} / "
                  f"{bnd_L / devL:.1%} of bound; index_add_ {libL_ms:.4f} ms; max |d dfv| "
                  f"{errL:.3e} from float64 sums (tol {tolL:.3e}), equal to the ordered plain "
                  f"sum; on {card}",
                  flush=True)
            del fv_pad6, reached6, rows6, gradL, srcL, sinkL, dfvL

            # Row 8 on eval_pair's clouds, one direction.
            NE = eA.shape[1]
            lib_nn = torch.cdist(eA, eB, compute_mode="donot_use_mm_for_euclid_dist").square()
            lib_nn = lib_nn.amin(-1)
            d_nn = nn_min_sqdist(eA, eB)
            check(bool(((lib_nn - d_nn).abs() <= TOL_NN_ABS + TOL_NN_REL * d_nn.abs()).all()),
                  "torch.cdist does not reproduce nn_min_sqdist")
            ms = cuda_median_ms(lambda: nn_min_sqdist(eA, eB))
            plain_ms = cuda_median_ms(lambda: nn_min_sqdist_plain(eA, eB))
            lib_ms = cuda_median_ms(lambda: torch.cdist(
                eA, eB, compute_mode="donot_use_mm_for_euclid_dist").square().amin(-1))
            # Both clouds in, the minima out.
            b_ms, b_by = bound(4 * (NE * 3 + eB.shape[1] * 3 + NE),
                               NN_OPS_PER_PAIR * NE * eB.shape[1])
            dev_ms = device_ms(lambda: nn_min_sqdist(eA, eB), "nn_min_kernel")
            # The issue slots the per-dimension form needs, at the card's
            # top SM clock (a lower clock under load would lower the floor).
            sm_hz = 1e6 * float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
            sms = torch.cuda.get_device_properties(dev).multi_processor_count

            def issue_floor_ms(pairs):
                return pairs * NN_INSTRUCTIONS_PER_PAIR / 32 / (4 * sms) / sm_hz * 1e3

            floor_ms = issue_floor_ms(NE * eB.shape[1])
            loop = sass_loop_counts(lib_path, "nn_min_kernel")
            print(f"nn_min_kernel's inner loop in SASS: {loop}; "
                  f"{sum(loop.values()) / loop['FMNMX']:.2f} instructions a pair", flush=True)
            records.append({"name": "nn_min_sqdist", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/chamfer.cu",
                            "replaces": "dpdist_tpu/kernels/chamfer_pallas.py:74",
                            "launches": launches["nn_min_sqdist"], "max_abs_err": err_nn,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms,
                            "issue_floor_ms": floor_ms})
            print(f"nn_min_sqdist at B=1, N=M={NE}: {dev_ms:.4f} ms on the device, one launch "
                  f"({nn_plan(1, NE, eB.shape[1])}); the issue-slot floor of the per-dimension "
                  f"form ({NN_INSTRUCTIONS_PER_PAIR} instructions a pair, {sms} SMs at "
                  f"{sm_hz / 1e6:.0f} MHz) {floor_ms:.4f} ms = {floor_ms / dev_ms:.1%} of it; "
                  f"the two-kernel design before it read 0.0452 / 0.0448 ms (PERF.md); "
                  f"cdist {lib_ms:.4f} ms; on {card}", flush=True)
            del lib_nn, d_nn
            # The NN-min at the other shapes of its checks: eval and device times.
            for B_, N_, M_ in ((2, 1000, 4099), (256, 64, 64)):
                a_, p_ = (torch.as_tensor(np.random.default_rng(N_).uniform(
                    -1.0, 1.0, (B_, n, 3)).astype(np.float32), device=dev) for n in (N_, M_))
                ms_ = cuda_median_ms(lambda: nn_min_sqdist(a_, p_))
                dev_ = device_ms(lambda: nn_min_sqdist(a_, p_), "nn_min_kernel")
                next(r for r in records if r["name"] == "nn_min_sqdist")[f"B{B_}_N{N_}_M{M_}"] = {
                    "ms": ms_, "device_ms": dev_, "issue_floor_ms": issue_floor_ms(B_ * N_ * M_)}
                print(f"nn_min_sqdist at B={B_}, N={N_}, M={M_}: {ms_:.4f} ms, {dev_:.4f} ms on "
                      f"the device ({nn_plan(B_, N_, M_)}); issue-slot floor "
                      f"{issue_floor_ms(B_ * N_ * M_):.4f} ms; on {card}", flush=True)
            del a_, p_

            # Row 9 on the first np = 64 request as the "full" route builds
            # it (2B = 512 clouds, all queries inside the grid).
            fv2, vox2, _, delta2 = ff_inputs(a, b, off_grid=False)
            rows9 = vox2.numel()
            layers_bf = [{k_: t.to(torch.bfloat16) for k_, t in lp.items()}
                         for lp in params0["decoder"]["layers"]]
            rows_idx9, _ = neighbour_rows(torch, vox2, V)
            fv_pad9 = torch.cat([fv2, torch.zeros(2 * B, 1, C, dtype=torch.bfloat16, device=dev)],
                                1).reshape(-1, C)

            def composed_bf16():
                """The composed bf16 path over the same rows: index_select
                gathers the patches, cuBLAS runs the decoder (a composition
                of library calls, not one call)."""
                x9 = torch.cat([delta2.to(torch.bfloat16),
                                fv_pad9.index_select(0, rows_idx9).view(2 * B, N, E)], -1)
                return mlp_apply({"layers": layers_bf}, x9, torch.bfloat16)

            y_lib = composed_bf16().float()
            y9 = fused_forward(fv2, vox2, delta2, packed0, GRID, K)
            print(f"row 9 timed inputs: {2 * B} clouds x {N} queries; the composed bf16 "
                  f"path's output vs the kernel's: max |dy| = "
                  f"{float((y_lib - y9).abs().max()):.3e} (it rounds each product to bf16 "
                  f"before the bias and the head's output)", flush=True)
            ms = cuda_median_ms(lambda: fused_forward(fv2, vox2, delta2, packed0, GRID, K))
            plain_ms = cuda_median_ms(lambda: fused_forward_plain(fv2, vox2, delta2, packed0,
                                                                  GRID, K))
            lib_ms = cuda_median_ms(composed_bf16)
            x9 = torch.cat([delta2.to(torch.bfloat16),
                            fv_pad9.index_select(0, rows_idx9).view(2 * B, N, E)], -1)
            dec_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_bf}, x9, torch.bfloat16))
            widths9 = [lp["w"].shape for lp in params0["decoder"]["layers"]]
            flops9 = 2 * rows9 * sum(i * o for i, o in widths9)
            # fv, vox and delta in, y out, the weights and biases once.
            bytes9 = (fv2.numel() * 2 + rows9 * (4 + 12 + 4 * 3)
                      + sum(i * o * 2 + o * 4 for i, o in widths9))
            b_ms, b_by = bound(bytes9, flops9, BF16_FLOP_PER_S)
            records.append({"name": "fused_forward", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/fused_forward.cu",
                            "replaces": "dpdist_tpu/kernels/fused_forward_pallas.py:121",
                            "launches": launches["fused_forward"], "max_abs_err": err_ff,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "library_is": "composition: index_select "
                            "gather + torch.matmul bf16 decoder (cuBLAS)"})
            print(f"row 9: {flops9 / 1e12:.4f} TFLOP over {rows9} rows, bound at the "
                  f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak (H100 SXM data "
                  f"sheet); the composed path's decoder "
                  f"alone (cuBLAS bf16) {dec_ms:.4f} ms = {flops9 / dec_ms / 1e9:.1f} TFLOP/s, "
                  f"the kernel {flops9 / ms / 1e9:.1f} TFLOP/s; on {card}", flush=True)
            # The same cuBLAS bf16 decoder with the first layer's K padded
            # with zeros to the pack's K (a yardstick only: the port never
            # runs it).
            k_pad = packed0.w[0].shape[1]
            x9_pad = torch.cat([x9, torch.zeros(*x9.shape[:-1], k_pad - x9.shape[-1],
                                                dtype=torch.bfloat16, device=dev)], -1)
            layers_pad = [{"w": torch.cat([layers_bf[0]["w"], torch.zeros(
                k_pad - layers_bf[0]["w"].shape[0], layers_bf[0]["w"].shape[1],
                dtype=torch.bfloat16, device=dev)]), "b": layers_bf[0]["b"]}] + layers_bf[1:]
            dec_pad_ms = cuda_median_ms(lambda: mlp_apply({"layers": layers_pad}, x9_pad,
                                                          torch.bfloat16))
            print(f"cuBLAS bf16 decoder with the first layer's K padded from {x9.shape[-1]} to "
                  f"{k_pad}: {dec_pad_ms:.4f} ms = {flops9 / dec_pad_ms / 1e9:.1f} TFLOP/s "
                  f"(unpadded {dec_ms:.4f} ms); on {card}", flush=True)
            # Row 9 at np = 256: the "full" route's 2B = 512 clouds of 256 queries.
            fv2L, vox2L, _, delta2L = ff_inputs(aL, bL, off_grid=False)
            rows9L = vox2L.numel()
            ms9L = cuda_median_ms(lambda: fused_forward(fv2L, vox2L, delta2L, packed0, GRID, K))
            flops9L = 2 * rows9L * sum(i * o for i, o in widths9)
            b9L, _ = bound(fv2L.numel() * 2 + rows9L * (4 + 12 + 4 * 3)
                           + sum(i * o * 2 + o * 4 for i, o in widths9), flops9L, BF16_FLOP_PER_S)
            print(f"row 9 at np={NL}: {ms9L:.4f} ms over {rows9L} rows = "
                  f"{flops9L / ms9L / 1e9:.1f} TFLOP/s, {b9L / ms9L:.1%} of its {b9L:.4f} ms "
                  f"bound; at np={N}: {ms:.4f} ms = {flops9 / ms / 1e9:.1f} TFLOP/s; on {card}",
                  flush=True)
            # Device time per CUDA kernel of rows 9 and 7 (a call of either
            # launches more than one): torch.profiler over 5 calls each.
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fused_forward(fv2, vox2, delta2, packed0, GRID, K)
                for cloud in (aL, eA):
                    for _ in range(5):
                        threedmfv_kernel(cloud, G, SIGMA)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if any(k_ in e.key for k_ in ("layer_kernel", "head_kernel", "partial_kernel",
                                              "merge_kernel")):
                    print(f"profiled kernel {e.key[:60]}: {e.count} launches, "
                          f"{e.self_device_time_total / e.count:.1f} us each (rows 9 at np={N}, 7 at B={B}, N={NL} "
                          f"and B=1, N={eA.shape[1]}); on {card}", flush=True)
            del x9, y_lib, y9, fv_pad9, rows_idx9, x9_pad, layers_pad, fv2L, vox2L, delta2L

            # Row 10 on the first np = 64 request: pcA's volumes, pcB's queries.
            fv10 = threedmfv(a, G, SIGMA).detach()
            vox10, mask10, _ = voxel_assign(b, GRID)
            nid = neighbor_ids(vox10, mask10, GRID, K).long()
            base10 = (torch.arange(B, device=dev) * (V + 1))[:, None, None]
            rows10 = (base10 + torch.where(nid >= 0, nid, torch.full_like(nid, V))).reshape(-1)
            fv_pad10 = torch.cat([fv10, torch.zeros(B, 1, C, device=dev)], 1).reshape(-1, C)
            check(torch.equal(fv_pad10.index_select(0, rows10).view(B, N, E),
                              gather_patches_fused(fv10, vox10, mask10, GRID, K)),
                  "index_select does not reproduce gather_patches_fused")
            reached10 = torch.zeros(B * (V + 1), dtype=torch.bool, device=dev)
            reached10[rows10] = True
            n_reached10 = int(reached10.view(B, V + 1)[:, :V].sum())
            ms = cuda_median_ms(lambda: gather_patches_fused(fv10, vox10, mask10, GRID, K))
            plain_ms = cuda_median_ms(lambda: gather_patches_fused_plain(fv10, vox10, mask10,
                                                                         GRID, K))
            lib_ms = cuda_median_ms(lambda: fv_pad10.index_select(0, rows10))
            # The reached cells of fv, vox and mask in, the patch rows out; no
            # arithmetic.
            b_ms, b_by = bound(4 * (n_reached10 * C + 2 * B * N + B * N * E), 0)
            dev_ms = device_ms(lambda: gather_patches_fused(fv10, vox10, mask10, GRID, K),
                               "gather_fused_kernel")
            records.append({"name": "gather_patches_fused", "route": "cuda",
                            "source": "dpdist_tpu_torch/csrc/gather_fused.cu",
                            "replaces": "dpdist_tpu/kernels/gather_pallas.py:137",
                            "launches": launches["gather_patches_fused"], "max_abs_err": err_g10,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms, "device_ms": dev_ms})
            del fv_pad10, rows10, reached10, nid

            # The bf16 outputs of rows 1, 2 and 6 beside their float32 times.
            bf = torch.bfloat16
            for name_, fn in (
                    ("mfv_gather_x", lambda: mfv_x(pts, q, G, SIGMA, GRID, K, dtype=bf)),
                    ("table_gather_x", lambda: table_gather_x(fv, b, GRID, K, dtype=bf)),
                    ("table_gather", lambda: table_gather(fvL, voxL, GRID, K, dtype=bf))):
                print(f"{name_} kernel with a bf16 output: {cuda_median_ms(fn):.4f} ms; on "
                      f"{card}", flush=True)

            for r in records:
                on_device = (f", {r['device_ms']:.4f} ms on the device = "
                             f"{r['bound_ms'] / r['device_ms']:.1%} of bound"
                             if "device_ms" in r else "")
                print(f"{r['name']} kernel: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}) = {r['bound_ms'] / r['ms']:.1%} of bound{on_device}; "
                      f"plain {r['plain_ms']:.4f} ms; library call {r['library_ms']} ms; "
                      f"main-path launches {r['launches']}; on {card}", flush=True)

            fwd_ms = cuda_median_ms(lambda: fwd_model(a, b))
        print(f"forward (mfv kernel path) at B={B_SERVE} pairs: {fwd_ms:.4f} ms, "
              f"{B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}", flush=True)
        cfg, np_params = load_dpdist_checkpoint(str(ROOT / NETS[-1]))
        params = params_from_jax(np_params, dev)
        for mode in ("table", "mfv"):
            loss_fn = make_frozen_dpdist_loss(params, cfg.replace(fused_gather=mode))
            step_ms = cuda_median_ms(lambda: src_grad(loss_fn, a, b))
            print(f"frozen source-gradient step ({mode} path) at B={B_SERVE} pairs: "
                  f"{step_ms:.4f} ms, {B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}",
                  flush=True)
        labels_t = torch.as_tensor(rng.uniform(0.0, 0.3, (B_SERVE, NP)).astype(np.float32),
                                   device=dev)

        def train_step():
            loss, grads = trainer.loss_and_grads(a, b, labels_t)
            trainer.opt_state = trainer.optimizer.step(trainer.params, grads, trainer.opt_state)

        step_ms = cuda_median_ms(train_step)
        print(f"train step (table path, Adam) at B={B_SERVE} pairs: {step_ms:.4f} ms, "
              f"{B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}", flush=True)

        with torch.no_grad():
            fwd_ms = cuda_median_ms(lambda: fwd_model_large(aL, bL))
        print(f"forward (encode + patch-only gather path) at B={B_SERVE} pairs, np={NL}: "
              f"{fwd_ms:.4f} ms, {B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}", flush=True)
        loss_fn = make_frozen_dpdist_loss(params, cfg)
        step_ms = cuda_median_ms(lambda: src_grad(loss_fn, aL, bL))
        print(f"frozen source-gradient step at B={B_SERVE} pairs, np={NL}: {step_ms:.4f} ms, "
              f"{B_SERVE / step_ms * 1e3:.1f} pairs/s; on {card}", flush=True)

        for reqs in (requests, requests_large):
            a_, b_ = reqs[0]
            for over in ({"dtype": "bfloat16", "fused_gather": "full"},
                         {"dtype": "bfloat16", "fused_gather": "auto"},
                         {"fused_gather": "on"}):
                model = load_frozen_distance(str(ROOT / NETS[-1]), device=dev, **over)
                with torch.no_grad():
                    fwd_ms = cuda_median_ms(lambda: model(a_, b_))
                print(f"forward ({over}) at B={B_SERVE} pairs, np={a_.shape[1]}: "
                      f"{fwd_ms:.4f} ms, {B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}",
                      flush=True)

        eval_model = load_frozen_distance(str(ROOT / NETS[0]), device=dev)
        with torch.no_grad():
            key_ms = {"dpdist": cuda_median_ms(lambda: eval_model(eA, eB), runs=5),
                      "chamfer": cuda_median_ms(lambda: chamfer_distance(eA, eB), runs=5),
                      "emd": cuda_median_ms(lambda: earth_mover_distance(eA, eB), runs=3,
                                            warmup=1)}
        print(f"eval_pair at {EVAL_POINTS} points: end to end {eval_e2e_ms:.1f} ms (host "
              f"clock, median of 3, checkpoint load and file parse included); per key "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in key_ms.items()) + f"; on {card}",
              flush=True)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
