#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the frozen DPDist distance served from the
committed nets, through its hand-written kernel, and checks it:

  1. device   the card's name and power limit; fails without CUDA.
  2. build    compiles dpdist_tpu_torch/csrc with one nvcc call.
  3. kernel   the fused 3DmFV + patch-gather kernel against its plain
              PyTorch version at 2B = 512 clouds, M = N = 64, with
              off-grid queries and points on cell edges (x within 2e-5,
              vox exact).
  4. serving  per committed net: three requests of B = 256 synthetic
              pairs through load_frozen_distance (launch counter reset
              before and read after), outputs finite and in [0, 2], the
              kernel path against the plain path (fused_gather="off")
              within 1e-4, and the golden pairs against the JAX values
              within 1e-4.
  5. times    CUDA-event medians of 20 runs after warm-up: the kernel, its
              bound, its plain version, and the whole forward at B = 256.

Every phase prints a start and an end line. A wall-clock guard ends the
run with a non-zero exit naming the phase. The last lines are the
kernels' JSON record, the nvidia-smi line, and the result line
{"ok": true, "device": {...}}, printed only when every phase passed.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TIME_LIMIT_S = 300
NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
B_SERVE = 256            # pairs per request
REQUESTS = 3
B_KERNEL = 2 * B_SERVE   # the 2B stacked clouds one forward hands the kernel
NP = 64                  # points per cloud (the committed nets' num_point)
TOL_X = 2e-5             # kernel vs plain: the encode sums in another order
TOL_DIST = 1e-4          # distances: kernel path vs plain path and vs JAX
TIMED_RUNS = 20
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): device
# memory rate and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

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


def make_kernel_inputs(rng, torch, dev):
    """Encoded clouds inside the grid with some coordinates exactly on cell
    edges; queries partly off-grid, with edges at -1, +1 and in between."""
    import numpy as np

    g = 8
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)  # -1 .. 1
    pts = rng.uniform(-0.95, 0.95, (B_KERNEL, NP, 3)).astype(np.float32)
    on_edge = rng.random(pts.shape) < 0.1
    pts[on_edge] = rng.choice(edges[1:-1], on_edge.sum())
    q = rng.uniform(-1.2, 1.2, (B_KERNEL, NP, 3)).astype(np.float32)
    on_edge = rng.random(q.shape) < 0.15
    q[on_edge] = rng.choice(edges, on_edge.sum())
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(q, device=dev))


def make_requests(rng, torch, dev):
    """REQUESTS batches of B_SERVE synthetic pairs (chair/box/sphere, x0.8)."""
    import numpy as np
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    fams = ("chair", "box", "sphere")
    reqs = []
    for r in range(REQUESTS):
        a, b = [], []
        for i in range(B_SERVE):
            seed = int(rng.integers(0, 2 ** 31 - 2))
            a.append(synthetic_surface(fams[i % 3], seed=seed, n_points=NP) * 0.8)
            b.append(synthetic_surface(fams[(i + r) % 3], seed=seed + 1, n_points=NP) * 0.8)
        reqs.append(tuple(torch.as_tensor(np.stack(x).astype(np.float32), device=dev)
                          for x in (a, b)))
    return reqs


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
        from dpdist_tpu_torch.kernels import build
        from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
        from dpdist_tpu_torch.data.golden import golden_clouds, load_golden
        from dpdist_tpu_torch.serving import load_frozen_distance

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
              f"(nvcc call: {build.build_seconds} s; None = found built)", flush=True)

    rng = np.random.default_rng(0)
    G, g, k, sigma = 512, 8, 5, 0.125
    with Phase("kernel"):
        pts, q = make_kernel_inputs(rng, torch, dev)
        with torch.no_grad():
            x, vox = mfv_x(pts, q, G, sigma, g, k)
            torch.cuda.synchronize()
            x_ref, vox_ref = mfv_x_plain(pts, q, G, sigma, g, k)
        check(x.shape == (B_KERNEL, NP, 3 + k ** 3 * 20), f"x shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), "x has non-finite values")
        max_err = float((x - x_ref).abs().max())
        vox_equal = bool(torch.equal(vox, vox_ref.to(torch.int32)))
        off_grid = int((vox_ref == 0).sum())
        print(f"kernel vs plain: max |dx| = {max_err:.3e} (tol {TOL_X}), vox equal: "
              f"{vox_equal}, queries in cell 0 (off-grid or cell 0): {off_grid}", flush=True)
        check(max_err <= TOL_X, f"max |dx| {max_err} > {TOL_X}")
        check(vox_equal, "vox differs from the plain version")

    launches_main = 0
    fwd_model = None
    with Phase("serving"):
        requests = make_requests(rng, torch, dev)
        golden = load_golden()
        gA, gB = (torch.as_tensor(a, device=dev) for a in golden_clouds(golden))
        for net in NETS:
            model = load_frozen_distance(str(ROOT / net))
            plain = load_frozen_distance(str(ROOT / net), fused_gather="off")
            mfv_x.launches = 0
            with torch.no_grad():
                outs = [model(a, b) for a, b in requests]
            torch.cuda.synchronize()
            launched = mfv_x.launches
            launches_main += launched
            print(f"{net}: {REQUESTS} requests of {B_SERVE} pairs, kernel launches "
                  f"{launched}", flush=True)
            check(launched == REQUESTS, f"{net}: expected {REQUESTS} kernel launches, "
                  f"counted {launched}")
            with torch.no_grad():
                refs = [plain(a, b) for a, b in requests]
                got_golden = model(gA, gB).cpu().numpy()
            for out in outs:
                check(out.shape == (B_SERVE,), f"output shape {tuple(out.shape)}")
                check(bool(torch.isfinite(out).all()), "non-finite distance")
                check(float(out.min()) >= 0.0 and float(out.max()) <= 2.0,
                      f"distance outside [0, 2]: {float(out.min())}..{float(out.max())}")
            err_plain = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
            err_golden = float(np.abs(got_golden - np.asarray(golden["distance"][net])).max())
            print(f"{net}: distances {float(outs[0].min()):.4f}..{float(outs[0].max()):.4f}; "
                  f"kernel path vs plain path max |d| = {err_plain:.3e}; vs JAX golden "
                  f"max |d| = {err_golden:.3e} (tol {TOL_DIST})", flush=True)
            check(err_plain <= TOL_DIST, f"{net}: kernel vs plain path {err_plain}")
            check(err_golden <= TOL_DIST, f"{net}: vs golden {err_golden}")
            fwd_model = model

    with Phase("times"):
        with torch.no_grad():
            ms = cuda_median_ms(lambda: mfv_x(pts, q, G, sigma, g, k))
            plain_ms = cuda_median_ms(lambda: mfv_x_plain(pts, q, G, sigma, g, k))
            a, b = requests[0]
            fwd_ms = cuda_median_ms(lambda: fwd_model(a, b))
        n_in = B_KERNEL * NP * 3 * 2 + 2 * G * 3          # points, queries, two grid tables
        n_out = B_KERNEL * NP * (3 + k ** 3 * 20) + B_KERNEL * NP   # x and vox
        bytes_moved = 4 * (n_in + n_out)
        # ~40 float32 operations per (point, Gaussian) pair: the logit, the
        # softmax normalisation and the 20 pooled channels.
        flops = 40 * B_KERNEL * NP * G
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"mfv_gather_x kernel: {ms:.4f} ms at 2B={B_KERNEL}, N=M={NP}; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {bytes_moved / 1e6:.1f} MB at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s) = {bound_ms / ms:.1%} of bound; plain "
              f"version {plain_ms:.4f} ms; on {card}", flush=True)
        print(f"forward (kernel path) at B={B_SERVE} pairs: {fwd_ms:.4f} ms, "
              f"{B_SERVE / fwd_ms * 1e3:.1f} pairs/s; on {card}", flush=True)

    record = {"kernels": [{
        "name": "mfv_gather_x",
        "route": "cuda",
        "source": "dpdist_tpu_torch/csrc/mfv_gather.cu",
        "replaces": "dpdist_tpu/kernels/mfv_gather_pallas.py:209",
        "launches": launches_main,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
