"""What the metric readers share (portbench/metrics/<metric>.py, each a
`read(run)` that returns a number, or None where its run holds nothing
to read). `run` is core.cell.Run.

Kernels are told apart by name. The port's (PERF.md's kernel table: rows
1, 2, 3, 6, 7) by their CUDA function names; the libraries' (cuBLAS's GEMMs, cuDNN's
convolutions) by the markers their names carry; PyTorch's own kernels
(at::native) belong to neither.
"""

from __future__ import annotations

import collections

import numpy as np

from portbench.core import counts

KERNELS = {
    "mfv_gather_x": ("mfv_gather_x_kernel<float",),
    "table_gather_x": ("table_gather_x_kernel<float",),
    "table_gather_bwd": ("table_gather_bwd_kernel",),
    "table_gather_rows": ("table_gather_rows_kernel<float",),
    "threedmfv": ("::partial_kernel<", "::merge_kernel("),
}
LIBRARY_MARKERS = ("gemm", "cublas", "cutlass", "xmma", "cudnn", "conv", "winograd", "fft",
                   "splitk", "nchw", "nhwc", "ncdhw", "ndhwc")


def is_library(name: str) -> bool:
    low = name.lower()
    return ("at::" not in name and any(m in low for m in LIBRARY_MARKERS)
            and not any(p in name for pats in KERNELS.values() for p in pats))


def rate(run) -> float:
    """Units completed per second over the whole window."""
    return run.driver.units_per_step * run.steps / run.elapsed_s


def p95_ms(run) -> float:
    """The 95th percentile of the steps' host time (call to answer on the host)."""
    return float(np.percentile(run.spans.seconds["step"], 95)) * 1e3


def host_ms(run):
    """Mean host ms of a call into the entry point, up to its return."""
    entry = run.spans.seconds.get("entry")
    return float(np.mean(entry)) * 1e3 if entry else None


def launches(run):
    """Kernel launch calls per step, from the trace's runtime and driver API records."""
    tr = run.trace
    return sum(tr.launches) / len(tr.steps) if tr.steps else None


def library_ms(run):
    """Device ms per step in cuBLAS and cuDNN kernels."""
    tr = run.trace
    ns = sum(k.dur for k in tr.kernels if k.dur > 0 and is_library(k.name))
    return ns * 1e-6 / len(tr.steps) if tr.steps and ns else None


def roofline(run, kernel: str):
    """The kernel's share of its roofline: the least time its work needs
    (bytes from shapes at 3.35 TB/s, operations at 67 TFLOP/s) over the
    device time its launches took. Only steps whose launches of the kernel
    all have device time, and as many of them as most steps have, count,
    on both sides; the others are counted in run.notes."""
    pats = KERNELS[kernel]
    by_step = collections.defaultdict(list)
    for k in run.trace.kernels:
        if k.step >= 0 and any(p in k.name for p in pats):
            by_step[k.step].append(k)
    if not by_step:
        return None
    expected = collections.Counter(len(v) for v in by_step.values()).most_common(1)[0][0]
    nbytes = flops = ns = counted = 0
    for step, ks in by_step.items():
        if len(ks) != expected or any(k.dur <= 0 for k in ks):
            continue
        work = run.driver.kernel_work(kernel, step)
        if work is None:
            return None
        nbytes, flops, ns = nbytes + work[0], flops + work[1], ns + sum(k.dur for k in ks)
        counted += 1
    run.notes.append(f"{kernel}_roofline: {counted} of {len(run.trace.steps)} steps counted, "
                     f"{expected} launch(es) a step; the others had a launch without device "
                     f"time, or missing")
    if not ns:
        return None
    return 100.0 * counts.bound_s(nbytes, flops)[0] / (ns * 1e-9)


def mfu(run):
    """The model FLOPs of the completed steps over the window, as a share of
    the float32 peak."""
    return counts.mfu_pct(run.driver.step_flops() * run.steps, run.elapsed_s)


def idle_pct(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.busy_ns else None


def peak_gib(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
