"""Profiling hooks (port of dpdist_tpu/train/profiling.py).

- trace(logdir): a context manager that records torch.profiler's CPU and
  CUDA activity (CUDA only where a card is present) and writes a Chrome
  trace, trace.json, into logdir (Perfetto or chrome://tracing read it).
- annotate(name): a named span inside the step: torch.profiler's
  record_function, and an NVTX range when a card is present.
- StepTimer: step time on the host clock; stop() synchronises the card
  first, so a step's time includes its device work.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write <logdir>/trace.json and yield the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


class StepTimer:
    """Steady-state step time: start(), run the step, stop()."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """Wait for the card (and for `result`, if it is a tensor elsewhere),
        then record and return the seconds since start()."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if isinstance(result, torch.Tensor):
            result.cpu()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean_ms(self) -> float:
        """Mean step time in ms over all but the first fifth of the steps
        (at least the first step, which holds the warm-up)."""
        if not self.times:
            return float("nan")
        return 1e3 * float(np.mean(self.times[max(1, len(self.times) // 5):]))
