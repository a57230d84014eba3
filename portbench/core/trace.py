"""Host spans of the measured window, and the reading of a torch.profiler
trace of it.

The benchmark records its own spans around the calls it makes into the
program ("step" around each unit of work, and inside it "entry" around
the call into the program's entry point, "readback" around the copy of
its answer to the host, "log" where a driver has one). With tracing on,
each span also keeps its start and end on the profiler's clock
(time.time_ns()), so that the trace can say what the host was doing
while the device sat idle. The profiler records CUDA activity only
(kernels, copies, the runtime's launch calls): recording every host-side
operator as well slowed the AUE step by a quarter on the H100.

`summarize` reduces the profiler's events to what the per-layer metrics
read: every device kernel with its step, the launch calls per step, the
device's busy time (the union of its kernel, copy and fill intervals) in
the window, and the idle time split over the host spans it fell in.
Records without device time are kept apart and counted; a reading that
divides by device time leaves them out of both sides.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time

LAUNCH = "LaunchKernel"          # cudaLaunchKernel, cuLaunchKernel, cuLaunchKernelEx, ...


class Spans:
    """Host spans by name: durations (perf_counter) and, under a trace, each
    span's (name, start, end) on time.time_ns()'s clock, the clock of the
    profiler's timestamps."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds = collections.defaultdict(list)
        self.events = []

    def clear(self):
        self.seconds.clear()
        self.events.clear()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t, ns = time.perf_counter(), time.time_ns()
        yield
        self.seconds[name].append(time.perf_counter() - t)
        if self.traced:
            self.events.append((name, ns, time.time_ns()))


@dataclasses.dataclass
class Kernel:
    name: str
    start: int          # ns, the profiler's clock
    dur: int            # ns; 0 or less: the record has no device time
    step: int           # index of the step whose span holds its start, -1 outside every step


@dataclasses.dataclass
class Trace:
    window: tuple                  # (start, end) ns of the "window" span
    steps: list                    # (start, end) ns of each "step" span, in order
    kernels: list                  # Kernel
    launches: list                 # launch calls per step
    busy_ns: int                   # union of device intervals inside the window
    gaps: dict                     # host span name -> idle ns inside the window
    untimed: int                   # kernel records without device time

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def device_ops(self, top: int = 10):
        """[[kernel name, seconds]] of the kernels that took most time."""
        total = collections.Counter()
        for k in self.kernels:
            if k.dur > 0:
                total[k.name] += k.dur
        return [[name, ns * 1e-9] for name, ns in total.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """[[host span, seconds]]: the device's idle time in the window by
        what the host was doing, the longest first."""
        return [[name, ns * 1e-9] for name, ns in
                sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _attribute(nested, starts, a, b, gaps, depth=8):
    """Add the idle interval [a, b) to `gaps`, split over the host spans it
    crosses: each part goes to the innermost span that holds it, or to
    "loop" outside every span. `nested` holds (start, end, name) sorted by
    start and properly nested, so the holder of a time is the last span
    to start before it that has not ended, among the last `depth`."""
    t = a
    while t < b:
        i = bisect.bisect_right(starts, t) - 1
        name, end = "loop", b
        for s, e, n in nested[max(i - depth, -1) + 1:i + 1][::-1]:
            if s <= t < e:
                name, end = n, e
                break
        nxt = starts[i + 1] if i + 1 < len(starts) else b
        u = min(b, end, nxt)
        gaps[name] += u - t
        t = u


def _kind(e, cuda) -> str:
    """"kernel", "copy" (a device copy or fill), "launch" (a runtime or
    driver launch call) or "other"."""
    name = e.name()
    if e.device_type() == cuda:
        if name.startswith(("Memcpy", "Memset")):
            return "copy"
        return "other" if "Sync" in name else "kernel"
    return "launch" if LAUNCH in name else "other"


def summarize(prof, spans: Spans) -> Trace:
    """The Trace of a CUDA-activity profile of the window whose host spans
    are `spans` ("window" around it, "step" around each unit of work)."""
    from torch.autograd import DeviceType

    window, steps, inner = None, [], []
    for name, start, end in spans.events:
        if name == "window":
            window = (start, end)
        elif name == "step":
            steps.append((start, end))
        else:
            inner.append((name, start, end))
    device, raw_kernels, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e, DeviceType.CUDA)
        if kind == "launch":
            calls.append(e.start_ns())
        elif kind != "other":
            start = e.start_ns()
            device.append((start, start + e.duration_ns()))
            if kind == "kernel":
                raw_kernels.append((e.name(), start, e.duration_ns()))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    steps.sort()
    starts = [s for s, _ in steps]

    def step_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < steps[i][1] else -1

    launches = [0] * len(steps)
    for t in calls:
        step = step_of(t)
        if step >= 0:
            launches[step] += 1
    # A step of a serving or gradient cell ends by reading its answer back,
    # so its kernels run inside its span; a training step does not wait,
    # and its kernels may start in the next step's span.
    kernels = [Kernel(name, start, dur, step_of(start)) for name, start, dur in raw_kernels]
    busy = _union(device, *window)
    nested = sorted([(s, e, name) for name, s, e in inner] + [(s, e, "step") for s, e in steps])
    nested_starts = [s for s, _, _ in nested]
    gaps = collections.Counter()
    t = window[0]
    for s, e in busy + [[window[1], window[1]]]:
        if s > t:
            _attribute(nested, nested_starts, t, s, gaps)
        t = max(t, e)
    return Trace(window=window, steps=steps, kernels=kernels, launches=launches,
                 busy_ns=sum(e - s for s, e in busy), gaps=dict(gaps),
                 untimed=sum(k.dur <= 0 for k in kernels))
