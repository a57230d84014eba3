"""The program's own spans in a traced window, and the device's idle time
split over them.

The program records a span at each of its layer boundaries while a
torch.profiler session is on (dpdist_tpu_torch.train.profiling.span:
"serve", "loss", "train.step", "train.forward", "train.backward",
"train.optimizer", "dpdist.encode", "dpdist.gather", "dpdist.decode"),
each as (name, detail, start_ns, end_ns, parent, thread) on
time.time_ns()'s clock, the clock of the benchmark's own spans and of the
profiler's timestamps. A program that records none (one older than those
spans) gives nothing to read, and every reader here returns None for it.

`split` divides the device's idle time in the window, the gaps in the
union of the trace's kernels that have device time, over the innermost
span open on the calling thread when it fell: one of the program's spans
that the window's own thread opened, else one of the benchmark's
("entry", "readback", "log", "step"), else "loop". The benchmark's
"readback" holds the window's only copies (the answers' read-back), which
no reader counts, so copies stay out of the union. Readers take their
numbers per step of the window.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

from portbench.core.trace import _attribute, _union

DEPTH = 64          # spans to look back over for the holder of a time (_attribute)


@dataclasses.dataclass
class Split:
    records: list       # the program's spans (name, detail, start, end, parent, thread)
    gaps: dict          # holder -> idle ns; a holder is ("program", index) or a benchmark span

    def name(self, holder) -> str:
        return self.records[holder[1]][0] if isinstance(holder, tuple) else holder

    def within(self, holder, names) -> bool:
        """Whether `holder` is a program span named in `names` or lies inside one."""
        i = holder[1] if isinstance(holder, tuple) else -1
        while i >= 0:
            if self.records[i][0] in names:
                return True
            i = self.records[i][4]
        return False


def records(run):
    """The program's span records, or None where the program keeps none or
    the run has no trace."""
    if run.trace is None:
        return None
    try:
        from dpdist_tpu_torch.train import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def split(run, program=None):
    """The Split of the run's idle time (cached on the run); `program`, the
    program's records, defaults to profiling.spans(). None without them."""
    if program is None:
        cached = getattr(run, "_program_split", None)
        if cached is not None:
            return cached
        program = records(run)
        if program is None:
            return None
    tr, me = run.trace, threading.get_ident()
    lo, hi = tr.window
    mine = [(s, e, ("program", i)) for i, (_, _, s, e, _, t) in enumerate(program)
            if t == me and e > 0 and s < hi and e > lo]
    bench = [(s, e, name) for name, s, e in run.spans.events if name != "window"]
    # Outer before inner where two spans start together.
    nested = sorted(mine + bench, key=lambda x: (x[0], -x[1]))
    starts = [s for s, _, _ in nested]
    busy = _union([(k.start, k.start + k.dur) for k in tr.kernels if k.dur > 0], lo, hi)
    gaps = collections.Counter()
    t = lo
    for s, e in busy + [[hi, hi]]:
        if s > t:
            _attribute(nested, starts, t, s, gaps, depth=DEPTH)
        t = max(t, e)
    out = Split(records=program, gaps=dict(gaps))
    run._program_split = out
    return out


def _per_step(run, value):
    steps = len(run.trace.steps)
    return value / steps if steps else None


def idle_ms(run, innermost):
    """Idle ms per step while the innermost span open was one whose name
    `innermost(name)` accepts."""
    sp = split(run)
    if sp is None:
        return None
    return _per_step(run, 1e-6 * sum(v for h, v in sp.gaps.items() if innermost(sp.name(h))))


def idle_ms_within(run, names):
    """Idle ms per step inside the program's spans named in `names`, their
    children included."""
    sp = split(run)
    if sp is None:
        return None
    return _per_step(run, 1e-6 * sum(v for h, v in sp.gaps.items() if sp.within(h, names)))


def window_spans(run, name):
    """[(detail, start, end)] of the program's spans called `name` that the
    window's thread opened and closed inside the window."""
    program = records(run)
    if program is None:
        return None
    lo, hi = run.trace.window
    me = threading.get_ident()
    return [(d, s, e) for n, d, s, e, _, t in program
            if n == name and t == me and e > 0 and lo <= s and e <= hi]


def host_ms(run, name):
    """Host ms per step inside the program's spans called `name`."""
    found = window_spans(run, name)
    return None if found is None else _per_step(run, 1e-6 * sum(e - s for _, s, e in found))


def count(run, name, detail):
    """The program's spans called `name` with `detail`, per step."""
    found = window_spans(run, name)
    return None if found is None else _per_step(run, sum(d == detail for d, _, _ in found))


def is_model(name) -> bool:
    return name.startswith("dpdist.")
