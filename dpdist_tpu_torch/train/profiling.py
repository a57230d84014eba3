"""Profiling hooks (port of dpdist_tpu/train/profiling.py).

- trace(logdir): a context manager that records torch.profiler's CPU and
  CUDA activity (CUDA only where a card is present) and writes a Chrome
  trace, trace.json, into logdir (Perfetto or chrome://tracing read it).
- span(name, detail=""): a named span of the program's host time at a
  layer boundary (the entry points, the model's encode, gather and decode,
  the training step's forward, backward and optimizer).
- spans(): the spans of the current profiler session, or of the last.

A span costs next to nothing while no torch.profiler session is active:
`span` then returns one shared context manager that does nothing (no
allocation, no clock read, no record_function). The test is torch's own
process-wide flag of an active session (torch.autograd.profiler.
_is_profiler_enabled), one attribute read, so spans on every thread see it.
While a session is active (trace(), or any other torch.profiler.profile,
one that records CUDA activity alone included), entering a span appends
one record to an in-memory buffer,

    (name, detail, start_ns, end_ns, parent, thread)

with both times on time.time_ns(), the clock of the profiler's
timestamps; `parent` is the buffer index of the span open on the same
thread when it began (-1 for none) and `thread` is threading.get_ident().
Inside trace() it also enters torch.profiler.record_function(name, with
the detail in brackets), so that trace.json shows the span and what the
route chose; other sessions get the record alone (a session that records
CUDA activity alone would otherwise be handed the span as an annotation of
the device's timeline). Spans record nothing while an export traces
(kernels.ops.exporting): `span` then returns a fresh
contextlib.nullcontext, which the tracer of an exported while_loop's body
can enter.

The buffer holds one session's spans. The first span of a session that
follows a span asked for with no session on empties it, and so does
trace() when it starts; a session records at most its first MAX_SPANS
spans, so a long profile does not grow the host's memory without bound.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from dpdist_tpu_torch.kernels import ops

_session = torch.autograd.profiler     # _is_profiler_enabled: a torch.profiler session is on
MAX_SPANS = 1 << 20      # a session's spans kept; later ones are not recorded
_records = []            # [name, detail, start_ns, end_ns, parent, thread]; end_ns 0 while open
_lock = threading.Lock()
_local = threading.local()
_annotate = False        # inside trace(): spans enter record_function too
_stale = False           # a span was asked for with no session on: the next one recorded
                         # begins a new session's buffer
_generation = 0          # bumped whenever the buffer empties; a thread's open spans of an
                         # older buffer are nobody's parent


class _Off:
    """The span of an inactive profiler: enters and leaves, and does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


_OFF = _Off()


def _empty():
    """Empty the buffer (the caller holds _lock)."""
    global _generation, _stale
    _records.clear()
    _generation += 1
    _stale = False


class _Span:
    __slots__ = ("name", "detail", "record", "function")

    def __init__(self, name: str, detail: str):
        self.name, self.detail = name, detail

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.function = None
        if _annotate:
            label = f"{self.name}[{self.detail}]" if self.detail else self.name
            self.function = torch.profiler.record_function(label)
            self.function.__enter__()
        start = time.time_ns()
        with _lock:
            if _stale:
                _empty()
            top = stack[-1] if stack else None
            parent = top[1] if top is not None and top[0] == _generation else -1
            self.record = [self.name, self.detail, start, 0, parent, threading.get_ident()]
            index = len(_records)
            _records.append(self.record)
            stack.append((_generation, index))
        return self

    def __exit__(self, *exc):
        self.record[3] = time.time_ns()
        _local.stack.pop()
        if self.function is not None:
            self.function.__exit__(*exc)
        return False


def span(name: str, detail: str = ""):
    """A context manager around one layer's host time: a record while a
    profiler session is active, else a shared no-op."""
    global _stale
    if ops._mode is not None:
        # An export is tracing: a fresh no-op context, which torch.export's
        # tracer of a while_loop body can enter (the shared one it cannot).
        return contextlib.nullcontext()
    if not _session._is_profiler_enabled:
        _stale = True
        return _OFF
    if len(_records) >= MAX_SPANS:
        return _OFF
    return _Span(name, detail)


def spans() -> list:
    """[(name, detail, start_ns, end_ns, parent, thread)] of the spans
    recorded in the current profiler session, or in the last one while none
    is on, in the order they began; a span still open has end_ns 0."""
    with _lock:
        return [tuple(r) for r in _records]


def clear_spans() -> None:
    with _lock:
        _empty()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write <logdir>/trace.json and yield the profiler.
    The span buffer starts empty."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    global _annotate
    os.makedirs(logdir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        _annotate = True
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _annotate = False
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
