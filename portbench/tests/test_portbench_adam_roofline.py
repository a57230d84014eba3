"""metrics/adam_roofline.py on hand-made traces: 28 bytes a weight over the
fused Adam kernel's device time, a step with an untimed launch skipped,
nothing read from a program without the kernel."""

from pathlib import Path

import pytest

from portbench.core import counts
from portbench.core.cell import Run, load_module
from portbench.core.trace import Kernel, Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
NAME = "(anonymous namespace)::fused_adam_kernel((anonymous namespace)::Leaves, " \
       "(anonymous namespace)::Step)"
SHAPES = {"a/w": (1000, 300), "a/b": (300,), "c/w": (5, 5, 5, 4, 8)}
WEIGHTS = 1000 * 300 + 300 + 5 * 5 * 5 * 4 * 8


class _Driver:
    units_per_step = 1
    param_shapes = SHAPES


def _run(kernels, steps=4, driver=_Driver()):
    spans = Spans(traced=True)
    trace = Trace(window=(0, 1000 * steps), steps=[(1000 * i, 1000 * (i + 1)) for i in range(steps)],
                  kernels=[Kernel(name, start, dur, step) for name, start, dur, step in kernels],
                  launches=[0] * steps, busy_ns=0, gaps={}, untimed=0)
    return Run(driver=driver, steps=steps, elapsed_s=1.0, setup_s=0.0, spans=spans, trace=trace,
               window_peak_bytes=0)


def _read(run):
    return load_module(ROOT / "portbench" / "metrics" / "adam_roofline.py").read(run)


def test_bytes_are_28_a_weight_and_an_untimed_step_is_skipped():
    bound_ns = counts.bound_s(28 * WEIGHTS, 0)[0] * 1e9
    kernels = [("elementwise", 10, 500, 0), (NAME, 100, 2 * bound_ns, 0),
               (NAME, 1100, 2 * bound_ns, 1), (NAME, 2100, 0, 2), (NAME, 3100, 4 * bound_ns, 3)]
    run = _run(kernels)
    # Steps 0, 1 and 3 count (bound 3 x, time 8 x); step 2's launch has no
    # device time.
    assert _read(run) == pytest.approx(100 * 3 / 8)
    assert run.notes == ["adam_roofline: 3 of 4 steps counted, 1 launch(es) a step; the others "
                         "had a launch without device time, or missing"]
    assert counts.bound_s(28 * WEIGHTS, 0)[1] == "bytes"


def test_a_step_with_a_launch_missing_or_extra_is_skipped():
    kernels = [(NAME, 100, 1000, 0), (NAME, 1100, 1000, 1), (NAME, 1200, 5000, 1),
               (NAME, 3100, 1000, 3), (NAME, -5, 9000, -1)]
    bound_ns = counts.bound_s(28 * WEIGHTS, 0)[0] * 1e9
    assert _read(_run(kernels)) == pytest.approx(100 * 2 * bound_ns / 2000)


def test_nothing_to_read_without_the_kernel_or_the_shapes():
    assert _read(_run([("elementwise", 100, 1000, 0)])) is None

    class Bare:
        units_per_step = 1

    assert _read(_run([(NAME, 100, 1000, 0)], driver=Bare())) is None
