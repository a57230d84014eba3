"""core/program_spans.py: the device's idle time split over the program's
spans, on hand-made runs with known kernel intervals and nested spans, and
on traced runs of small cells on the CPU (where the device runs nothing,
so the whole window is idle and each split must add up to the benchmark's
own split by its spans)."""

import threading
import time
from pathlib import Path

import pytest

from portbench.core import program_spans
from portbench.core.cell import Run, load_cell, load_module, run
from portbench.core.trace import Kernel, Spans, Trace

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 7


class _Driver:
    units_per_step = 1


def _run(kernels, bench, window=(0, 1000), steps=((0, 500), (500, 1000))):
    spans = Spans(traced=True)
    spans.events[:] = [("window", *window)] + [("step", s, e) for s, e in steps] + list(bench)
    trace = Trace(window=window, steps=list(steps),
                  kernels=[Kernel("k", s, d, 0) for s, d in kernels], launches=[0] * len(steps),
                  busy_ns=0, gaps={}, untimed=0)
    return Run(driver=_Driver(), steps=len(steps), elapsed_s=1.0, setup_s=0.0, spans=spans,
               trace=trace, window_peak_bytes=0)


def test_idle_is_split_over_serve_and_the_gather():
    me = threading.get_ident()
    # Two calls. Call 1: entry [10, 400), serve [20, 390), gather [50, 150)
    # inside it, decode [150, 300); kernels at [100, 120) and [200, 260).
    # Call 2: entry [510, 900), serve [520, 880), no kernel at all.
    program = [("serve", "", 20, 390, -1, me), ("dpdist.gather", "plain", 50, 150, 0, me),
               ("dpdist.decode", "off", 150, 300, 0, me), ("serve", "", 520, 880, -1, me),
               ("serve", "", 30, 60, -1, me + 1)]          # another thread's: left out
    bench = [("entry", 10, 400), ("entry", 510, 900), ("readback", 400, 450)]
    r = _run([(100, 20), (200, 60), (420, 0), (-50, 80)], bench)
    sp = program_spans.split(r, program)
    by_name = {}
    for holder, ns in sp.gaps.items():
        by_name[sp.name(holder)] = by_name.get(sp.name(holder), 0) + ns
    # The kernel at -50 lasts until 30, so idle starts at 30; the one at
    # 420 has no device time and counts as idle.
    assert by_name == {
        "serve": (50 - 30) + (390 - 300) + (880 - 520),
        "dpdist.gather": (100 - 50) + (150 - 120),
        "dpdist.decode": (200 - 150) + (300 - 260),
        "entry": (400 - 390) + (520 - 510) + (900 - 880),
        "readback": 50,
        "step": (500 - 450) + (510 - 500) + (1000 - 900),
    }
    assert sum(by_name.values()) == 1000 - 30 - 20 - 60
    # Per step (two steps), in ms.
    assert program_spans.idle_ms(r, lambda n: n == "serve") == pytest.approx(470 * 1e-6 / 2)
    assert program_spans.idle_ms(r, program_spans.is_model) == pytest.approx(170 * 1e-6 / 2)
    assert program_spans.idle_ms_within(r, {"serve"}) == pytest.approx(640 * 1e-6 / 2)


def test_nested_training_spans_count_their_children():
    me = threading.get_ident()
    program = [("train.step", "", 100, 900, -1, me), ("train.forward", "", 110, 400, 0, me),
               ("loss", "", 150, 350, 1, me), ("dpdist.encode", "plain", 160, 200, 2, me),
               ("train.backward", "", 400, 600, 0, me),
               ("train.optimizer", "adam", 600, 880, 0, me)]
    r = _run([(120, 20), (210, 140), (450, 100), (650, 200)], [("entry", 90, 950)],
             steps=((0, 1000),))
    program_spans.split(r, program)
    # forward: [110, 120) + [140, 210) (the loss's, the encode's inside it) + [350, 400)
    assert program_spans.idle_ms_within(r, {"train.forward"}) == pytest.approx(130e-6)
    assert program_spans.idle_ms_within(r, {"train.backward"}) == pytest.approx(100e-6)
    assert program_spans.idle_ms_within(r, {"train.optimizer"}) == pytest.approx(80e-6)
    # The step's own: [100, 110) and [880, 900).
    assert load_module(ROOT / "portbench" / "metrics" / "step_idle_ms.train.py").read(r) == \
        pytest.approx(30e-6)
    assert program_spans.idle_ms_within(r, {"train.step"}) == pytest.approx(340e-6)
    assert program_spans.idle_ms(r, lambda n: n == "loss") == pytest.approx(20e-6)
    assert program_spans.idle_ms(r, program_spans.is_model) == pytest.approx(40e-6)


def test_spans_read_from_the_window_only(monkeypatch):
    from dpdist_tpu_torch.train import profiling

    me = threading.get_ident()
    recs = [("train.optimizer", "adam", 100, 300, -1, me),
            ("train.optimizer", "adam", 600, 700, -1, me),
            ("train.optimizer", "adam", 1500, 1600, -1, me),   # after the window
            ("train.optimizer", "adam", 10, 20, -1, me + 1),   # another thread
            ("dpdist.encode", "plain", 120, 130, -1, me),
            ("dpdist.encode", "threedmfv", 140, 150, -1, me),
            ("dpdist.encode", "plain", 620, 630, -1, me)]
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    r = _run([], [])
    assert program_spans.host_ms(r, "train.optimizer") == pytest.approx(300e-6 / 2)
    assert program_spans.count(r, "dpdist.encode", "plain") == 1.0


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from dpdist_tpu_torch.train import profiling

    monkeypatch.delattr(profiling, "spans")
    r = _run([(0, 10)], [])
    for name in ("entry_idle_ms.serve", "model_idle_ms.grad", "backward_idle_ms.grad",
                 "plain_encodes.grad", "forward_idle_ms.train", "optim_ms.train",
                 "optim_idle_ms.train", "backward_idle_ms.train", "model_idle_ms.serve",
                 "step_idle_ms.train"):
        assert load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read(r) is None


SMALL = {
    "dpdist_serve_np64": dict(batch=4, pool_batches=2, warmup_steps=1),
    "dpdist_grad_np64": dict(batch=4, pool_batches=2, warmup_steps=1),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_cpu_run_splits_the_entry_idle(name):
    """On the CPU nothing runs on a device: every moment of the window is
    idle, so the program's split of the benchmark's "entry" adds up to it."""
    cell = load_cell(ROOT, name)
    cell["traffic"].update(SMALL[name])
    result, notes = run(ROOT, cell, SEED, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"] is True, notes
    m = {k: v["value"] for k, v in result["metrics"].items()}
    calls = result["attempted"]
    entry = dict(result["breakdown"]["idle_gaps"])["entry"] * 1e3 / calls
    if name == "dpdist_serve_np64":
        assert m["entry_idle_ms.serve"] + m["model_idle_ms.serve"] == pytest.approx(entry, rel=0.02)
    else:
        assert m["model_idle_ms.grad"] + m["backward_idle_ms.grad"] == pytest.approx(entry,
                                                                                     rel=1e-6)
        # On the CPU the plain composition encodes both clouds.
        assert m["plain_encodes.grad"] == 2.0
