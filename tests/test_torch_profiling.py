"""train/profiling.py on the CPU: the trace file, the named spans, and the
step timer (port of dpdist_tpu/train/profiling.py; on the card the trace
also records CUDA activity and the spans NVTX ranges, which chip_smoke.py
exercises)."""

import json
import time

import torch

from dpdist_tpu_torch.train.profiling import StepTimer, annotate, trace


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("dpdist_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "dpdist_step" for e in events)
    assert any(e.key == "dpdist_step" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_a_no_op():
    with annotate("outside"):
        x = torch.zeros(3) + 1
    assert float(x.sum()) == 3.0


def test_step_timer_skips_the_warm_up():
    timer = StepTimer()
    assert timer.mean_ms != timer.mean_ms   # nan before any step
    for pause in (0.05, 0.001, 0.001, 0.001, 0.001):
        timer.start()
        time.sleep(pause)
        timer.stop(torch.zeros(2))
    assert len(timer.times) == 5
    assert 0.5 <= timer.mean_ms < 40.0   # the 50 ms first step is left out
