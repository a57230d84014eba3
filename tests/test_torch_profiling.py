"""train/profiling.py on the CPU: the trace file and the program's spans
(off without a profiler session; under one, their records, nesting and
threads), and the spans of the layers that open them: the model's encode,
gather and decode, the frozen loss, the training step, and none while an
export traces. A CPU-activity profiler turns them on here; on the card the
benchmark's CUDA-activity profile does."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import init_dpdist
from dpdist_tpu_torch.models.dpdist import dpdist_distance
from dpdist_tpu_torch.train import profiling
from dpdist_tpu_torch.train.logging import NullLogger
from dpdist_tpu_torch.train.profiling import span, spans, trace
from dpdist_tpu_torch.train.trainer import DPDistTrainer

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))


@pytest.fixture
def recording():
    """A CPU-activity profiler session over the test, the buffer emptied first."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def net():
    cfg = DPDistConfig(**SMALL)
    params, _ = init_dpdist(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand(2, 16, 3, generator=g) * 1.6 - 0.8 for _ in range(2))
    return cfg, params, a, b


def _names(records):
    return [(r[0], r[1]) for r in records]


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        with span("dpdist_step"):
            with span("dpdist.gather", "plain"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    # The trace shows each span, its detail in brackets.
    assert any(e.get("name") == "dpdist_step" for e in events)
    assert any(e.get("name") == "dpdist.gather[plain]" for e in events)
    assert any(e.key == "dpdist_step" for e in prof.key_averages())
    assert _names(spans()) == [("dpdist_step", ""), ("dpdist.gather", "plain")]


def test_annotate_outside_a_trace_is_a_no_op():
    """A span outside a profiler session (span took annotate's place)."""
    with span("outside"):
        x = torch.zeros(3) + 1
    assert float(x.sum()) == 3.0


def test_a_span_off_is_the_shared_no_op_and_records_nothing():
    profiling.clear_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = span("a"), span("b", "detail")
    assert first is second
    with first as entered:
        with second:
            pass
    assert entered is None and spans() == []


def test_a_new_session_starts_an_empty_buffer():
    """The spans of one session are read after it, and the next session
    that follows a span asked for with none on starts from nothing."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            pass
    assert _names(spans()) == [("first", "")]
    with span("between"):
        pass
    assert _names(spans()) == [("first", "")]
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            pass
    assert _names(spans()) == [("second", "")]
    profiling.clear_spans()


def test_a_session_records_at_most_max_spans(recording, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    for k in range(5):
        with span("s", str(k)):
            pass
    assert _names(spans()) == [("s", "0"), ("s", "1"), ("s", "2")]
    assert span("more") is span("again")


def test_a_span_open_when_the_buffer_empties_is_no_parent(recording):
    with span("outer"):
        profiling.clear_spans()
        with span("inner"):
            with span("innermost"):
                pass
    ((_, _, _, _, inner_parent, _), (_, _, _, _, innermost_parent, _)) = spans()
    assert (inner_parent, innermost_parent) == (-1, 0)


def test_spans_nest_by_thread(recording):
    seen = {}

    def other():
        with span("worker", "t2"):
            with span("worker.inner"):
                seen["ident"] = threading.get_ident()

    with span("outer", "main"):
        with span("inner"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
        with span("second"):
            pass
    records = spans()
    by_name = {r[0]: (i, r) for i, r in enumerate(records)}
    assert sorted(by_name) == ["inner", "outer", "second", "worker", "worker.inner"]
    main = threading.get_ident()
    i_outer, outer = by_name["outer"]
    assert outer[1] == "main" and outer[4] == -1 and outer[5] == main
    assert by_name["inner"][1][4] == i_outer and by_name["second"][1][4] == i_outer
    i_worker, worker = by_name["worker"]
    # The thread opened its span inside "inner", but on a stack of its own.
    assert worker[4] == -1 and worker[5] == seen["ident"] != main and worker[1] == "t2"
    assert by_name["worker.inner"][1][4] == i_worker
    for name, (_, r) in by_name.items():
        assert 0 < r[2] <= r[3], name
    assert outer[2] <= by_name["inner"][1][2] <= by_name["inner"][1][3] <= outer[3]


def test_spans_of_many_threads_keep_their_own_parents(recording):
    """More threads than cores, switching as often as the interpreter lets
    them: every span is recorded once, under its own thread's parent."""
    threads, depth, rounds = 16, 3, 50
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(rounds):
            with span("outer", str(k)):
                with span("middle", str(k)):
                    with span("inner", str(k)):
                        pass

    try:
        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    records = spans()
    assert len(records) == threads * depth * rounds
    above = {"outer": None, "middle": "outer", "inner": "middle"}
    for name, detail, start, end, parent, thread in records:
        if above[name] is None:
            assert parent == -1
        else:
            p = records[parent]
            assert (p[0], p[1], p[5]) == (above[name], detail, thread)
            assert p[2] <= start <= end <= p[3]


def test_span_times_bracket_a_clock_read_inside(recording):
    with span("timed"):
        inside = time.time_ns()
    ((name, detail, start, end, parent, thread),) = spans()
    assert (name, detail, parent, thread) == ("timed", "", -1, threading.get_ident())
    assert start <= inside <= end


def test_the_model_records_its_encode_gather_and_decode(net, recording):
    cfg, params, a, b = net
    dpdist_distance(params, cfg, a, b)
    # On the CPU "auto" is the plain composition: per direction the
    # surface's encode and the queries' gather, then each direction's decode.
    assert _names(spans()) == [("dpdist.encode", "plain"), ("dpdist.gather", "plain"),
                               ("dpdist.encode", "plain"), ("dpdist.gather", "plain"),
                               ("dpdist.decode", "off"), ("dpdist.decode", "off")]
    assert all(r[4] == -1 for r in spans())


def test_the_frozen_loss_records_loss_around_the_model(net, recording):
    cfg, params, a, b = net
    src = b.clone().requires_grad_(True)
    loss = make_frozen_dpdist_loss(params, cfg)(a, src)
    torch.autograd.grad(loss, src)
    records = spans()
    assert records[0][:2] == ("loss", "")
    assert [r[0] for r in records[1:]] == ["dpdist.encode", "dpdist.gather"] * 2 + [
        "dpdist.decode"] * 2
    assert all(r[4] == 0 for r in records[1:])


def test_a_training_step_records_its_forward_backward_and_optimizer(tmp_path, recording):
    trainer = DPDistTrainer(DPDistConfig(**SMALL), TrainConfig(batch_size=2, augment=False),
                            run_dir=str(tmp_path), device="cpu", logger=NullLogger())
    r = np.random.default_rng(0)
    data = r.uniform(-0.9, 0.9, (2, 96, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (2, 64)).astype(np.float32)
    profiling.clear_spans()
    trainer.train_step(data, labels)
    records = spans()
    names = _names(records)
    assert names[0] == ("train.step", "")
    # Without BN the step runs the AB direction alone: one encode, gather, decode.
    assert names[1:] == [("train.forward", ""), ("dpdist.encode", "plain"),
                         ("dpdist.gather", "plain"), ("dpdist.decode", "off"),
                         ("train.backward", ""), ("train.optimizer", "adam")]
    parent = {r[0]: r[4] for r in records}
    assert parent["train.step"] == -1
    assert parent["train.forward"] == parent["train.backward"] == parent["train.optimizer"] == 0
    assert parent["dpdist.encode"] == parent["dpdist.decode"] == 1
    step = records[0]
    assert all(step[2] <= r[2] <= r[3] <= step[3] for r in records[1:])


def test_an_export_records_nothing(net, recording):
    from dpdist_tpu_torch import serving

    cfg, params, a, b = net
    with span("before"):
        pass
    ep = serving.export_frozen_distance(params, None, cfg, batch=2, device="cpu")
    ep.module()(a, b)                     # the program runs no span of the port
    # The export's spans are left out, and the session's buffer is kept.
    with span("after"):
        pass
    assert _names(spans()) == [("before", ""), ("after", "")]
