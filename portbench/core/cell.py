"""One run of one cell: set-up, the measured window, the metrics, the
check against the plain reference, the result.

Everything that belongs to one cell is found by name:
  BENCHMARK.json                the cell's configuration, traffic and metrics
  portbench/configs/<config>.json   the model configuration as it is run
  portbench/traffic/<traffic>.json  the traffic mix, naming its driver
  portbench/drivers/<driver>.py     the loop body that drives one entry point
  portbench/limits/<cell>.json      the limit of each number compared
  portbench/metrics/<metric>.py     one reader per metric: read(run) -> number or None
  portbench/reference/<config>.py   the configuration's plain reference
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench.core.driver import Context
from portbench.core.isolation import forbidden_loaded
from portbench.core.trace import Spans, summarize

BENCH = "portbench"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module at `path` (file names may hold dots, as metric names do)."""
    name = "portbench_" + path.stem.replace(".", "_") + "_" + path.parent.name
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its files read: {"name",
    "chips", "config", "traffic", "limits", "end_to_end", "per_layer"}."""
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    w = cells[name]
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m["workloads"] or ("workloads" not in m and m["moves"] in reported)]
    base = root / BENCH
    return {"name": name, "chips": w["chips"], "config_name": w["config"],
            "config": _json(base / "configs" / f"{w['config']}.json"),
            "traffic": _json(base / "traffic" / f"{w['traffic']}.json"),
            "limits": _json(base / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def make_driver(root: Path, cell: dict, seed: int, device, traced: bool = False):
    """The cell's driver (drivers/<traffic's driver>.py), not yet set up."""
    ctx = Context(root=root, device=torch.device(device), config_name=cell["config_name"],
                  seed=seed % 2 ** 63, config=cell["config"], traffic=cell["traffic"],
                  spans=Spans(traced=traced))
    return load_module(root / BENCH / "drivers" / f"{cell['traffic']['driver']}.py").Driver(ctx)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    driver: object
    steps: int                   # units of work begun (and finished) in the window
    elapsed_s: float             # from the window's start until the last step's work was done
    setup_s: float
    spans: Spans                 # host spans: spans.seconds["step"], ["entry"], ...
    trace: object                # trace.Trace of a --trace 1 run, else None
    window_peak_bytes: int       # the device memory peak inside the window
    notes: list = dataclasses.field(default_factory=list)   # readers' remarks, for standard error


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure_window(driver, spans: Spans, seconds: float):
    """Steps back to back until `seconds` have passed, then the drain;
    returns (steps, elapsed seconds)."""
    with spans("window"):
        start = time.perf_counter()
        end, i = start + seconds, 0
        while time.perf_counter() < end:
            with spans("step"):
                driver.step(i)
            i += 1
        with spans("drain"):
            driver.drain()
        elapsed = time.perf_counter() - start
    return i, elapsed


def run(root: Path, cell: dict, seed: int, seconds: float, trace: bool, device, t0: float):
    """(result dict, messages for standard error); the result is None where
    the run must print none."""
    driver = make_driver(root, cell, seed, device, traced=trace)
    ctx, spans = driver.ctx, driver.ctx.spans
    device = ctx.device
    cuda = device.type == "cuda"
    driver.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0
    spans.clear()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
            steps, elapsed = measure_window(driver, spans, seconds)
    else:
        steps, elapsed = measure_window(driver, spans, seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = Run(driver=driver, steps=steps, elapsed_s=elapsed, setup_s=setup_s, spans=spans,
              trace=summarize(prof, spans) if trace else None, window_peak_bytes=window_peak)
    if trace:
        del prof

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = load_module(root / BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace:
        dev.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
    notes = list(rec.notes)
    if cuda:
        dev["power"] = _power_limit()
    if trace:
        notes.append(f"trace: {len(rec.trace.kernels)} kernel records, {rec.trace.untimed} "
                     f"without device time, {steps} steps")

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = driver.check()
    checks = {}
    for name, value in readings.items():
        if name in cell["limits"]:
            checks[name] = {"value": value, "limit": cell["limits"][name]}
        else:
            notes.append(f"reading {name} {value!r} (no limit: not compared)")
    missing = sorted(set(cell["limits"]) - set(readings))
    correct = not missing and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())
    notes += [f"check {n} {c['value']!r} limit {c['limit']!r}" for n, c in checks.items()]
    notes += [f"check {n} missing" for n in missing]

    found = forbidden_loaded()
    if found:
        return None, notes + [f"the run loaded JAX or the JAX package: {', '.join(found)}"]
    result = {"correct": correct, "attempted": steps, "failed": driver.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["checks"] = checks
    return result, notes


def emit(result, notes) -> int:
    for line in notes:
        print(line, file=sys.stderr, flush=True)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0
