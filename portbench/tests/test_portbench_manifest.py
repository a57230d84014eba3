"""BENCHMARK.json against the benchmark's contract: its keys, the
characters of names and units, the files every entry is found by, and
that every metric's cells report the end-to-end metric it moves.

    python -m pytest portbench/tests -q
"""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _cells_of(metric):
    if "workloads" in metric:
        return metric["workloads"]
    if metric in BENCH["end_to_end"]:
        return list(CELLS)
    return [c for c in CELLS if c in _cells_of(_e2e(metric["moves"]))]


def _e2e(name):
    return next(m for m in BENCH["end_to_end"] if m["name"] == name)


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    # A full check (2 + 14 runs a cell, 60 s over each run, 180 s of compile a
    # cell, 1,200 s spare) of 24 cells fits in 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    assert not {m["name"] for m in METRICS} & set(CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in SOURCES, m
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m
    assert _e2e("setup_s")["bound"] <= 0.25 and "workloads" not in _e2e("setup_s")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_named_alike():
    """Metrics of one layer give the same layer, letter for letter."""
    by_base = {}
    for m in BENCH["per_layer"]:
        by_base.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_base.values()), by_base


def test_configs():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["name"] in used and c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
        assert (ROOT / "portbench" / "reference" / f"{c['name']}.py").is_file()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_finds_its_files_and_reports_enough(cell):
    w = CELLS[cell]
    base = ROOT / "portbench"
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    assert (base / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((base / "limits" / f"{cell}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in _cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = [m for m in BENCH["per_layer"] if cell in _cells_of(m)]
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (m["name"], cell)
        assert "mfu" in m["name"] or any("mfu" in p["name"] and p["moves"] == m["moves"]
                                         for p in per_layer)


def test_every_metric_has_its_reader():
    for m in METRICS:
        path = ROOT / "portbench" / "metrics" / f"{m['name']}.py"
        assert path.is_file(), m["name"]
        assert "def read(run)" in path.read_text()


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
