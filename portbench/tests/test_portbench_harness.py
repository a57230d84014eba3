"""The harness's refusals and its isolation: no result without a card or
without the program, no JAX and no JAX package in a run, nothing of the
program in the plain references."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.core.isolation import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def _python(code, cwd, timeout=600):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=env)


def test_whole_top_level_names():
    loaded = {"dpdist_tpu_torch": 1, "dpdist_tpu_torch.serving": 1, "jaxtyping": 1,
              "flaxen": 1, "portbench.core": 1}
    assert forbidden_loaded(loaded) == []
    loaded.update({"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1, "dpdist_tpu": 1,
                   "dpdist_tpu.models.dpdist": 1})
    assert forbidden_loaded(loaded) == ["dpdist_tpu", "dpdist_tpu.models.dpdist", "flax.linen",
                                        "jax", "jaxlib.xla_client"]


def test_no_result_without_a_card():
    """On a machine without CUDA (this one's tests), measuring refuses."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dpdist_serve_np64",
                          "--seed", "2147483700", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    code = "import torch, sys; sys.exit(0 if torch.cuda.is_available() else 1)"
    if _python(code, ROOT).returncode == 1:
        assert out.returncode != 0 and out.stdout.strip() == ""
        assert "CUDA" in out.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory holding BENCHMARK.json and portbench/ alone runs nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.');\n"
            "from pathlib import Path\n"
            "from portbench.core.cell import load_cell, run, emit\n"
            "cell = load_cell(Path('.'), 'dpdist_serve_np64')\n"
            "sys.exit(emit(*run(Path('.'), cell, 5, 1.0, False, 'cpu', time.perf_counter())))\n")
    out = _python(code, tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "dpdist_tpu_torch" in out.stderr or "ckpt_best" in out.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time, json; sys.path.insert(0, '.')\n"
            "from pathlib import Path\n"
            "from portbench.core.cell import load_cell, run\n"
            "from portbench.core.isolation import forbidden_loaded\n"
            "cell = load_cell(Path('.'), 'dpdist_serve_np64')\n"
            "cell['traffic'].update(batch=2, pool_batches=1, warmup_steps=1)\n"
            "result, notes = run(Path('.'), cell, 11, 0.2, False, 'cpu', time.perf_counter())\n"
            "print(json.dumps({'result': result is not None, 'found': forbidden_loaded(),\n"
            "                  'port': 'dpdist_tpu_torch' in sys.modules}))\n")
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '{"result": true, "found": [], "port": true}'


def test_references_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import portbench.reference.dpdist_3dmfv_k5, portbench.reference.aue_3dmfv_dpdist\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('dpdist_tpu_torch', 'dpdist_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n")
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            if line.strip().startswith(("import ", "from ")):
                assert "dpdist_tpu" not in line and "jax" not in line, (path.name, line)
