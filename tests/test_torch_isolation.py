"""The port runs without JAX: no file of dpdist_tpu_torch/, nor
chip_smoke.py, imports jax or anything of dpdist_tpu."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "dpdist_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dpdist_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for module in ("kernels/mfv_gather.py", "kernels/table_gather.py", "kernels/threedmfv.py",
                   "kernels/chamfer.py", "kernels/gather_fused.py", "kernels/fused_forward.py",
                   "models/dpdist.py", "ops/chamfer.py", "ops/emd.py",
                   "losses/dpdist_loss.py", "losses/standard.py", "nn/schedules.py",
                   "train/optim.py", "train/trainer.py", "train/logging.py",
                   "data/batching.py", "data/prefetch.py", "cli/eval_pair.py",
                   "data/augment.py", "data/io.py", "data/gtgen.py", "data/modelnet.py",
                   "data/registration.py", "native/lib.py", "native/__init__.py",
                   "train/profiling.py", "cli/common.py", "cli/gen_data.py",
                   "cli/train_dpdist.py", "geometry/__init__.py", "geometry/rotations.py",
                   "geometry/se3.py", "geometry/symmetry.py", "configs/config.py",
                   "nn/layers.py", "models/pcrnet.py", "train/checkpoint.py",
                   "eval/__init__.py", "eval/registration.py", "eval/viz.py",
                   "train/pcrnet_trainer.py", "cli/train_pcrnet.py", "cli/eval_registration.py",
                   "cli/eval_matrix.py", "cli/make_templates.py", "serving.py",
                   "kernels/ops.py", "cli/export_serving.py", "cli/run_serving.py",
                   "parallel/__init__.py", "parallel/mesh.py", "parallel/shard.py",
                   "parallel/distributed.py", "eval/dense.py"):
        assert "dpdist_tpu_torch/" + module in names
    assert "chip_smoke.py" in names
    assert (ROOT / "dpdist_tpu_torch" / "native" / "src" / "pointcloud_native.cpp").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
