"""The port's comparison harness (dpdist_tpu_torch/eval/comparison.py) and
the compare_losses CLI against dpdist_tpu's, on the CPU, with the
committed canonical net: perturbation_sweep's per-magnitude means for
every perturbation kind (the same default_rng stream in the same order),
monotonicity, and the CLI's report JSON; the golden file's full report
(JAX at the CLI's defaults) reproduced by the port.

Tolerances: the DPDist means within 1e-4 (tests/test_torch_dpdist.py's
distance tolerance), chamfer and EMD within 1e-5
(tests/test_torch_chamfer_emd.py's).
"""

import json

import numpy as np
import pytest
import torch

from dpdist_tpu.cli import compare_losses as jax_cli
from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.eval.comparison import monotonicity as jax_monotonicity
from dpdist_tpu.eval.comparison import perturbation_sweep as jax_sweep

from dpdist_tpu_torch.cli import compare_losses
from dpdist_tpu_torch.data.golden import AUE_GOLDEN_PATH
from dpdist_tpu_torch.data.synthetic import synthetic_surface
from dpdist_tpu_torch.eval.comparison import monotonicity, perturbation_sweep
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, params_from_jax

NET = "results/ckpt_best"
TOL = {"dpdist": 1e-4, "chamfer": 1e-5, "emd": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_sweep(got, want):
    assert got["magnitudes"] == want["magnitudes"]
    for key, tol in TOL.items():
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("kind,mags", [("resample", (0.0,)), ("noise", (0.0, 0.05)),
                                       ("deform", (0.02, 0.2)), ("translate", (0.1,)),
                                       ("occlude", (0.0, 0.25))])
def test_perturbation_sweep_matches_jax(kind, mags):
    surfaces = np.stack([synthetic_surface(f, seed=i, n_points=256) * 0.8
                         for i, f in enumerate(("chair", "box"))])
    jcfg, jparams, jstate = jax_load(NET)
    want = jax_sweep(jparams, jstate, jcfg, surfaces, kind=kind, magnitudes=mags,
                     num_point=32, seed=4)
    cfg, params, _ = load_dpdist_checkpoint(NET)
    got = perturbation_sweep(params_from_jax(params, "cpu"), cfg, surfaces, kind=kind,
                             magnitudes=mags, num_point=32, seed=4, device="cpu")
    _close_sweep(got, want)
    assert monotonicity(got["dpdist"]) == jax_monotonicity(want["dpdist"])
    with pytest.raises(ValueError, match="unknown kind"):
        perturbation_sweep(params, cfg, surfaces, kind="shear", device="cpu")


def test_monotonicity():
    assert monotonicity([1.0]) == 1.0
    assert monotonicity([0.0, 1.0, 0.5, 2.0]) == pytest.approx(2 / 3)


def test_compare_losses_report_matches_jax(tmp_path):
    """The CLI at reduced size: the same report keys and values as JAX's."""
    args = ["--dpdist_ckpt", NET, "--n_surfaces", "2", "--num_point", "32",
            "--families", "chair", "sphere", "--kinds", "resample", "deform", "occlude",
            "--seed", "1"]
    jax_cli.main(args + ["--out", str(tmp_path / "jax.json")])
    got = compare_losses.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert list(got) == list(want)
    for kind in want:
        assert set(got[kind]) == set(want[kind])
        _close_sweep(got[kind], want[kind])
        assert got[kind]["dpdist_monotonicity"] == want[kind]["dpdist_monotonicity"]


def test_golden_compare_losses_report_holds():
    """The golden file's report: JAX's compare_losses at its defaults (8
    chairs, 64 points, every kind) on the canonical net, reproduced by the
    port on the CPU."""
    want = json.loads(AUE_GOLDEN_PATH.read_text())["compare_losses"]["report"]
    got = compare_losses.main(["--dpdist_ckpt", NET, "--device", "cpu"])
    assert list(got) == list(want)
    for kind in want:
        _close_sweep(got[kind], want[kind])
