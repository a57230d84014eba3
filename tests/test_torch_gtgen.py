"""The ground-truth generator (data/gtgen.py) against dpdist_tpu, on the
CPU: the same files byte for byte for the same seed (both packages run the
same native source for the distances), the samplers, and the distances of
the native and numpy paths. Row 8 on the card (min_distances on CUDA) is
held to the native library in tests/test_torch_kernels_gpu.py and
chip_smoke.py."""

import os

import numpy as np
import pytest

from dpdist_tpu.data import gtgen as jax_gtgen
from dpdist_tpu.native import min_distances_native as jax_min_native

from dpdist_tpu_torch.data import gtgen
from dpdist_tpu_torch.native import lib as native
from reference_native import _reference_native_so, reference_native  # noqa: F401

# numpy's expanded form |q|^2 + |d|^2 - 2 q.d against the native
# per-dimension form: float32 cancellation near 0, then a sqrt.
TOL_NUMPY = 2e-3


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("scheme", ["dropped_coordinates", "cube"])
def test_synthetic_dataset_files_equal_jax(tmp_path, scheme, reference_native):
    kw = dict(families=("chair", "sphere"), n_train=2, n_test=1, n_surface=2000,
              num_neg_points=300, seed=4, scheme=scheme)
    gtgen.generate_synthetic_dataset(str(tmp_path / "mine"), device="cpu", **kw)
    jax_gtgen.generate_synthetic_dataset(str(tmp_path / "ref"), **kw)
    mine, ref = _files(tmp_path / "mine"), _files(tmp_path / "ref")
    assert sorted(mine) == sorted(ref) and len(mine) == 2 * 3 * 3 + 3
    assert all(mine[k] == ref[k] for k in ref)


@pytest.mark.parametrize("scheme", gtgen.SAMPLING_SCHEMES)
def test_uniform_sampling_equals_jax(scheme):
    got = gtgen.uniform_sampling(np.random.default_rng(1), 500, scheme)
    want = jax_gtgen.uniform_sampling(np.random.default_rng(1), 500, scheme)
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        gtgen.uniform_sampling(np.random.default_rng(1), 5, "grid")


def test_min_distances_native_and_numpy(monkeypatch, reference_native):
    """The native path equals dpdist_tpu's native path bit for bit; the
    numpy path (the fallback where the native library is missing), tiled
    here, agrees within TOL_NUMPY."""
    r = np.random.default_rng(2)
    q = r.uniform(-1, 1, (3000, 3)).astype(np.float32)
    d = r.uniform(-0.8, 0.8, (2500, 3)).astype(np.float32)
    got = gtgen.min_distances(q, d, device="cpu")
    assert got.dtype == np.float32 and np.array_equal(got, jax_min_native(q, d))
    monkeypatch.setattr(gtgen, "_NUMPY_PAIRS", 10 ** 6)   # several tiles
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)          # as if the build had failed
    numpy_path = gtgen.min_distances(q, d, device="cpu")
    np.testing.assert_allclose(numpy_path, got, atol=TOL_NUMPY, rtol=0)


def test_min_distances_on_cuda_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        gtgen.min_distances(np.zeros((4, 3), np.float32), np.ones((5, 3), np.float32),
                            device="cuda")
