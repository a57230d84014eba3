"""The fused 3DmFV + patch-gather wrapper (kernels/mfv_gather.py) against
dpdist_tpu's mfv_table_gather_x.

On the CPU the wrapper runs its plain version; the CUDA kernel itself runs
only on a card (tests/test_torch_kernels_gpu.py).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpdist_tpu.kernels.mfv_gather_pallas import mfv_table_gather_x as jax_mfv_x
from dpdist_tpu.ops.threedmfv import threedmfv as jax_threedmfv
from dpdist_tpu.ops.voxel import extract_patches as jax_extract_patches
from dpdist_tpu.ops.voxel import gather_patches as jax_gather_patches
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.kernels import build, mfv_gather
from dpdist_tpu_torch.kernels.mfv_gather import mfv_table_gather_x, mfv_x, mfv_x_plain

# The encode's tolerance in the JAX package's own kernel test
# (tests/test_kernels.py:342): both sides sum in other orders, and the
# reference forms squared distances by the matmul identity.
TOL = 2e-5


def test_plain_matches_pallas_interpret_small(rng):
    """At the JAX kernel test's config, against the Pallas kernel run in
    interpret mode; queries include off-grid points, M is not a multiple of 8."""
    B, M, N, G, g, k, sigma = 2, 12, 16, 64, 4, 3, 0.25
    pts = rng.uniform(-0.9, 0.9, (B, M, 3)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    want = np.asarray(jax_mfv_x(jnp.asarray(pts), jnp.asarray(q), G, sigma, g, k,
                                interpret=True))
    got = mfv_table_gather_x(torch.as_tensor(pts), torch.as_tensor(q), G, sigma, g, k)
    assert got.shape == want.shape == (B, N, 3 + k ** 3 * 20)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_plain_matches_jax_composition_canonical(rng):
    """At canonical G=512, k=5 against the XLA composition the JAX model
    runs off the TPU: threedmfv -> extract_patches -> voxel_assign -> gather."""
    B, M, N, G, g, k, sigma = 2, 64, 64, 512, 8, 5, 0.125
    pts = rng.uniform(-0.95, 0.95, (B, M, 3)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    q[0, :8] = np.float32([-1.0, -0.75, 0.0, 0.25, 0.5, 1.0, 0.999, -0.999])[:, None]
    fv = jax_threedmfv(jnp.asarray(pts), G, sigma, impl="xla")
    jvox, jmask, jdelta = jax_voxel_assign(jnp.asarray(q), g)
    emb = jax_gather_patches(jax_extract_patches(fv, g, k), jvox, jmask)
    want = np.asarray(jnp.concatenate([jdelta, emb], axis=-1))
    x, vox = mfv_x(torch.as_tensor(pts), torch.as_tensor(q), G, sigma, g, k)
    np.testing.assert_array_equal(vox.numpy(), np.asarray(jvox))
    np.testing.assert_allclose(x.numpy(), want, atol=TOL, rtol=0)


def test_cpu_call_launches_no_kernel(rng):
    pts = torch.as_tensor(rng.uniform(-0.9, 0.9, (2, 12, 3)).astype(np.float32))
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32))
    assert mfv_x.launches == 0
    x, vox = mfv_x(pts, q, 64, 0.25, 4, 3)
    assert mfv_x.launches == 0
    ref, ref_vox = mfv_x_plain(pts, q, 64, 0.25, 4, 3)
    assert torch.equal(x, ref) and torch.equal(vox, ref_vox)


@pytest.mark.parametrize("case,exc", [
    ("float64", TypeError),
    ("shape", ValueError),
    ("noncontiguous", ValueError),
    ("batch", ValueError),
    ("gaussians", ValueError),
    ("even_k", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    pts = torch.zeros(2, 8, 3)
    q = torch.zeros(2, 8, 3)
    G, g, k = 64, 4, 3
    if case == "float64":
        pts = pts.double()
    elif case == "shape":
        q = torch.zeros(2, 8, 2)
    elif case == "noncontiguous":
        pts = torch.zeros(2, 3, 8).transpose(1, 2)
    elif case == "batch":
        q = torch.zeros(3, 8, 3)
    elif case == "gaussians":
        G = 512
    elif case == "even_k":
        k = 4
    with pytest.raises(exc):
        mfv_x(pts, q, G, 0.25, g, k)


def test_requires_grad_inputs_give_the_plain_compositions_gradient(rng):
    """mfv_x with inputs that require a gradient (on the CPU: the plain
    forward, then the backward through the adjoint's plain version and the
    plain encode) gives autograd's gradient of the plain composition."""
    pts = rng.uniform(-0.9, 0.9, (2, 12, 3)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32)
    co = torch.as_tensor(rng.normal(size=(2, 16, 3 + 27 * 20)).astype(np.float32))
    grads = []
    for fn in (mfv_x, mfv_x_plain):
        tp, tq = torch.tensor(pts, requires_grad=True), torch.tensor(q, requires_grad=True)
        x = fn(tp, tq, 64, 0.25, 4, 3)[0]
        grads.append(torch.autograd.grad((x * co).sum(), (tp, tq)))
    (dp, dq), (dp_ref, dq_ref) = grads
    assert torch.equal(dq, dq_ref)
    # The same arithmetic, with the adjoint's sums in another order.
    np.testing.assert_allclose(dp.numpy(), dp_ref.numpy(), atol=1e-5, rtol=1e-5)
    assert mfv_x.launches == 0


@pytest.mark.parametrize("how", ["no_grad", "no_input_needs_grad"])
def test_wrapper_without_a_gradient_records_no_graph(rng, monkeypatch, how):
    """Where no gradient is recorded (grad mode off, or neither input needs
    one) mfv_x skips its autograd Function: x has no grad_fn and equals the
    plain version; on the CPU nothing is launched (the counter counts kernel
    launches only)."""
    pts = torch.as_tensor(rng.uniform(-0.9, 0.9, (2, 12, 3)).astype(np.float32))
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32))
    if how == "no_grad":
        pts.requires_grad_(True)
        q.requires_grad_(True)

    def refuse(*_):
        raise AssertionError("the autograd Function ran")

    monkeypatch.setattr(mfv_gather._MfvX, "apply", refuse)
    before = mfv_x.launches
    with torch.no_grad() if how == "no_grad" else contextlib.nullcontext():
        x, vox = mfv_x(pts, q, 64, 0.25, 4, 3)
    assert x.grad_fn is None and not x.requires_grad
    assert mfv_x.launches == before
    ref, ref_vox = mfv_x_plain(pts.detach(), q.detach(), 64, 0.25, 4, 3)
    assert torch.equal(x, ref) and torch.equal(vox, ref_vox)


@pytest.mark.parametrize("needs", ["points", "queries"])
def test_one_input_needing_a_gradient_gets_the_plain_compositions_gradient(rng, needs):
    """Only one input needing a gradient still takes the autograd Function,
    and that input's gradient is autograd's through the plain composition."""
    pts = rng.uniform(-0.9, 0.9, (2, 12, 3)).astype(np.float32)
    q = rng.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32)
    co = torch.as_tensor(rng.normal(size=(2, 16, 3 + 27 * 20)).astype(np.float32))
    grads = []
    for fn in (mfv_x, mfv_x_plain):
        tp, tq = torch.tensor(pts), torch.tensor(q)
        t = tp if needs == "points" else tq
        t.requires_grad_(True)
        x = fn(tp, tq, 64, 0.25, 4, 3)[0]
        assert x.grad_fn is not None
        grads.append(torch.autograd.grad((x * co).sum(), t)[0])
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5, rtol=1e-5)


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "_build").exists()


def test_build_cache_key_follows_sources():
    path = build.library_path()
    assert path.name == "libdpdist_kernels.so"
    assert path.parent.parent == build.BUILD_DIR
    assert {"mfv_gather.cu", "table_gather.cu", "threedmfv.cu", "chamfer.cu", "gather_fused.cu",
            "fused_forward.cu"} <= {
        s.name for s in build.sources()}
