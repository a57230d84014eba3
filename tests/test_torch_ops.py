"""The port's 3DmFV encode and voxel ops against dpdist_tpu's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpdist_tpu.ops.threedmfv import threedmfv as jax_threedmfv
from dpdist_tpu.ops.threedmfv import threedmfv_grid as jax_threedmfv_grid
from dpdist_tpu.ops.voxel import extract_patches as jax_extract_patches
from dpdist_tpu.ops.voxel import gather_patches as jax_gather_patches
from dpdist_tpu.ops.voxel import grid_centers as jax_grid_centers
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.ops import (
    extract_patches,
    gather_patches,
    grid_centers,
    threedmfv,
    threedmfv_grid,
    voxel_assign,
)

# Port against dpdist_tpu's XLA encode: the tolerance of the JAX package's
# own kernel-vs-XLA test (tests/test_kernels.py:342). The port forms the
# squared distances from per-dimension differences, the reference by the
# matmul identity; on these inputs the two differ by at most ~5e-6.
TOL_FV = 2e-5


def _clouds(seed, B=3, M=61):
    """M not a multiple of 8; a few points outside [-1, 1]^3."""
    r = np.random.default_rng(seed)
    return r.uniform(-1.1, 1.1, (B, M, 3)).astype(np.float32)


@pytest.mark.parametrize("n_gaussians", [512, 64])
def test_grids_equal_jax(n_gaussians):
    np.testing.assert_array_equal(threedmfv_grid(n_gaussians), jax_threedmfv_grid(n_gaussians))
    np.testing.assert_array_equal(grid_centers(n_gaussians), jax_grid_centers(n_gaussians))


@pytest.mark.parametrize("seed", [0, 1])
def test_threedmfv_matches_jax_xla(seed):
    pts = _clouds(seed)
    got = threedmfv(torch.as_tensor(pts), 512, 0.125)
    want = jax_threedmfv(jnp.asarray(pts), 512, 0.125, impl="xla")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_FV, rtol=0)


def test_threedmfv_accuracy_vs_float64():
    """Why the port forms d2 from per-dimension differences: against the
    same math in float64, it stays within 5e-6 on 64 clouds, where the
    reference's matmul-identity form drifts further (cancellation in the
    mean channels)."""
    r = np.random.default_rng(5)
    pts = r.uniform(-0.95, 0.95, (64, 64, 3)).astype(np.float32)
    mu = threedmfv_grid(512).astype(np.float64)
    p = pts.astype(np.float64)
    diff = (p[:, :, None, :] - mu[None, None]) / 0.125
    logits = -0.5 * (diff * diff).sum(-1)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    Q = e / e.sum(-1, keepdims=True)
    w, n = 1.0 / 512, pts.shape[1]
    dpi = (Q - w) / (np.sqrt(w) * n)
    dmu, dsg = Q[..., None] * diff, Q[..., None] * (diff * diff - 1)
    fv = np.concatenate([
        dpi.mean(1)[..., None], dpi.max(1)[..., None],
        dmu.mean(1) / np.sqrt(w), dmu.max(1) / np.sqrt(w), dmu.min(1) / np.sqrt(w),
        dsg.mean(1) / np.sqrt(2 * w), dsg.max(1) / np.sqrt(2 * w), dsg.min(1) / np.sqrt(2 * w)],
        axis=-1)
    fv = np.sign(fv) * np.sqrt(np.maximum(np.abs(fv), 1e-12))
    fv = fv / np.sqrt(np.maximum((fv * fv).sum(1, keepdims=True), 1e-12))
    port_err = np.abs(threedmfv(torch.as_tensor(pts), 512, 0.125).numpy() - fv).max()
    ref_err = np.abs(np.asarray(jax_threedmfv(jnp.asarray(pts), 512, 0.125, impl="xla"))
                     - fv).max()
    assert port_err <= 5e-6, port_err
    assert port_err < ref_err, (port_err, ref_err)


@pytest.mark.parametrize("g", [8, 4])
def test_voxel_assign_matches_jax_on_edges(g):
    """Points exactly on cell edges (strict below, inclusive above), at
    -1 and +1, and off-grid: vox and mask exact, delta to 1e-6."""
    r = np.random.default_rng(g)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    special = np.concatenate([edges, np.float32([-1.3, 1.2, -1.0000001, 1.0000001])])
    pts = r.uniform(-1.2, 1.2, (2, 200, 3)).astype(np.float32)
    pick = r.random(pts.shape) < 0.5
    pts[pick] = r.choice(special, pick.sum())
    vox, mask, delta = voxel_assign(torch.as_tensor(pts), g)
    jv, jm, jd = jax_voxel_assign(jnp.asarray(pts), g)
    assert vox.dtype == torch.int32
    np.testing.assert_array_equal(vox.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    assert 0 < mask.numpy().mean() < 1


@pytest.mark.parametrize("g,k", [(8, 5), (4, 3)])
def test_extract_patches_and_gather_exact(g, k):
    r = np.random.default_rng(k)
    fv = r.normal(size=(2, g ** 3, 20)).astype(np.float32)
    vox = r.integers(0, g ** 3, (2, 33)).astype(np.int32)
    table = extract_patches(torch.as_tensor(fv), g, k)
    jtable = jax_extract_patches(jnp.asarray(fv), g, k)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    got = gather_patches(table, torch.as_tensor(vox))
    want = jax_gather_patches(jtable, jnp.asarray(vox), jnp.ones(vox.shape, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
