"""The port's dense evaluation and views (dpdist_tpu_torch/eval/dense.py and
eval/viz.py) against dpdist_tpu on the CPU, at the size of
tests/test_dense_eval.py (embedding 64 on 4^3, k = 3, mlp (32, 32, 32)),
JAX-initialised weights carried across; and the ops the variants add
(the 2-D grid, voxels and patches, the 7-channel, unnormalised and
flattened 3DmFV, the occupancy volumes)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.eval import viz as jax_viz
from dpdist_tpu.eval.dense import dense_point_to_surface as jax_dense
from dpdist_tpu.eval.dense import distance_field as jax_distance_field
from dpdist_tpu.models import init_dpdist as jax_init

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.eval import viz
from dpdist_tpu_torch.eval.dense import dense_point_to_surface, distance_field
from dpdist_tpu_torch.models.dpdist import forward_dpdist
from dpdist_tpu_torch.train import params_from_jax

# The modules (each package's ops/__init__ exports functions of these names).
jax_threedmfv = importlib.import_module("dpdist_tpu.ops.threedmfv")
jax_voxel = importlib.import_module("dpdist_tpu.ops.voxel")
tmfv = importlib.import_module("dpdist_tpu_torch.ops.threedmfv")
tvoxel = importlib.import_module("dpdist_tpu_torch.ops.voxel")

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
VARIANTS = {
    "canonical": {},
    "bn": dict(use_bn=True),
    "conv3": dict(conv_version=3),
    "small_fv": dict(full_fv=False),
    "k0": dict(k=0),
    "pointnet": dict(encoder="pointnet", k=0, use_bn=True, pointnet_embedding=64),
    "dims2": dict(dims=2, output_channels=2),
}
# Port against JAX, both on the CPU (tests/test_dense_eval.py's bound for
# its own two paths is 2e-5; the port's paths sum in other orders).
TOL = 1e-5
# The port's kernel-route dense path (the patch-only gather's plain
# version) against its plain composition: the same values.
TOL_ROUTE = 1e-6


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(name, seed=0):
    fields = {**SMALL, **VARIANTS[name]}
    jcfg, tcfg = JaxConfig(**fields), DPDistConfig(**fields)
    jp, js = jax.device_get(jax_init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, jp, js), (tcfg, params_from_jax(jp, "cpu"), params_from_jax(js, "cpu"))


def _clouds(dims, N_q, seed=0, B=2):
    r = np.random.default_rng(seed)
    return (r.uniform(-0.8, 0.8, (B, 16, dims)).astype(np.float32),
            r.uniform(-0.95, 0.95, (B, N_q, dims)).astype(np.float32))


CASES = ([("canonical", p) for p in ("off", "on", "auto")]
         + [(n, "off") for n in VARIANTS if n != "canonical"]
         + [("small_fv", "on"), ("dims2", "on")])


@pytest.mark.parametrize("name,pretransform", CASES)
def test_dense_matches_jax(name, pretransform):
    """dense_point_to_surface against JAX's at 512 queries (at least 4 V,
    so "auto" folds the first layer into the table), within TOL."""
    (jcfg, jp, js), (tcfg, tp, ts) = _net(name)
    cloud, q = _clouds(jcfg.dims, 512, seed=len(name))
    want = jax_dense(jp, js, jcfg, jnp.asarray(cloud), jnp.asarray(q), pretransform=pretransform)
    got = dense_point_to_surface(tp, tcfg, torch.as_tensor(cloud), torch.as_tensor(q), state=ts,
                                 pretransform=pretransform)
    assert got.shape == want.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["canonical", "conv3", "k0"])
def test_dense_matches_the_bidirectional_forward(name):
    """Dense evaluation is the forward's pred_AB channel 0 (JAX's own
    check, tests/test_dense_eval.py), and the kernel route's plain versions
    (the patch-only gather) give the plain composition's values."""
    _, (tcfg, tp, ts) = _net(name, seed=1)
    cloud, q = (torch.as_tensor(c) for c in _clouds(3, 16, seed=3))
    pred_AB, _, _ = forward_dpdist(tp, ts, tcfg, cloud, q)
    for mode in ("auto", "table", "off"):
        d = dense_point_to_surface(tp, tcfg.replace(fused_gather=mode), cloud, q, state=ts,
                                   pretransform="off")
        np.testing.assert_allclose(d.numpy(), pred_AB[..., 0].numpy(), atol=TOL_ROUTE, rtol=0)


def test_distance_field_matches_jax():
    """distance_field at resolution 16 (4,096 queries, the pretransformed
    path) against JAX's, in the reference's (x, y, z) order."""
    (jcfg, jp, js), (tcfg, tp, ts) = _net("canonical")
    cloud, _ = _clouds(3, 1, seed=5, B=1)
    want = jax_distance_field(jp, js, jcfg, jnp.asarray(cloud), resolution=16)
    got = distance_field(tp, tcfg, torch.as_tensor(cloud), state=ts, resolution=16)
    assert got.shape == want.shape == (1, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_dense_refuses_a_mesh_and_unknown_modes():
    """A points axis that does not divide the queries raises, as the
    reference asserts (dpdist_tpu/eval/dense.py:94,121), before any
    collective; so does an unknown pretransform mode."""
    from dpdist_tpu_torch.parallel import Mesh

    _, (tcfg, tp, ts) = _net("canonical")
    cloud, q = (torch.as_tensor(c) for c in _clouds(3, 8))
    three = Mesh({"data": 1, "points": 3}, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by points=3"):
        dense_point_to_surface(tp, tcfg, cloud, q, mesh=three)
    with pytest.raises(ValueError, match="pretransform"):
        dense_point_to_surface(tp, tcfg, cloud, q, pretransform="sometimes")


# ---------------------------------------------------------------------------
# Views
# ---------------------------------------------------------------------------

def test_point_cloud_three_views_matches_jax():
    r = np.random.default_rng(7)
    pts = r.uniform(-1.1, 1.1, (500, 3)).astype(np.float32)
    want = jax_viz.point_cloud_three_views(pts, img_size=32)
    got = viz.point_cloud_three_views(torch.as_tensor(pts), img_size=32)
    assert got.shape == want.shape == (32, 96)
    np.testing.assert_array_equal(got, want)


def test_save_three_views_and_loss_curve(tmp_path):
    """Files where matplotlib is present, None where it is not, as JAX's."""
    pts = np.random.default_rng(8).uniform(-1, 1, (100, 3)).astype(np.float32)
    for name, fn, jfn, arg in (("views", viz.save_three_views, jax_viz.save_three_views, pts),
                               ("loss", viz.save_loss_curve, jax_viz.save_loss_curve,
                                [0.3, 0.2, 0.15])):
        want = jfn(str(tmp_path / f"jax_{name}.png"), arg)
        got = fn(str(tmp_path / f"{name}.png"), arg)
        assert (got is None) == (want is None)
        if got is not None:
            assert (tmp_path / f"{name}.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# Ops the variants add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims,G", [(2, 64), (3, 64)])
@pytest.mark.parametrize("full_fv,normalize,flatten",
                         [(True, True, True), (False, True, False), (False, False, True),
                          (True, False, False)])
def test_threedmfv_variants_match_jax(dims, G, full_fv, normalize, flatten):
    """The plain encode's 2-D, 7-channel (5 in 2-D), unnormalised and
    flattened (channel-major) forms against JAX's XLA encode; the grids in
    the reference's flat order."""
    np.testing.assert_array_equal(tmfv.threedmfv_grid(G, dims),
                                  jax_threedmfv.threedmfv_grid(G, dims))
    pts = np.random.default_rng(dims + G).uniform(-0.9, 0.9, (2, 32, dims)).astype(np.float32)
    kw = dict(flatten=flatten, normalize=normalize, full_fv=full_fv)
    want = np.asarray(jax_threedmfv.threedmfv(jnp.asarray(pts), G, 0.25, impl="xla", **kw))
    got = tmfv.threedmfv(torch.as_tensor(pts), G, 0.25, **kw).numpy()
    C = (2 + 6 * dims) if full_fv else (1 + 2 * dims)
    assert got.shape == want.shape == ((2, C * G) if flatten else (2, G, C))
    np.testing.assert_allclose(got, want, atol=2e-5 * max(1.0, float(np.abs(want).max())),
                               rtol=0)


def test_threedmfv_kernel_dispatch_follows_the_reference():
    """The streaming kernel computes only the 3-D full_fv normalized encode:
    forcing it on another raises, as the reference's impl="pallas"."""
    pts = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="3-D full_fv normalized"):
        tmfv.threedmfv(pts, 64, 0.25, impl="kernel")
    assert tmfv.kernel_computes(3) and not tmfv.kernel_computes(3, full_fv=False)
    assert not tmfv.kernel_computes(2) and not tmfv.kernel_computes(3, normalize=False)


def test_2d_voxels_and_patches_match_jax():
    """grid_centers, voxel_assign (points on cell edges and off the grid)
    and SAME-padded extract_patches_2d on a 2-D grid."""
    g, k = 8, 3
    np.testing.assert_array_equal(tvoxel.grid_centers(g * g, 2), jax_voxel.grid_centers(g * g, 2))
    r = np.random.default_rng(9)
    q = r.uniform(-1.2, 1.2, (2, 40, 2)).astype(np.float32)
    q[0, :5] = (-1.0 + 0.25 * np.arange(5))[:, None]
    want = jax_voxel.voxel_assign(jnp.asarray(q), g)
    got = tvoxel.voxel_assign(torch.as_tensor(q), g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fv = r.normal(size=(2, g * g, 5)).astype(np.float32)
    np.testing.assert_array_equal(tvoxel.extract_patches_2d(torch.as_tensor(fv), g, k).numpy(),
                                  np.asarray(jax_voxel.extract_patches_2d(jnp.asarray(fv), g, k)))


def test_occupancy_volumes_match_jax():
    r = np.random.default_rng(10)
    pts = r.uniform(-1.05, 1.05, (3, 200, 3)).astype(np.float32)
    want = np.asarray(jax_voxel.point_cloud_to_volume(pts, vsize=12))
    got = tvoxel.point_cloud_to_volume(torch.as_tensor(pts), vsize=12).numpy()
    np.testing.assert_array_equal(got, want)
    single = tvoxel.point_cloud_to_volume(pts[0], vsize=12).numpy()
    np.testing.assert_array_equal(single, want[0])
    np.testing.assert_array_equal(tvoxel.volume_to_point_cloud(torch.as_tensor(single)),
                                  jax_voxel.volume_to_point_cloud(want[0]))
    assert tvoxel.volume_to_point_cloud(np.zeros((4, 4, 4))).shape == (0, 3)
