"""The per-query patch gather of fused_gather="on" (kernels/gather_fused.py,
the plain version of csrc/gather_fused.cu) and the "on" model path, against
dpdist_tpu: its neighbour ids, its Pallas kernel in interpret mode, and its
model forward and gradients.

On the CPU the wrapper runs its plain version inside its autograd Function,
so the backward the card runs (the adjoint gather on the masked gradient)
is exercised here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.kernels.gather_pallas import gather_patches_fused as jax_gather_fused
from dpdist_tpu.kernels.gather_pallas import neighbor_ids as jax_neighbor_ids
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused, gather_patches_fused_plain
from dpdist_tpu_torch.kernels.table_gather import table_gather_bwd
from dpdist_tpu_torch.models import apply_dpdist
from dpdist_tpu_torch.models.dpdist import Route, route
from dpdist_tpu_torch.ops.voxel import neighbor_ids, voxel_assign
from dpdist_tpu_torch.train import params_from_jax

# (grid_size, k, C): the canonical window and the JAX kernel tests' small one.
WINDOWS = [(8, 5, 20), (4, 3, 7)]
# Model forward and gradients, port against JAX (tests/test_kernels.py:49-71).
TOL = 2e-5
SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))


def _queries(g, seed, B=2, N=40):
    """Queries partly off the grid, with coordinates on cell edges (-1, 1
    and in between)."""
    r = np.random.default_rng(seed)
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    pick = r.random(q.shape) < 0.15
    q[pick] = r.choice(edges, pick.sum())
    return q


def _both(q, g):
    jv, jm, _ = jax_voxel_assign(jnp.asarray(q), g)
    tv, tm, _ = voxel_assign(torch.as_tensor(q), g)
    assert np.array_equal(np.asarray(jv), tv.numpy()) and np.array_equal(np.asarray(jm), tm.numpy())
    assert float(tm.min()) == 0.0   # some queries off the grid
    return (jv, jm), (tv, tm)


@pytest.mark.parametrize("g,k,C", WINDOWS)
def test_neighbor_ids_match_jax(g, k, C):
    (jv, jm), (tv, tm) = _both(_queries(g, 0), g)
    want = np.asarray(jax_neighbor_ids(jv, jm, g, k))
    got = neighbor_ids(tv, tm, g, k)
    assert got.dtype == torch.int32 and got.shape == (*tv.shape, k ** 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[tm == 0] == -1).all()                 # off-grid queries: every id -1
    assert ((got == -1) & (tm[..., None] > 0)).any()  # in-grid queries with off-grid neighbours


@pytest.mark.parametrize("g,k,C", WINDOWS)
def test_plain_matches_pallas_interpret(g, k, C):
    """A pure copy: equal to the Pallas kernel, zero rows off the grid."""
    (jv, jm), (tv, tm) = _both(_queries(g, 1), g)
    fv = np.random.default_rng(2).normal(size=(2, g ** 3, C)).astype(np.float32)
    want = np.asarray(jax_gather_fused(jnp.asarray(fv), jv, jm, grid_size=g, k=k, interpret=True))
    got = gather_patches_fused_plain(torch.as_tensor(fv), tv, tm, g, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[tm == 0].any()


@pytest.mark.parametrize("g,k,C", WINDOWS)
def test_wrapper_on_cpu_and_its_backward(g, k, C):
    """The wrapper on CPU tensors: the plain version, no kernel launch, and
    its backward (table_gather_bwd on the masked gradient) against
    autograd through the plain version and against JAX's VJP."""
    (jv, jm), (tv, tm) = _both(_queries(g, 3), g)
    r = np.random.default_rng(4)
    fv = r.normal(size=(2, g ** 3, C)).astype(np.float32)
    grad = r.normal(size=(2, tv.shape[1], k ** 3 * C)).astype(np.float32)
    before = gather_patches_fused.launches
    outs = []
    for fn in (gather_patches_fused, gather_patches_fused_plain):
        f = torch.tensor(fv, requires_grad=True)
        out = fn(f, tv, tm, g, k)
        outs.append((out.detach(), torch.autograd.grad(out, f, torch.as_tensor(grad))[0]))
    assert gather_patches_fused.launches == before
    (out, dfv), (out_ref, dfv_ref) = outs
    assert torch.equal(out, out_ref)
    np.testing.assert_allclose(dfv.numpy(), dfv_ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dfv.numpy(), table_gather_bwd(tv, torch.as_tensor(grad) * tm[..., None], g, k).numpy(),
        rtol=0, atol=0)
    _, vjp = jax.vjp(lambda x: jax_gather_fused(x, jv, jm, grid_size=g, k=k, interpret=True),
                     jnp.asarray(fv))
    np.testing.assert_allclose(dfv.numpy(), np.asarray(vjp(jnp.asarray(grad))[0]),
                               rtol=1e-5, atol=1e-5)


def _args(**change):
    r = np.random.default_rng(5)
    fv = torch.as_tensor(r.normal(size=(2, 64, 20)).astype(np.float32))
    vox, mask, _ = voxel_assign(torch.as_tensor(_queries(4, 6, N=8)), 4)
    args = {"fv": fv, "vox": vox, "mask": mask, "grid_size": 4, "k": 3}
    args.update(change)
    return args


@pytest.mark.parametrize("case,exc", [
    ({"fv": torch.zeros(2, 64, 20, dtype=torch.float64)}, TypeError),
    ({"vox": torch.zeros(2, 8, dtype=torch.int64)}, TypeError),
    ({"mask": torch.ones(2, 8, dtype=torch.bool)}, TypeError),
    ({"mask": torch.ones(2, 7)}, ValueError),
    ({"fv": torch.zeros(2, 20, 64).transpose(1, 2)}, ValueError),
    ({"grid_size": 5}, ValueError),
    ({"k": 4}, ValueError),
    ({"fv": torch.zeros(3, 64, 20)}, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    with pytest.raises(exc):
        gather_patches_fused(**_args(**case))


@pytest.mark.parametrize("n,grad", [(64, False), (64, True), (300, False), (300, True)])
def test_route_on(n, grad):
    """"on" keeps its mode forward and under a gradient, on either device:
    each cloud's encode by its size, the per-query gather both ways."""
    encode = ("threedmfv",) * 2 if n >= 128 else ("plain",) * 2
    want = Route("on", encode, ("gather_patches_fused",) * 2)
    cfg = DPDistConfig(fused_gather="on")
    assert route(cfg, "cuda", n, n, grad=grad) == want
    assert route(cfg, "cpu", n, n, grad=grad) == want


@pytest.fixture(scope="module")
def small_net():
    jcfg = JaxConfig(**SMALL)
    params, state = jax_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, state


def test_on_forward_and_gradients_match_jax(small_net):
    """fused_gather="on": predictions, the parameters' gradients and d/dpcA
    of mean(pred_AB[..., 0]) within TOL of JAX's, which runs its Pallas
    kernel in interpret mode and its XLA-backed VJP. Some queries lie off
    the grid (zero rows, zero predictions)."""
    jcfg, params, state = small_net
    r = np.random.default_rng(7)
    pcA = r.uniform(-0.8, 0.8, (2, 16, 3)).astype(np.float32)
    pcB = r.uniform(-1.2, 1.2, (2, 16, 3)).astype(np.float32)
    jon = jcfg.replace(fused_gather="on")

    def jax_loss(p, a):
        pred_AB, _, _ = jax_apply(p, state, jon, a, jnp.asarray(pcB))
        return jnp.mean(pred_AB[..., 0])

    jAB, jBA, _ = jax_apply(params, state, jon, jnp.asarray(pcA), jnp.asarray(pcB))
    jg_params, jg_a = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(pcA))

    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    leaves = [lp[key].requires_grad_(True) for lp in tparams["decoder"]["layers"]
              for key in ("w", "b")]
    a = torch.tensor(pcA, requires_grad=True)
    before = gather_patches_fused.launches
    pAB, pBA = apply_dpdist(tparams, DPDistConfig(**SMALL, fused_gather="on"), a,
                            torch.as_tensor(pcB))
    grads = torch.autograd.grad(pAB[..., 0].mean(), [a] + leaves)
    assert gather_patches_fused.launches == before
    np.testing.assert_allclose(pAB.detach().numpy(), np.asarray(jAB), atol=TOL, rtol=0)
    np.testing.assert_allclose(pBA.detach().numpy(), np.asarray(jBA), atol=TOL, rtol=0)
    assert np.asarray(jAB)[..., 0].min() == 0.0
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_a), atol=TOL, rtol=0)
    want = [np.asarray(lp[key]) for lp in jg_params["decoder"]["layers"] for key in ("w", "b")]
    for got, w in zip(grads[1:], want):
        np.testing.assert_allclose(got.numpy(), w, atol=TOL, rtol=0)
