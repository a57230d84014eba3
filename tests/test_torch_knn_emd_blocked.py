"""The port's kNN (dpdist_tpu_torch/ops/knn.py) and blocked Sinkhorn EMD
(ops/emd.py:sinkhorn_emd_blocked) against dpdist_tpu's, on the CPU.

kNN: equal indices, ties included (duplicated points and a lattice, where
lax.top_k breaks ties by the lower index and torch.topk promises no
order). Blocked EMD: against JAX's at tiles that pad both clouds, against
the port's dense sinkhorn_emd on the same schedule, and against scipy's
exact assignment at small N.

Tolerances: the blocked EMD within 1e-5 relative of JAX's (float32
logsumexps in another order over 30-40 iterations); against the dense plan
3 % + 1e-3 and against the exact assignment 3 % + 1e-3 (an entropic plan
at eps_end 0.01, the JAX package's own bounds, tests/test_losses.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from dpdist_tpu.ops.emd import sinkhorn_emd_blocked as jax_blocked
from dpdist_tpu.ops.knn import knn as jax_knn
from dpdist_tpu.ops.knn import pairwise_distance as jax_pairwise

from dpdist_tpu_torch.ops import knn, pairwise_distance, sinkhorn_emd, sinkhorn_emd_blocked

TOL_JAX = 1e-5


def _tied_clouds():
    """Points on a coarse lattice (many equal distances) with duplicates."""
    r = np.random.default_rng(0)
    pts = r.integers(-2, 3, size=(3, 40, 3)).astype(np.float32) * 0.25
    pts[:, 20:30] = pts[:, :10]                 # exact duplicates
    return pts


@pytest.mark.parametrize("k,exclude_self", [(1, False), (4, False), (7, True), (40, False)])
def test_knn_matches_jax_with_ties(k, exclude_self):
    pts = _tied_clouds()
    want = np.asarray(jax_knn(jnp.asarray(pts), k, exclude_self=exclude_self))
    got = knn(torch.as_tensor(pts), k, exclude_self=exclude_self)
    assert got.shape == (3, 40, k)
    np.testing.assert_array_equal(got.numpy(), want)
    d = pairwise_distance(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(d, np.asarray(jax_pairwise(jnp.asarray(pts))), atol=1e-6)
    if exclude_self:
        assert not (got.numpy() == np.arange(40)[None, :, None]).any()


def test_knn_random_matches_bruteforce():
    pts = np.random.default_rng(1).normal(size=(2, 32, 3)).astype(np.float32)
    got = knn(torch.as_tensor(pts), 4).numpy()
    for b in range(2):
        for n in range(32):
            assert list(got[b, n]) == list(np.argsort(cdist(pts[b], pts[b])[n], kind="stable")[:4])


CASES = [((2, 96, 3), (2, 160, 3), 32, 40), ((1, 50, 3), (1, 37, 3), 16, 30),
         ((1, 64, 3), (1, 64, 3), 64, 30)]


@pytest.mark.parametrize("xs,ys,tile,iters", CASES)
def test_blocked_emd_matches_jax(xs, ys, tile, iters):
    r = np.random.default_rng(sum(xs) + tile)
    x = r.normal(size=xs).astype(np.float32)
    y = r.normal(size=ys).astype(np.float32)
    want = np.asarray(jax_blocked(jnp.asarray(x), jnp.asarray(y), iters=iters, tile=tile))
    got = sinkhorn_emd_blocked(torch.as_tensor(x), torch.as_tensor(y), iters=iters, tile=tile)
    assert got.shape == (xs[0],) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_JAX)


def test_blocked_emd_matches_dense_and_exact():
    r = np.random.default_rng(3)
    x = torch.as_tensor(r.normal(size=(2, 96, 3)).astype(np.float32))
    y = torch.as_tensor(r.normal(size=(2, 160, 3)).astype(np.float32))
    dense = sinkhorn_emd(x, y, 40, 0.5, 0.01)
    blocked = sinkhorn_emd_blocked(x, y, iters=40, tile=32)
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), rtol=0.03, atol=1e-3)
    a = r.normal(size=(1, 48, 3)).astype(np.float32)
    b = r.normal(size=(1, 48, 3)).astype(np.float32)
    D = cdist(a[0], b[0])
    rows, cols = linear_sum_assignment(D)
    exact = D[rows, cols].sum() / 48.0
    got = float(sinkhorn_emd_blocked(torch.as_tensor(a), torch.as_tensor(b), iters=60,
                                     tile=16)[0])
    assert abs(got - exact) <= 0.03 * exact + 1e-3, (got, exact)
    same = float(sinkhorn_emd_blocked(torch.as_tensor(a), torch.as_tensor(a), tile=16)[0])
    assert same < 0.1
