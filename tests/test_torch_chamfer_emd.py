"""The port's chamfer (ops/chamfer.py), EMD (ops/emd.py) and their losses
against dpdist_tpu's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.losses.standard import chamfer_loss as jax_chamfer_loss
from dpdist_tpu.losses.standard import emd_loss as jax_emd_loss
from dpdist_tpu.ops.chamfer import chamfer_distance as jax_chamfer
from dpdist_tpu.ops.chamfer import nn_distance as jax_nn_distance
from dpdist_tpu.ops.chamfer import pairwise_sqdist as jax_pairwise_sqdist
from dpdist_tpu.ops.emd import earth_mover_distance as jax_emd
from dpdist_tpu.ops.emd import sinkhorn_emd as jax_sinkhorn_emd

from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist
from dpdist_tpu_torch.losses import chamfer_loss, emd_loss
from dpdist_tpu_torch.ops import (
    chamfer_distance,
    earth_mover_distance,
    nn_distance,
    pairwise_sqdist,
    sinkhorn_emd,
)

# Chamfer against JAX: both form the matrix by the matmul identity in
# float32; the sums and the matmul run in other orders.
TOL_CHAMFER = 1e-5
# EMD: 50 Sinkhorn iterations in float32 on both sides.
TOL_EMD, TOL_EMD_GRAD = 1e-5, 1e-4


def _pair(seed, B=2, N=64, M=None):
    r = np.random.default_rng(seed)
    a = r.uniform(-0.8, 0.8, (B, N, 3)).astype(np.float32)
    b = r.uniform(-0.8, 0.8, (B, M or N, 3)).astype(np.float32)
    return a, b


def test_pairwise_and_nn_distance_match_jax():
    a, b = _pair(0, M=90)
    want = np.asarray(jax_pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = pairwise_sqdist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.min() >= 0.0
    jd1, ji1, jd2, ji2 = (np.asarray(t) for t in jax_nn_distance(jnp.asarray(a), jnp.asarray(b)))
    d1, i1, d2, i2 = nn_distance(torch.as_tensor(a), torch.as_tensor(b))
    assert i1.dtype == torch.int32 and i2.dtype == torch.int32
    np.testing.assert_array_equal(i1.numpy(), ji1)
    np.testing.assert_array_equal(i2.numpy(), ji2)
    np.testing.assert_allclose(d1.numpy(), jd1, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d2.numpy(), jd2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("sqrt", [True, False])
@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_chamfer_distance_matches_jax(sqrt, impl):
    """On the CPU "auto" takes the plain path too: the kernel serves CUDA
    tensors only."""
    a, b = _pair(1, M=90)
    want = float(jax_chamfer(jnp.asarray(a), jnp.asarray(b), sqrt=sqrt))
    got = float(chamfer_distance(torch.as_tensor(a), torch.as_tensor(b), sqrt=sqrt, impl=impl))
    assert abs(got - want) <= TOL_CHAMFER
    assert nn_min_sqdist.launches == 0


def test_chamfer_distance_gradient_matches_jax():
    """The plain path is differentiable, as the reference's XLA path is."""
    a, b = _pair(2)
    ja, jb = jax.grad(lambda x, y: jax_chamfer(x, y), (0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    ga, gb = torch.autograd.grad(chamfer_distance(ta, tb), (ta, tb))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)


def test_chamfer_rejects_unknown_impl():
    a, b = (torch.as_tensor(x) for x in _pair(3, B=1, N=4))
    with pytest.raises(ValueError, match="impl"):
        chamfer_distance(a, b, impl="pallas")


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_emd_and_gradient_match_jax(seed):
    a, b = _pair(10 + seed)
    want = np.asarray(jax_sinkhorn_emd(jnp.asarray(a), jnp.asarray(b)))
    jga, jgb = jax.grad(lambda x, y: jnp.sum(jax_sinkhorn_emd(x, y) * jnp.arange(1.0, 3.0)),
                        (0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = sinkhorn_emd(ta, tb)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL_EMD, rtol=0)
    ga, gb = torch.autograd.grad((got * torch.arange(1.0, 3.0)).sum(), (ta, tb))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), atol=TOL_EMD_GRAD, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), atol=TOL_EMD_GRAD, rtol=0)


def test_earth_mover_distance_matches_jax_and_needs_equal_sizes():
    a, b = _pair(12)
    want = float(jax_emd(jnp.asarray(a), jnp.asarray(b), iters=30))
    got = float(earth_mover_distance(torch.as_tensor(a), torch.as_tensor(b), iters=30))
    assert abs(got - want) <= TOL_EMD
    with pytest.raises(ValueError, match="unequal"):
        earth_mover_distance(torch.zeros(1, 4, 3), torch.zeros(1, 5, 3))


def test_losses_match_jax():
    a, b = _pair(13)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    assert abs(float(chamfer_loss(ta, tb, sqrt=False))
               - float(jax_chamfer_loss(ja, jb, sqrt=False))) <= TOL_CHAMFER
    assert abs(float(emd_loss(ta, tb, iters=20)) - float(jax_emd_loss(ja, jb, iters=20))) <= TOL_EMD
