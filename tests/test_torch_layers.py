"""The port's layers (dpdist_tpu_torch/nn/layers.py) against
dpdist_tpu/nn/layers.py on the CPU: BatchNorm in training, eval and its
EMA, every conv and pool (odd sizes, strides, SAME and VALID, the
transposed conv with an asymmetric kernel), truncated_normal, and the MLP
with BN. Inputs and JAX-initialised weights come from a numpy seed and are
carried across.

Tolerances: 1e-5 absolute on conv outputs and BN (float32 sums of up to a
few hundred products in other orders), exact on max pools, 1e-6 on
average pools; gradients 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.nn import layers as jl

from dpdist_tpu_torch.nn import layers as tl
from dpdist_tpu_torch.train.checkpoint import params_from_jax, tree_flatten_with_paths

TOL = 1e-5


def _t(tree):
    return params_from_jax(jax.device_get(tree), "cpu", model="layers")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    """Batch statistics (biased variance over every axis but the last, eps
    1e-3) in training, with the EMA of decay `momentum`; running
    statistics in eval."""
    r = np.random.default_rng(0)
    x = (r.normal(size=(3, 5, 7, 6)) * 3 + 1).astype(np.float32)
    jp, js = jl.batchnorm_init(6)
    jp = {"scale": jnp.asarray(r.uniform(0.5, 2, 6), jnp.float32),
          "offset": jnp.asarray(r.normal(size=6), jnp.float32)}
    js = {"mean": jnp.asarray(r.normal(size=6), jnp.float32),
          "var": jnp.asarray(r.uniform(0.5, 2, 6), jnp.float32)}
    want, jns = jl.batchnorm_apply(jp, js, jnp.asarray(x), train=train, momentum=0.7)
    got, tns = tl.batchnorm_apply(_t(jp), _t(js), torch.as_tensor(x), train=train,
                                  momentum=0.7)
    _close(got, want)
    for key in ("mean", "var"):
        _close(tns[key], jns[key], 1e-6)
        assert not tns[key].requires_grad


def test_batchnorm_init_and_grad_match_jax():
    jp, js = jl.batchnorm_init(4)
    tp, ts = tl.batchnorm_init(4)
    for a, b in ((jp, tp), (js, ts)):
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy())
    x = np.random.default_rng(1).normal(size=(2, 9, 4)).astype(np.float32)
    co = np.random.default_rng(2).normal(size=(2, 9, 4)).astype(np.float32)
    jgx, jgp = jax.grad(lambda x_, p_: jnp.sum(jl.batchnorm_apply(p_, js, x_, train=True)[0]
                                               * co), argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    y, _ = tl.batchnorm_apply(tp, ts, tx, train=True)
    gx, gs, go = torch.autograd.grad((y * torch.as_tensor(co)).sum(),
                                     (tx, tp["scale"], tp["offset"]))
    _close(gx, jgx)
    _close(gs, jgp["scale"])
    _close(go, jgp["offset"])


CONV3D = [((1, 1, 1), (1, 1, 1), "SAME", 8), ((3, 3, 3), (1, 1, 1), "SAME", 8),
          ((5, 5, 5), (1, 1, 1), "SAME", 2), ((3, 2, 4), (2, 1, 2), "SAME", 7),
          ((3, 3, 3), (2, 2, 2), "VALID", 7)]


@pytest.mark.parametrize("kernel,stride,padding,size", CONV3D)
def test_conv3d_matches_jax(kernel, stride, padding, size):
    r = np.random.default_rng(3)
    p = jl.conv3d_init(jax.random.PRNGKey(0), 5, 6, kernel)
    p["b"] = jnp.asarray(r.normal(size=6), jnp.float32)
    x = r.normal(size=(2, size, size + 1, size, 5)).astype(np.float32)
    want = jl.conv3d_apply(p, jnp.asarray(x), stride=stride, padding=padding)
    got = tl.conv3d_apply(_t(p), torch.as_tensor(x), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    _close(got, want)


CONV2D = [((3, 3), (1, 1), "SAME"), ((2, 5), (2, 3), "SAME"), ((4, 3), (3, 2), "VALID")]


@pytest.mark.parametrize("kernel,stride,padding", CONV2D)
def test_conv2d_matches_jax(kernel, stride, padding):
    r = np.random.default_rng(4)
    p = jl.conv2d_init(jax.random.PRNGKey(1), 3, 4, kernel)
    x = r.normal(size=(2, 9, 7, 3)).astype(np.float32)
    want = jl.conv2d_apply(p, jnp.asarray(x), stride=stride, padding=padding)
    got = tl.conv2d_apply(_t(p), torch.as_tensor(x), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    _close(got, want)


TRANSPOSE = [((3, 2), (2, 2), "SAME"), ((1, 1), (2, 2), "SAME"), ((5, 4), (2, 3), "SAME"),
             ((3, 2), (2, 2), "VALID"), ((2, 3), (3, 1), "VALID")]


@pytest.mark.parametrize("kernel,stride,padding", TRANSPOSE)
def test_conv2d_transpose_matches_jax(kernel, stride, padding):
    """lax.conv_transpose without transpose_kernel: an asymmetric kernel
    with random entries, odd input sizes, strides 1 to 3; the gradients in
    the input and the kernel too."""
    r = np.random.default_rng(5)
    p = {"w": jnp.asarray(r.normal(size=kernel + (3, 4)), jnp.float32),
         "b": jnp.asarray(r.normal(size=4), jnp.float32)}
    x = r.normal(size=(2, 5, 7, 3)).astype(np.float32)

    def jf(p_, x_):
        return jl.conv2d_transpose_apply(p_, x_, stride=stride, padding=padding)

    want = jf(p, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    got = tl.conv2d_transpose_apply(tp, tx, stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    if padding == "SAME":
        assert got.shape[1:3] == (5 * stride[0], 7 * stride[1])
    _close(got, want)
    co = r.normal(size=want.shape).astype(np.float32)
    jgp, jgx = jax.grad(lambda p_, x_: jnp.sum(jf(p_, x_) * co), argnums=(0, 1))(
        p, jnp.asarray(x))
    gw, gx = torch.autograd.grad((got * torch.as_tensor(co)).sum(), (tp["w"], tx))
    _close(gw, jgp["w"], 1e-4)
    _close(gx, jgx, 1e-4)


POOLS = [("max_pool2d", (2, 2), None, "VALID", (9, 7)),
         ("max_pool2d", (3, 2), (2, 2), "SAME", (9, 7)),
         ("avg_pool2d", (2, 2), None, "VALID", (9, 7)),
         ("avg_pool2d", (3, 3), (2, 1), "SAME", (9, 7)),
         ("max_pool3d", (2, 2, 2), (2, 2, 2), "SAME", (5, 4, 3)),
         ("max_pool3d", (3, 3, 3), (1, 1, 1), "SAME", (4, 4, 4)),
         ("avg_pool3d", (2, 2, 2), None, "VALID", (5, 4, 3)),
         ("avg_pool3d", (3, 3, 3), (1, 1, 1), "SAME", (5, 4, 3)),
         ("avg_pool3d", (2, 3, 2), (2, 2, 2), "SAME", (5, 4, 3))]


@pytest.mark.parametrize("name,window,stride,padding,size", POOLS)
def test_pools_match_jax(name, window, stride, padding, size):
    """XLA's SAME padding (the odd cell high), max padding with -inf, the
    average over in-bounds cells; negative inputs, so a max over padding
    would show."""
    x = (np.random.default_rng(6).normal(size=(2,) + size + (3,)) - 3).astype(np.float32)
    want = getattr(jl, name)(jnp.asarray(x), window, stride=stride, padding=padding)
    got = getattr(tl, name)(torch.as_tensor(x), window, stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    if name.startswith("max"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, 1e-6)


def test_avg_pool3d_count_include_pad_matches_reduce_window():
    """The inception blocks' reduce_window(add, SAME) / 27, at 8^3 and at
    2^3, where the window is larger than the input."""
    for n in (8, 2):
        x = np.random.default_rng(n).normal(size=(2, n, n, n, 5)).astype(np.float32)
        want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 3, 3, 3, 1),
                                     (1, 1, 1, 1, 1), "SAME") / 27.0
        got = tl.avg_pool3d(torch.as_tensor(x), (3, 3, 3), stride=(1, 1, 1), padding="SAME",
                            count_include_pad=True)
        _close(got, want, 1e-6)


def test_truncated_normal_and_conv_init():
    """Within +-2 stddev, mean about 0, std about 0.88 stddev (the
    truncated standard normal's); conv weights within the xavier limit over
    the receptive field, as JAX's."""
    t = tl.truncated_normal((200, 300), 0.5, generator=torch.Generator().manual_seed(0))
    assert float(t.abs().max()) <= 1.0
    assert abs(float(t.mean())) < 0.01 and abs(float(t.std()) / 0.5 - 0.8796) < 0.01
    j = np.asarray(jl.truncated_normal(jax.random.PRNGKey(0), (200, 300), 0.5))
    assert abs(float(j.std()) - float(t.std())) < 0.01
    c = tl.conv3d_init(20, 64, (5, 5, 5), torch.Generator().manual_seed(0))
    limit = (6.0 / (125 * 20 + 125 * 64)) ** 0.5
    assert c["w"].shape == (5, 5, 5, 20, 64) and float(c["w"].abs().max()) <= limit
    assert float(c["w"].abs().max()) > 0.9 * limit and float(c["b"].abs().max()) == 0.0
    assert tl.conv2d_init(3, 4, (2, 5))["w"].shape == (2, 5, 3, 4)


@pytest.mark.parametrize("train", [True, False])
def test_mlp_with_bn_matches_jax(train):
    """mlp_init(use_bn=True) has JAX's tree; mlp_apply_bn gives JAX's
    mlp_apply output and new state; mlp_apply refuses a BN MLP."""
    jp, js = jl.mlp_init(jax.random.PRNGKey(2), 7, (16, 12, 5), use_bn=True)
    tp = tl.mlp_init(7, (16, 12, 5), use_bn=True)
    ts = tl.mlp_bn_state(tp)
    for a, b in ((jp, tp), (js, ts)):
        assert ([p for p, _ in tree_flatten_with_paths(jax.device_get(a))]
                == [p for p, _ in tree_flatten_with_paths(b)])
    x = np.random.default_rng(7).normal(size=(3, 11, 7)).astype(np.float32)
    want, jns = jl.mlp_apply(jp, js, jnp.asarray(x), train=train, bn_momentum=0.8,
                             final_activation=jnp.tanh)
    got, tns = tl.mlp_apply_bn(_t(jp), _t(js), torch.as_tensor(x), train=train,
                               bn_momentum=0.8, final_activation=torch.tanh)
    _close(got, want)
    for (p, a), (_, b) in zip(tree_flatten_with_paths(tns),
                              tree_flatten_with_paths(jax.device_get(jns))):
        _close(a, b, 1e-6)
    with pytest.raises(ValueError, match="mlp_apply_bn"):
        tl.mlp_apply(tp, torch.as_tensor(x))
