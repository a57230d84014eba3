"""The port's losses, frozen loss, initialiser, schedules, optimizer and
batch assembly against dpdist_tpu."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.data.batching import assemble_dpdist_batch as jax_assemble
from dpdist_tpu.losses import l1_sample_loss as jax_l1
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
from dpdist_tpu.losses import pred_mean_loss as jax_pred_mean
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.nn.schedules import bn_momentum_schedule as jax_bn_schedule
from dpdist_tpu.nn.schedules import staircase_lr as jax_staircase
from dpdist_tpu.train.optim import make_optimizer as jax_make_optimizer

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data import PrefetchingLoader, assemble_dpdist_batch
from dpdist_tpu_torch.losses import l1_sample_loss, make_frozen_dpdist_loss, pred_mean_loss
from dpdist_tpu_torch.models import init_dpdist, resolve_for_grad
from dpdist_tpu_torch.nn import bn_momentum_schedule, staircase_lr
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
from dpdist_tpu_torch.train.optim import make_optimizer

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
# Port (plain PyTorch on the CPU) against dpdist_tpu (XLA on the CPU): the
# encode and the decoder sum in other orders (loss values, as the served
# distances in tests/test_torch_dpdist.py).
TOL = 1e-4
# Input gradients, per point and relative to the largest entry. The two
# encodes form squared distances differently (per dimension here, the
# matmul identity there), so the FV values differ by up to 2e-5. The
# query path's gradient then agrees to 1e-7 of its size and most points'
# encode-path gradient to 1e-3; on a few points (3 of 128 on the first
# net's inputs here) the encode path's gradient moves by up to 3e-2: the
# signed sqrt of small pooled values has a slope that grows without bound
# near 0, so there the rounding difference of the two encodes is
# magnified. Hence: every point within REL_GRAD_FEW, all but OUTLIERS of
# them within REL_GRAD.
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05


def _close_rel(got, want):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    assert err.max() <= REL_GRAD_FEW, err.max()
    assert np.mean(err > REL_GRAD) <= OUTLIERS, np.sort(err.ravel())[-8:]


@functools.partial(jax.jit, static_argnums=(2, 5))
def jax_frozen_value_and_grad(params, state, cfg, pcA, pcB, penalty=1.0):
    """JAX's frozen loss and its gradients in both clouds, jitted with the
    parameters as arguments: the two nets have one shape, so they share
    one compile (op-by-op evaluation compiles each op of the backward)."""
    loss_fn = jax_frozen_loss(params, state, cfg, out_of_grid_penalty=penalty)
    return jax.value_and_grad(loss_fn, (0, 1))(pcA, pcB)


@pytest.fixture(scope="module", params=NETS)
def net(request):
    cfg, params, state = jax_load(request.param)
    tcfg, tparams_np = load_dpdist_checkpoint(request.param)
    return (cfg, params, state), (tcfg, params_from_jax(tparams_np, "cpu"))


def test_frozen_loss_and_input_gradients_match_jax(net):
    """Both committed nets at B=2, N=64, clouds partly off the grid (the
    barrier acts): value, d/dpcA and d/dpcB against JAX's frozen loss on
    its XLA path. The parameters receive no gradient."""
    (cfg, params, state), (tcfg, tparams) = net
    r = np.random.default_rng(0)
    pcA = r.uniform(-1.1, 1.1, (2, 64, 3)).astype(np.float32)
    pcB = r.uniform(-1.1, 1.1, (2, 64, 3)).astype(np.float32)
    want, (jdA, jdB) = jax_frozen_value_and_grad(params, state, cfg.replace(fused_gather="off"),
                                                 jnp.asarray(pcA), jnp.asarray(pcB))

    leaves = [t.requires_grad_(True) for lp in tparams["decoder"]["layers"] for t in lp.values()]
    loss_fn = make_frozen_dpdist_loss(tparams, tcfg)
    tA, tB = torch.tensor(pcA, requires_grad=True), torch.tensor(pcB, requires_grad=True)
    got = loss_fn(tA, tB)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL
    _close_rel(tA.grad.numpy(), np.asarray(jdA))
    _close_rel(tB.grad.numpy(), np.asarray(jdB))
    assert all(t.grad is None for t in leaves)


@pytest.mark.parametrize("penalty", [0.0, 2.0])
def test_frozen_loss_barrier(net, penalty):
    """The out-of-grid barrier adds penalty * mean(relu(|pc| - 1)) per cloud."""
    _, (tcfg, tparams) = net
    r = np.random.default_rng(1)
    pcA, pcB = (torch.as_tensor(r.uniform(-1.3, 1.3, (1, 64, 3)).astype(np.float32))
                for _ in range(2))
    base = make_frozen_dpdist_loss(tparams, tcfg, out_of_grid_penalty=0.0)(pcA, pcB)
    got = make_frozen_dpdist_loss(tparams, tcfg, out_of_grid_penalty=penalty)(pcA, pcB)
    barrier = sum(float(torch.relu(pc.abs() - 1).mean()) for pc in (pcA, pcB))
    assert barrier > 0
    assert abs(float(got) - float(base) - penalty * barrier) <= 1e-6


def test_resolve_for_grad():
    cfg = DPDistConfig()
    assert resolve_for_grad(cfg, "cpu") is cfg
    assert resolve_for_grad(cfg, torch.device("cuda")).fused_gather == "table"
    off = cfg.replace(fused_gather="off")
    assert resolve_for_grad(off, torch.device("cuda")) is off


def test_l1_and_pred_mean_losses_match_jax():
    r = np.random.default_rng(2)
    a, b = r.normal(size=(2, 3, 16, 3)).astype(np.float32)
    labels = r.uniform(0, 0.3, (3, 16)).astype(np.float32)
    got = float(l1_sample_loss(torch.as_tensor(a), torch.as_tensor(labels)))
    assert abs(got - float(jax_l1(jnp.asarray(a), jnp.asarray(labels)))) <= 1e-7
    got = float(pred_mean_loss(torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(got - float(jax_pred_mean(jnp.asarray(a), jnp.asarray(b)))) <= 1e-7


def test_train_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert ours == {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert TrainConfig().to_json() == JaxTrainConfig().to_json()
    assert DPDistConfig().to_json() == JaxConfig().to_json()


def test_init_dpdist_shapes_and_xavier_limits():
    """Canonical config: the JAX package's shapes; TF xavier-uniform with
    the reference's conv fans on the first layer; zero biases but the
    output's +0.45."""
    cfg = DPDistConfig()
    params = init_dpdist(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams, jstate = jax_init(jax.random.PRNGKey(0), JaxConfig())
    layers, jlayers = params["decoder"]["layers"], jparams["decoder"]["layers"]
    assert jstate == {"decoder": {}}
    assert [tuple(lp["w"].shape) for lp in layers] == [lp["w"].shape for lp in jlayers]
    assert [tuple(lp["b"].shape) for lp in layers] == [lp["b"].shape for lp in jlayers]
    fans = [(2503, 2503 * 1024), (1024, 1024), (1024, 1024), (1024, 3)]
    for lp, jlp, (fi, fo) in zip(layers, jlayers, fans):
        limit = np.sqrt(6.0 / (fi + fo))
        w = lp["w"].numpy()
        assert lp["w"].dtype == torch.float32
        assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
        assert abs(w.mean()) < 0.05 * limit
        assert np.abs(np.asarray(jlp["w"])).max() <= limit
    for lp, jlp in zip(layers, jlayers):
        np.testing.assert_array_equal(lp["b"].numpy(), np.asarray(jlp["b"]))
    assert float(layers[-1]["b"][0]) == pytest.approx(0.45)
    again = init_dpdist(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["decoder"]["layers"][1]["w"], layers[1]["w"])


def test_schedules_match_jax():
    steps = [0, 1, 5, 153599, 153600, 307200, 10 ** 7]
    lr, jlr = staircase_lr(1e-4, 300 * 512, 0.5, 1e-7), jax_staircase(1e-4, 300 * 512, 0.5, 1e-7)
    bn, jbn = bn_momentum_schedule(), jax_bn_schedule()
    for s in steps:
        assert lr(s) == float(jlr(s))
        assert bn(s) == float(jbn(s))
    assert lr(10 ** 7) == pytest.approx(1e-7)   # the floor


def _tree(r):
    return {"decoder": {"layers": [
        {"w": r.normal(size=(5, 4)).astype(np.float32), "b": r.normal(size=4).astype(np.float32)},
        {"w": r.normal(size=(4, 2)).astype(np.float32), "b": r.normal(size=2).astype(np.float32)},
    ]}}


@pytest.mark.parametrize("change", [
    {},                                                            # Adam, the default
    {"decay_step": 2, "decay_rate": 0.1, "lr_floor": 3e-5},        # staircase and floor
    {"grad_clip": 0.5, "weight_decay": 0.01},                      # decay, then clip
    {"optimizer": "momentum", "grad_clip": 0.5, "learning_rate": 1e-2},
])
def test_optimizer_matches_optax(change):
    """Four steps with the same gradients: params after each step against
    dpdist_tpu's make_optimizer (optax). Float32 arithmetic in another
    order: within 1e-6 of the learning rate per step, elementwise."""
    cfg = TrainConfig(learning_rate=1e-3).replace(**change)
    jcfg = JaxTrainConfig(**dataclasses.asdict(cfg))
    r = np.random.default_rng(3)
    tree = _tree(r)
    jopt = jax_make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    params = params_from_jax(tree, "cpu")
    opt = make_optimizer(cfg)
    state = opt.init(params)
    for _ in range(4):
        g = _tree(r)
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = [torch.as_tensor(lp[key]) for lp in g["decoder"]["layers"] for key in ("b", "w")]
        state = opt.step(params, grads, state)
        for lp, jlp in zip(params["decoder"]["layers"], jparams["decoder"]["layers"]):
            for key in ("w", "b"):
                np.testing.assert_allclose(lp[key].numpy(), np.asarray(jlp[key]),
                                           atol=1e-6 * cfg.learning_rate + 1e-7, rtol=0)
    assert state["count"] == 4


def test_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="rmsprop"))


def test_assemble_dpdist_batch_identical_to_jax():
    r = np.random.default_rng(4)
    data = r.normal(size=(3, 6 * 16, 3)).astype(np.float32)
    labels = r.uniform(0, 1, (3, 4 * 16)).astype(np.float32)
    for got, want in zip(assemble_dpdist_batch(data, labels), jax_assemble(data, labels)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


class _Batches:
    def __init__(self, n, fail_at=None):
        self.n, self.i, self.fail_at = n, 0, fail_at

    def reset(self):
        self.i = 0

    def has_next_batch(self):
        return self.i < self.n

    def next_batch(self, augment=False):
        if self.i == self.fail_at:
            raise RuntimeError("bad batch")
        self.i += 1
        return np.full((1,), self.i), augment


def test_prefetching_loader_keeps_order_and_raises():
    loader = PrefetchingLoader(_Batches(5), augment=True, depth=2)
    for _ in range(2):
        assert [int(b[0]) for b, _ in loader.epoch()] == [1, 2, 3, 4, 5]
    it = loader.epoch()
    next(it)
    it.close()                        # abandoned mid-epoch: the producer stops
    assert [int(b[0]) for b, _ in loader.epoch()] == [1, 2, 3, 4, 5]
    assert not loader._thread.is_alive()
    with pytest.raises(RuntimeError, match="bad batch"):
        list(PrefetchingLoader(_Batches(5, fail_at=2)).epoch())
