"""The DPDist model family in the port against dpdist_tpu, on the CPU: the
BN decoder, the conv_version=3 decoder, the 7-channel encode
(full_fv=False), the global embedding (k=0), the pointnet encoder and the
2-D variant. Small widths (embedding 64 on 4^3, k = 3, mlp (32, 32, 32),
the size of tests/test_dense_eval.py), JAX-initialised weights carried
across: init trees, forwards in eval and training mode with the new
state, source gradients, one train step, checkpoints both ways, the
routing against the reference's conditions, the kernels' plain versions
at C = 7 against the Pallas kernels in interpret mode, and the golden
file's full-width values.

Run as a script from the repo root to regenerate
dpdist_tpu_torch/assets/golden_variants.json from the JAX package (JAX on
the CPU, from the port's seeded weights, so the card rebuilds them
without JAX; a few minutes):

    PYTHONPATH=. python tests/test_torch_variants.py --write-golden
"""

import functools
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.data.batching import assemble_dpdist_batch as jax_assemble
from dpdist_tpu.eval.dense import dense_point_to_surface as jax_dense
from dpdist_tpu.kernels.fused_forward_pallas import fused_forward as jax_fused_forward
from dpdist_tpu.kernels.gather_pallas import gather_patches_fused as jax_gather_fused
from dpdist_tpu.kernels.table_gather_pallas import table_gather as jax_table_gather
from dpdist_tpu.kernels.table_gather_pallas import table_gather_bwd as jax_tg_bwd
from dpdist_tpu.kernels.table_gather_pallas import table_gather_x as jax_tg_x
from dpdist_tpu.losses import l1_sample_loss as jax_l1
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.models.dpdist import _fused_gather_mode as jax_fused_gather_mode
from dpdist_tpu.ops.voxel import voxel_assign as jax_voxel_assign
from dpdist_tpu.train.checkpoint import restore_checkpoint as jax_restore
from dpdist_tpu.train.checkpoint import save_checkpoint as jax_save
from dpdist_tpu.train.optim import make_optimizer as jax_make_optimizer

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data.golden import (
    VARIANTS_GOLDEN_PATH,
    dense_field_queries,
    dpdist_train_batch,
    informative_weights,
    output_spread,
    state_sample,
    variant_clouds,
)
from dpdist_tpu_torch.eval.dense import dense_point_to_surface
from dpdist_tpu_torch.kernels.fused_forward import fused_forward, pack_decoder
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_bwd_ordered,
    table_gather_x,
)
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models.dpdist import (
    check_ported,
    forward_dpdist,
    init_dpdist,
    route,
)
from dpdist_tpu_torch.ops.voxel import voxel_assign
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax, params_to_numpy
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.trainer import DPDistTrainer

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
VARIANTS = {
    "bn": dict(use_bn=True),
    "conv3": dict(conv_version=3),
    "small_fv": dict(full_fv=False),
    "k0": dict(k=0),
    "pointnet": dict(encoder="pointnet", k=0, use_bn=True, pointnet_embedding=64),
    "dims2": dict(dims=2, output_channels=2),
}
NAMES = tuple(VARIANTS)
# The variants a gather kernel serves (3DmFV, k > 0, 3-D).
GATHERING = ("bn", "conv3", "small_fv")
# The variants the golden file trains (their own decoders or encoder).
TRAINED = ("bn", "conv3", "pointnet")
# Port (plain PyTorch) against JAX (XLA), both on the CPU: predictions and
# BN states. The encodes sum in other orders (up to ~2e-5 after
# normalisation); in training mode the batch statistics of a small batch
# amplify that (measured up to 4.4e-6 on these inputs).
TOL = 1e-5
# Loss and per-leaf gradients of a train step (tests/test_torch_trainer.py);
# a leaf whose gradient is rounding-sized against the tree's largest entry
# (a bias right before a training-mode BN, whose exact gradient is 0: the
# batch mean takes it out) is held within TOL_GRAD_TREE of that entry.
TOL_LOSS, TOL_GRAD_REL, TOL_GRAD_TREE = 1e-5, 1e-3, 1e-6
# Source gradients, per point and relative to the largest entry
# (tests/test_torch_dpdist.py's criterion).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05
# The kernel routes' plain versions on the CPU against the plain
# composition: the same gathers, so the same values.
TOL_ROUTE = 1e-6
# The golden file: JAX (CPU) against the port at full width: float32
# within 1e-4, bfloat16 within 2e-3 (tests/test_torch_dpdist.py's bounds).
TOL_GOLDEN, TOL_GOLDEN_BF16 = 1e-4, 2e-3
GOLDEN_SEED = 0
GOLDEN_PAIRS = 4                 # golden_distance.json's first pairs, at 64 points
GOLDEN_STRIDE = 4                # channel 0 of every 4th query is stored
GOLDEN_STEPS = 3
GOLDEN_TRAIN_B = 16
GOLDEN_STATE_VALUES = 16         # per BN state leaf, this many entries are stored
# The golden forwards' weights: the seeded ones through informative_weights
# with these first-layer gains and output shifts (seed 100 + the variant's
# index), chosen on the CPU so that the golden float32 outputs spread over
# 0.15-0.25 inside (0, 1/3): a bf16 output above 1/3 (a decoder output
# above 1) is rounded in steps of 2.6e-3, more than the bf16 bound. Each
# variant's spread must be at least GOLDEN_MIN_SPREAD times the bf16
# bound, so that a misplaced patch or BN leaf cannot pass inside it.
GOLDEN_PERTURB = {"bn": (150, 0.15), "conv3": (6, 0.0), "small_fv": (150, 0.0),
                  "k0": (10, -0.25), "pointnet": (12, -0.8), "dims2": (150, -0.1)}
GOLDEN_MIN_SPREAD = 50
# The golden train steps (Adam, lr 1e-4, B = 16, from the seeded weights):
# the first step's loss within 1e-4 relative, its gradient norm within
# 1e-3, the later losses within 5e-3 relative, and the BN state (relative
# to the larger of 1 and a leaf's largest entry) within 4e-6 after the
# first step and 5e-3 after the last. scripts/torch_variant_train_spread.py
# measured on the H100 (and the CPU): the port against JAX, after the
# first step 6.0e-8 (BN) and 3.3e-7 (pointnet), after the last 2.8e-3 and
# 9.1e-5 (the CPU: 2.8e-4, 6.3e-5); the port's own spread under 1e-6 of
# input noise (8 seeds) 3.0e-7 and 1.3e-6 after the first step, 1.9e-3 and
# 2.2e-4 after the last (with momentum SGD in place of Adam 4.7e-6 and
# 5.5e-6: Adam's first steps move every weight by about lr * sign(g), also
# where g is rounding noise), the later losses 3.7e-3. Known faults: the
# unbiased batch variance moves the state after the first step by 9.6e-6
# and 2.7e-4 and the first loss by 1.9e-4 (after three steps it hides in
# the spread), BN momentum 0.99 for 0.9 the state by 9.0e-2 and 0.48, and
# 0.62 and 0.89 after three. The later gradient norms are printed only
# (the pointnet encoder's third moved by 30 % on the CPU).
TOL_STEPS = (1e-4, 5e-3, 1e-3, 4e-6, 5e-3)
FULL_WIDTH = {
    "bn": dict(use_bn=True),
    "conv3": dict(conv_version=3),
    "small_fv": dict(full_fv=False),
    "k0": dict(k=0),
    "pointnet": dict(encoder="pointnet", k=0, use_bn=True),
    "dims2": dict(dims=2, embedding_size=256),      # 16 x 16 Gaussians
}
DENSE_NET = "results/ckpt_best"
DENSE = dict(family="chair", seed=21, n_points=1024, scale=0.8, resolution=64, extent=1.0,
             stride=1021, count=256)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Many small eager ops on a CPU shared by xdist workers stall at the
    thread pool's barriers; one thread per test keeps them fast."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name, **over):
    fields = {**SMALL, **VARIANTS[name], **over}
    return JaxConfig(**fields), DPDistConfig(**fields)


def _randomise(tree, seed):
    """BN scale/offset and running statistics away from their init, so that
    eval-mode BN is not near the identity."""
    r = np.random.default_rng(seed)

    def go(node, key=None):
        if isinstance(node, dict):
            return {k: go(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [go(v) for v in node]
        a = np.asarray(node)
        if key in ("scale", "var"):
            return r.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if key in ("offset", "mean"):
            return r.normal(0.0, 0.2, a.shape).astype(np.float32)
        return a

    return go(tree)


@functools.lru_cache(maxsize=None)
def jax_net(name):
    """(jcfg, params, state) of a variant, JAX-initialised, BN randomised,
    as numpy trees."""
    jcfg, _ = configs(name)
    jp, js = jax_init(jax.random.PRNGKey(NAMES.index(name) + 1), jcfg)
    seed = 10 + NAMES.index(name)
    return jcfg, _randomise(jax.device_get(jp), seed), _randomise(jax.device_get(js), seed + 1)


def port_net(name):
    _, jp, js = jax_net(name)
    return params_from_jax(jp, "cpu"), params_from_jax(js, "cpu")


def clouds(seed, dims, B=3, N=16):
    """pcA in the grid, pcB partly off it."""
    r = np.random.default_rng(seed)
    return (r.uniform(-0.9, 0.9, (B, N, dims)).astype(np.float32),
            r.uniform(-1.15, 1.15, (B, N, dims)).astype(np.float32))


def flat(tree):
    return [(p, np.asarray(t.detach() if isinstance(t, torch.Tensor) else t))
            for p, t in tree_flatten_with_paths(tree)]


def assert_trees_close(got, want, tol):
    g, w = flat(got), flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, p
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=p)


def close_rel(got, want):
    """The per-point criterion: within REL_GRAD of the largest entry on all
    but OUTLIERS of the points, within REL_GRAD_FEW on every point."""
    scale = float(np.abs(want).max())
    err = np.abs(got - want).max(-1) / scale
    assert err.max() <= REL_GRAD_FEW, err.max()
    assert np.mean(err > REL_GRAD) <= OUTLIERS, np.sort(err.ravel())[-8:]


# ---------------------------------------------------------------------------
# Init, forward, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_jax(name):
    """init_dpdist's params and state have JAX's key paths and shapes, zero
    (or +0.45 on the head) biases, unit BN scales, and the draws within the
    reference's xavier limits."""
    jcfg, tcfg = configs(name)
    jp, js = jax.device_get(jax_init(jax.random.PRNGKey(0), jcfg))
    tp, ts = init_dpdist(tcfg, torch.Generator().manual_seed(0), "cpu")
    for got, want in ((tp, jp), (ts, js)):
        g, w = flat(got), flat(want)
        assert [(p, a.shape) for p, a in g] == [(p, a.shape) for p, a in w]
    for (p, a), (_, b) in zip(flat(tp), flat(jp)):
        if p.endswith("/b") or "/bn/" in p:
            np.testing.assert_array_equal(a, b, err_msg=p)
        else:
            assert np.abs(a).max() <= np.abs(b).max() * 1.1 + 1e-6, p
    assert_trees_close(ts, js, 0.0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, train):
    """forward_dpdist against JAX's apply_dpdist on the same weights and
    clouds (pcB partly off the grid): both predictions and the new state,
    within TOL; training mode normalises with batch statistics (2B rows in
    the decoder, per cloud in the pointnet encoder)."""
    jcfg, jp, js = jax_net(name)
    _, tcfg = configs(name)
    tp, ts = port_net(name)
    pcA, pcB = clouds(NAMES.index(name), jcfg.dims)
    jAB, jBA, jns = jax_apply(jp, js, jcfg, jnp.asarray(pcA), jnp.asarray(pcB), train=train)
    tAB, tBA, tns = forward_dpdist(tp, ts, tcfg, torch.as_tensor(pcA), torch.as_tensor(pcB),
                                   train=train)
    for got, want in ((tAB, jAB), (tBA, jBA)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert_trees_close(tns, jax.device_get(jns), TOL)
    if not train:
        assert_trees_close(tns, ts, 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_source_gradient_matches_jax(name):
    """The frozen loss (eval mode, the state's running statistics) and its
    gradient in pcA against JAX's, by the per-point criterion."""
    jcfg, jp, js = jax_net(name)
    _, tcfg = configs(name)
    tp, ts = port_net(name)
    pcA, pcB = clouds(20 + NAMES.index(name), jcfg.dims)
    want, jg = jax.value_and_grad(jax_frozen_loss(jp, js, jcfg))(jnp.asarray(pcA),
                                                                 jnp.asarray(pcB))
    a = torch.tensor(pcA, requires_grad=True)
    got = make_frozen_dpdist_loss(tp, tcfg, state=ts)(a, torch.as_tensor(pcB))
    (g,) = torch.autograd.grad(got, a)
    assert abs(float(got.detach()) - float(want)) <= TOL
    close_rel(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("mode", ["table", "on", "mfv", "full"])
@pytest.mark.parametrize("name", GATHERING)
def test_kernel_routes_match_the_plain_composition(name, mode):
    """The card's routes run their kernels' plain versions on the CPU (the
    autograd Functions and the adjoint included): forward and source
    gradient against fused_gather="off", within TOL_ROUTE. "mfv" takes
    "table" for full_fv=False; "full" is served in bfloat16 for the BN-off
    conv_version=1 decoder (row 9 at C = 7 for full_fv=False), against the
    composed bf16 path within 2e-3."""
    _, tcfg = configs(name)
    tp, ts = port_net(name)
    pcA, pcB = (torch.as_tensor(c) for c in clouds(30, 3))
    if mode == "full":
        tcfg = tcfg.replace(dtype="bfloat16")
        want = forward_dpdist(tp, ts, tcfg.replace(fused_gather="off"), pcA, pcB)
        r = route(tcfg.replace(fused_gather="full"), "cuda", 16, 16)
        assert r.mode == ("full" if name == "small_fv" else "table")
        with torch.no_grad():
            got = forward_dpdist(tp, ts, tcfg.replace(fused_gather="full"), pcA, pcB)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), w.detach().numpy(), atol=2e-3, rtol=0)
        return
    r = route(tcfg.replace(fused_gather=mode), "cuda", 16, 16)
    assert r.mode == ("table" if (mode, name) == ("mfv", "small_fv") else mode)
    outs = {}
    for m in (mode, "off"):
        a = pcA.clone().requires_grad_(True)
        pAB, pBA, _ = forward_dpdist(tp, ts, tcfg.replace(fused_gather=m), a, pcB)
        (g,) = torch.autograd.grad(pAB[..., 0].sum() + pBA[..., 0].sum(), a)
        outs[m] = (pAB.detach(), pBA.detach(), g)
    for got, want in zip(outs[mode], outs["off"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL_ROUTE, rtol=0)


# ---------------------------------------------------------------------------
# Training and checkpoints
# ---------------------------------------------------------------------------

def _batch(seed, B=2, N=16):
    return dpdist_train_batch({"seed": seed, "batch_size": B, "num_point": N})


def _trainer(name, tmp_path, **over):
    _, tcfg = configs(name, **over)
    tp, ts = port_net(name)
    trainer = DPDistTrainer(tcfg, TrainConfig(batch_size=2, augment=False),
                            run_dir=str(tmp_path), device="cpu",
                            logger=RunLogger(str(tmp_path), echo=False))
    trainer._set_params(tp)
    trainer.state = ts
    return trainer


def _dims2_batch(data):
    """The 2-D variant's batch: the first two coordinates."""
    return np.ascontiguousarray(data[..., :2])


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name, tmp_path):
    """One DPDistTrainer step against JAX's value_and_grad + make_optimizer
    (Adam) from the same weights, state and batch: the loss, the per-leaf
    gradients (the pointnet encoder's included; see TOL_GRAD_TREE), the new
    BN state (the
    decoder's over 2B rows, the pointnet encoder's from pcB's run) and the
    params after the step (tests/test_torch_trainer.py's criterion)."""
    jcfg, jp, js = jax_net(name)
    data, labels = _batch(40 + NAMES.index(name))
    if jcfg.dims == 2:
        data = _dims2_batch(data)
    pcA, pcB, lab = (jnp.asarray(a) for a in jax_assemble(data, labels))

    def loss_fn(p):
        pred_AB, _, ns = jax_apply(p, js, jcfg, pcA, pcB, train=True)
        return jax_l1(pred_AB, lab), ns

    (want_loss, jns), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    opt = jax_make_optimizer(JaxTrainConfig(batch_size=2))
    updates, _ = opt.update(jgrads, opt.init(jp), jp)
    jafter = jax.device_get(optax.apply_updates(jp, updates))

    trainer = _trainer(name, tmp_path)
    loss, grads = trainer.loss_and_grads(*trainer.make_batch(data, labels))
    assert abs(float(loss) - float(want_loss)) <= TOL_LOSS
    want = flat(jax.device_get(jgrads))
    assert [p for p, _ in flat(trainer.params)] == [p for p, _ in want]
    largest = max(float(np.abs(w).max()) for _, w in want)
    for g, (p, w) in zip(grads, want):
        tol = max(TOL_GRAD_REL * float(np.abs(w).max()), TOL_GRAD_TREE * largest)
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0, err_msg=p)
    assert_trees_close(trainer.state, jax.device_get(jns), TOL)

    trainer = _trainer(name, tmp_path)
    metrics = trainer.train_step(data, labels)
    assert abs(float(metrics["loss"]) - float(want_loss)) <= TOL_LOSS
    lr = TrainConfig().learning_rate
    for (p, got), (_, w), (_, jg) in zip(flat(trainer.params), flat(jafter), want):
        large = np.abs(jg) > 1e-6
        assert np.all(np.abs(got - w)[large] <= 1e-6), p
        assert np.all(np.abs(got - w) <= 2 * lr + 1e-6), p
    assert_trees_close(trainer.state, jax.device_get(jns), TOL)


def test_training_with_bn_needs_both_directions():
    """With BN the batch statistics of a training forward cover both
    directions: apply_direction refuses it, and a BN config without its
    state refuses to run."""
    from dpdist_tpu_torch.models.dpdist import apply_direction

    _, tcfg = configs("bn")
    tp, ts = port_net("bn")
    pcA, pcB = (torch.as_tensor(c) for c in clouds(50, 3))
    with pytest.raises(ValueError, match="forward_dpdist"):
        apply_direction(tp, tcfg, pcA, pcB, state=ts, train=True)
    with pytest.raises(ValueError, match="BN state"):
        forward_dpdist(tp, None, tcfg, pcA, pcB)


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_both_ways(name, tmp_path):
    """A port checkpoint (params and BN state) restores through JAX's
    restore_checkpoint against init_dpdist's template and its
    load_dpdist_checkpoint; a JAX checkpoint loads in the port's
    load_dpdist_checkpoint, DPDistTrainer.restore and load_frozen_distance,
    which serves JAX's distance."""
    jcfg, jp, js = jax_net(name)
    trainer = _trainer(name, tmp_path / "port")
    data, labels = _batch(60)
    if jcfg.dims == 2:
        data = _dims2_batch(data)
    trainer.train_step(data, labels)
    path = trainer.save(tag=1)
    template = jax_init(jax.random.PRNGKey(0), jcfg)
    tree, step, _ = jax_restore(path, {"params": template[0], "state": template[1]})
    assert step == 1
    assert_trees_close(params_to_numpy(trainer.params), jax.device_get(tree["params"]), 0.0)
    assert_trees_close(params_to_numpy(trainer.state), jax.device_get(tree["state"]), 0.0)
    jc, _, jstate = jax_load_dpdist(path)
    assert jc == jcfg
    assert_trees_close(params_to_numpy(trainer.state), jax.device_get(jstate), 0.0)

    jpath = str(tmp_path / "jax" / "ckpt_7")
    jax_save(jpath, {"params": jp, "state": js}, step=7,
             metadata={"model_config": jcfg.to_json()})
    cfg, np_params, np_state = load_dpdist_checkpoint(jpath)
    assert cfg.to_json() == jcfg.to_json()
    assert_trees_close(np_params, jp, 0.0)
    assert_trees_close(np_state, js, 0.0)
    restored = _trainer(name, tmp_path / "restored")
    restored.restore(jpath)
    assert restored.global_step == 7
    assert_trees_close(params_to_numpy(restored.params), jp, 0.0)
    assert_trees_close(params_to_numpy(restored.state), js, 0.0)
    pcA, pcB = clouds(61, jcfg.dims)
    want = jax.vmap(lambda a, b: (lambda pr: (pr[0][..., 0].mean() + pr[1][..., 0].mean()) / 2)(
        jax_apply(jp, js, jcfg, a[None], b[None])))(jnp.asarray(pcA), jnp.asarray(pcB))
    with torch.no_grad():
        got = load_frozen_distance(jpath, device="cpu")(torch.as_tensor(pcA),
                                                        torch.as_tensor(pcB))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Routing against the reference's conditions
# ---------------------------------------------------------------------------

def _jax_route(jcfg, n, train):
    """The reference's path on its accelerator for clouds of n points:
    (mode, encode) as apply_dpdist and threedmfv dispatch there."""
    mode = jax_fused_gather_mode(jcfg)
    if mode == "full" and train:
        mode = "table"
    if mode == "mfv" and n > 128:
        mode = "table"
    if mode == "mfv":
        return mode, "mfv_gather_x"
    kernel_ok = jcfg.dims == 3 and jcfg.full_fv and jcfg.encoder == "3dmfv" and n >= 128
    return mode, "threedmfv" if kernel_ok else "plain"


@pytest.mark.parametrize("fused_gather", ["auto", "mfv", "table", "on", "full"])
def test_route_matches_the_reference_conditions(fused_gather, monkeypatch):
    """route on CUDA against _fused_gather_mode with the reference's
    accelerator present, for every variant and the canonical config, both
    dtypes, both modes, and clouds of 64 and 256 points: the same path and
    the same encode. (fused_gather="off" differs by design: the port keeps
    it plain on every device; tests/test_torch_large_clouds.py.)"""
    monkeypatch.setattr(importlib.import_module("dpdist_tpu.ops.threedmfv"), "_on_tpu",
                        lambda: True)
    for name in ("canonical",) + NAMES:
        over = {} if name == "canonical" else VARIANTS[name]
        for dtype in ("float32", "bfloat16"):
            fields = {**SMALL, **over, "dtype": dtype, "fused_gather": fused_gather}
            jcfg, tcfg = JaxConfig(**fields), DPDistConfig(**fields)
            for n in (64, 256):
                for train in (False, True):
                    mode, encode = _jax_route(jcfg, n, train)
                    r = route(tcfg, "cuda", n, n, train=train)
                    assert (r.mode, r.encode[0]) == (mode, encode), (name, dtype, n, train)
                    assert r.encode[0] == r.encode[1]
                    if mode in ("off", "mfv"):
                        continue
                    want = {"full": "fused_forward", "on": "gather_patches_fused",
                            "table": "table_gather_x" if n <= 128 else "table_gather"}[mode]
                    assert r.gather == (want, want), (name, dtype, n, train)


def test_check_ported_takes_every_variant():
    """check_ported refuses only a dtype the port does not cover."""
    for name in NAMES:
        for dtype in ("float32", "bfloat16"):
            check_ported(configs(name, dtype=dtype)[1])
    with pytest.raises(NotImplementedError, match="float16"):
        check_ported(DPDistConfig(dtype="float16"))
    with pytest.raises(ValueError, match="fused_gather"):
        check_ported(DPDistConfig(fused_gather="sometimes"))


# ---------------------------------------------------------------------------
# The kernels' plain versions at C = 7 against the Pallas kernels
# ---------------------------------------------------------------------------

C7 = dict(B=2, N=16, g=4, k=3, C=7)


def _c7_inputs(seed):
    r = np.random.default_rng(seed)
    B, N, g, C = C7["B"], C7["N"], C7["g"], C7["C"]
    fv = r.normal(size=(B, g ** 3, C)).astype(np.float32)
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    return r, fv, q


@pytest.mark.parametrize("row", ["2", "3", "6", "9", "10"])
def test_c7_plain_versions_match_pallas_interpret(row):
    """Rows 2 (table_gather_x), 3 (table_gather_bwd), 6 (table_gather), 9
    (fused_forward) and 10 (gather_patches_fused) at C = 7, the 7-channel
    encode's volumes: each wrapper on CPU tensors (its plain version)
    against the Pallas kernel in interpret mode, queries partly off the
    grid. Copies exact; the adjoint (and the ordered plain sum, which the
    kernel equals bit for bit on the card) within 1e-6 of its largest
    entry; row 9 within 2e-2 on pre-activation
    outputs (bf16 rounding points, tests/test_torch_fused_forward.py)."""
    g, k, C = C7["g"], C7["k"], C7["C"]
    r, fv, q = _c7_inputs(int(row))
    jv, jm, jd = jax_voxel_assign(jnp.asarray(q), g)
    tv, tm, td = voxel_assign(torch.as_tensor(q), g)
    assert float(tm.min()) == 0.0
    if row == "2":
        want = jax_tg_x(jnp.asarray(fv), jnp.asarray(q), g, k, interpret=True)
        got, vox = table_gather_x(torch.as_tensor(fv), torch.as_tensor(q), g, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(vox.numpy(), np.asarray(jv))
    elif row == "3":
        grad = r.normal(size=(C7["B"], C7["N"], k ** 3 * C)).astype(np.float32)
        want = np.asarray(jax_tg_bwd(jv, jnp.asarray(grad), grid_size=g, k=k,
                                     dtype=jnp.float32, interpret=True))
        got = table_gather_bwd(tv, torch.as_tensor(grad), g, k).numpy()
        ordered = table_gather_bwd_ordered(tv, torch.as_tensor(grad), g, k).numpy()
        assert got.shape == ordered.shape == (C7["B"], g ** 3, C)
        for mine in (got, ordered):
            np.testing.assert_allclose(mine, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    elif row == "6":
        want = jax_table_gather(jnp.asarray(fv), jv, g, k, interpret=True)
        got = table_gather(torch.as_tensor(fv), tv, g, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif row == "10":
        want = jax_gather_fused(jnp.asarray(fv), jv, jm, grid_size=g, k=k, interpret=True)
        got = gather_patches_fused(torch.as_tensor(fv), tv, tm, g, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        jcfg, tcfg = configs("small_fv", embedding_size=g ** 3, k=k)
        jp, _ = jax_init(jax.random.PRNGKey(3), jcfg)
        jfv = jnp.asarray(fv * 0.3).astype(jnp.bfloat16)
        want = np.asarray(jax_fused_forward(jfv, jv, jd, jp["decoder"]["layers"], g, k,
                                            interpret=True))
        layers = params_from_jax(jax.device_get(jp), "cpu")["decoder"]["layers"]
        got = fused_forward(torch.as_tensor(fv * 0.3).to(torch.bfloat16), tv, td,
                            pack_decoder(layers), g, k)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# The golden file (full width, seeded weights)
# ---------------------------------------------------------------------------

def golden_config(name, **over):
    return DPDistConfig(**{**FULL_WIDTH[name], **over})


def seeded(cfg):
    """The golden train steps' initial weights: init_dpdist from a
    generator seeded with GOLDEN_SEED (the DPDistTrainer's init at
    TrainConfig(seed=0))."""
    return init_dpdist(cfg, torch.Generator().manual_seed(GOLDEN_SEED), "cpu")


def perturb_spec(name):
    gain, shift = GOLDEN_PERTURB[name]
    return {"gain": gain, "shift": shift, "seed": 100 + NAMES.index(name)}


def informative(cfg, perturb):
    """The golden forwards' weights: the seeded ones made informative."""
    return informative_weights(*seeded(cfg), perturb)


def weight_fingerprint(params):
    """Per leaf, the float64 sum and sum of squares: the card checks it
    rebuilt the golden file's weights."""
    return {p: [float(t.double().sum()), float(t.double().square().sum())]
            for p, t in tree_flatten_with_paths(params)}


def golden_state(state):
    """The state as the golden file stores it: GOLDEN_STATE_VALUES entries
    of each leaf."""
    return {p: v.tolist() for p, v in state_sample(state, GOLDEN_STATE_VALUES).items()}


def golden_spec():
    from dpdist_tpu_torch.data.golden import load_golden

    pairs = load_golden()["pairs"][:GOLDEN_PAIRS]
    return {"pairs": pairs, "num_point": 64}


def sample_preds(pred):
    return np.asarray(pred)[:, ::GOLDEN_STRIDE, 0].astype(np.float64).tolist()


def port_forward(name, params, state, dtype="float32", fused_gather="auto"):
    """The port's eval forward of the golden clouds: (pred_AB, pred_BA)
    subsampled as the golden file stores them."""
    cfg = golden_config(name, dtype=dtype, fused_gather=fused_gather)
    pcA, pcB = (torch.as_tensor(c) for c in variant_clouds(golden_spec(), cfg.dims))
    with torch.no_grad():
        pAB, pBA, _ = forward_dpdist(params, state, cfg, pcA, pcB)
    return sample_preds(pAB), sample_preds(pBA)


def golden_trainer(name, tmp):
    cfg = golden_config(name)
    return DPDistTrainer(cfg, TrainConfig(batch_size=GOLDEN_TRAIN_B, augment=False,
                                          seed=GOLDEN_SEED),
                         run_dir=tmp, device="cpu", logger=RunLogger(tmp, echo=False))


def golden_train_batch(name):
    data, labels = dpdist_train_batch({"seed": 70 + NAMES.index(name),
                                       "batch_size": GOLDEN_TRAIN_B, "num_point": 64})
    return data, labels


@functools.lru_cache(maxsize=1)
def load_variants_golden():
    return json.loads(VARIANTS_GOLDEN_PATH.read_text())


@pytest.mark.parametrize("name", NAMES)
def test_golden_variants_hold(name, tmp_path):
    """The golden file's full-width variants from the seeded weights made
    informative (their outputs spread over at least GOLDEN_MIN_SPREAD times
    the bf16 bound): the weights' per-leaf sums, the float32 forward within
    1e-4 and the bf16 one within 2e-3 of JAX's, and for the trained
    variants the three steps from the seeded weights and the BN state
    after the first and the third by TOL_STEPS (the card holds the same,
    chip_smoke.py's variants phase)."""
    want = load_variants_golden()["variants"][name]
    cfg = golden_config(name)
    assert cfg.to_json() == want["config"] and want["perturb"] == perturb_spec(name)
    preds = [want[k] for k in ("pred_AB", "pred_BA")]
    assert output_spread(preds) >= GOLDEN_MIN_SPREAD * TOL_GOLDEN_BF16
    params, state = informative(cfg, want["perturb"])
    fp = weight_fingerprint(params)
    assert list(fp) == list(want["fingerprint"])
    for p, (s, ss) in want["fingerprint"].items():
        np.testing.assert_allclose(fp[p], [s, ss], rtol=1e-9, atol=1e-9, err_msg=p)
    for got, key in zip(port_forward(name, params, state), ("pred_AB", "pred_BA")):
        np.testing.assert_allclose(got, want[key], atol=TOL_GOLDEN, rtol=0)
    for mode, w in want["bf16"].items():
        got = port_forward(name, params, state, "bfloat16", mode)
        for g, key in zip(got, ("pred_AB", "pred_BA")):
            np.testing.assert_allclose(g, w[key], atol=TOL_GOLDEN_BF16, rtol=0)
    if name in TRAINED:
        check_golden_train(port_golden_train(name, str(tmp_path)), want["train"])


@pytest.mark.parametrize("name", GATHERING)
def test_golden_variants_fail_a_misplaced_patch(name, monkeypatch):
    """The golden check can fail a wrong gather: with each volume's
    channels rolled by one before the patches are cut (a misplaced
    patch), the float32 forward leaves JAX's golden values by more than
    ten times the bf16 bound."""
    import dpdist_tpu_torch.models.dpdist as model

    want = load_variants_golden()["variants"][name]
    cfg = golden_config(name)
    params, state = informative(cfg, want["perturb"])
    cut = model.extract_patches
    monkeypatch.setattr(model, "extract_patches", lambda fv, g, k: cut(fv.roll(1, -1), g, k))
    got = port_forward(name, params, state)
    moved = max(float(np.abs(np.asarray(g) - np.asarray(want[key])).max())
                for g, key in zip(got, ("pred_AB", "pred_BA")))
    assert moved >= 10 * TOL_GOLDEN_BF16, moved


def check_golden_train(got, want):
    """The golden steps' criterion (see TOL_STEPS): raises AssertionError."""
    first, later, gnorm, state_first, state = TOL_STEPS
    assert abs(got["loss"][0] - want["loss"][0]) <= first * want["loss"][0]
    for g, w in zip(got["loss"][1:], want["loss"][1:]):
        assert abs(g - w) <= later * w, (got["loss"], want["loss"])
    assert abs(got["grad_norm"][0] - want["grad_norm"][0]) <= gnorm * want["grad_norm"][0]
    for key, tol in (("state_first", state_first), ("state", state)):
        for p, w in want[key].items():
            np.testing.assert_allclose(got[key][p], w, atol=tol * max(1.0, np.abs(w).max()),
                                       rtol=0, err_msg=f"{key} {p}")


def port_golden_train(name, tmp):
    """GOLDEN_STEPS DPDistTrainer steps from the seeded weights on the
    golden batch: per step the loss and gradient norm, and the BN state
    after the first step and after the last as the golden file samples
    it."""
    trainer = golden_trainer(name, tmp)
    data, labels = golden_train_batch(name)
    ms, first = [], None
    for _ in range(GOLDEN_STEPS):
        ms.append(trainer.train_step(data, labels))
        first = first or golden_state(trainer.state)
    return {"loss": [float(m["loss"]) for m in ms],
            "grad_norm": [float(m["grad_norm"]) for m in ms],
            "state_first": first, "state": golden_state(trainer.state)}


def test_golden_dense_holds():
    """The golden file's dense section: the committed net's distances at the
    subsample of a 64^3 field (pretransform on and off), within 1e-4 of
    JAX's, and the two paths within 1e-5 of each other (the card runs the
    whole field, chip_smoke.py's dense phase)."""
    want = load_variants_golden()["dense"]
    cfg, params, state = load_dpdist_checkpoint(want["net"])
    params, state = params_from_jax(params, "cpu"), params_from_jax(state, "cpu")
    cloud, q, index = dense_field_queries(want["spec"])
    tq = torch.as_tensor(q[index][None])
    outs = {}
    for pre in ("on", "off"):
        with torch.no_grad():
            outs[pre] = dense_point_to_surface(params, cfg, torch.as_tensor(cloud), tq,
                                               state=state, pretransform=pre)[0].numpy()
        np.testing.assert_allclose(outs[pre], want["values"], atol=TOL_GOLDEN, rtol=0)
    np.testing.assert_allclose(outs["on"], outs["off"], atol=1e-5, rtol=0)


def jax_variant_golden(name):
    """JAX's values for the port's seeded full-width weights: the eval
    forward of the golden clouds in float32 and in bfloat16 ("auto", the
    XLA composition on the CPU; and "full", the fused kernel in interpret
    mode, where the reference serves the config with it), and for the
    trained variants GOLDEN_STEPS value_and_grad + optax steps at
    B = GOLDEN_TRAIN_B."""
    cfg = golden_config(name)
    perturb = perturb_spec(name)
    params, state = informative(cfg, perturb)
    out = {"config": cfg.to_json(), "perturb": perturb,
           "fingerprint": weight_fingerprint(params)}
    jp, js = params_to_numpy(params), params_to_numpy(state)
    jcfg = JaxConfig.from_json(cfg.to_json())
    pcA, pcB = (jnp.asarray(c) for c in variant_clouds(golden_spec(), cfg.dims))
    fwd = jax.jit(lambda p, s, a, b, c=jcfg: jax_apply(p, s, c, a, b)[:2])
    pAB, pBA = fwd(jp, js, pcA, pcB)
    out["pred_AB"], out["pred_BA"] = sample_preds(pAB), sample_preds(pBA)
    out["bf16"] = {}
    modes = ["auto"] + (["full"] if name == "small_fv" else [])
    for mode in modes:
        c16 = jcfg.replace(dtype="bfloat16", fused_gather=mode)
        assert mode == "auto" or jax_fused_gather_mode(c16) == "full"
        pAB, pBA = jax_apply(jp, js, c16, pcA, pcB)[:2]
        out["bf16"][mode] = {"pred_AB": sample_preds(pAB), "pred_BA": sample_preds(pBA)}
    if name in TRAINED:
        data, labels = golden_train_batch(name)
        a, b, lab = (jnp.asarray(x) for x in jax_assemble(data, labels))
        opt = jax_make_optimizer(JaxTrainConfig(batch_size=GOLDEN_TRAIN_B))

        def loss_fn(p, s):
            pred_AB, _, ns = jax_apply(p, s, jcfg, a, b, train=True)
            return jax_l1(pred_AB, lab), ns

        @jax.jit
        def step(p, s, o):
            (loss, ns), g = jax.value_and_grad(loss_fn, has_aux=True)(p, s)
            upd, o = opt.update(g, o, p)
            gn = jnp.sqrt(sum(jnp.sum(v * v) for v in jax.tree_util.tree_leaves(g)))
            return optax.apply_updates(p, upd), ns, o, loss, gn

        jp, js = (params_to_numpy(t) for t in seeded(cfg))
        o = opt.init(jp)
        losses, gnorms, first = [], [], None
        for _ in range(GOLDEN_STEPS):
            jp, js, o, loss, gn = step(jp, js, o)
            losses.append(float(loss))
            gnorms.append(float(gn))
            first = first or golden_state(jax.device_get(js))
        out["train"] = {"batch_seed": 70 + NAMES.index(name), "loss": losses,
                        "grad_norm": gnorms, "state_first": first,
                        "state": golden_state(jax.device_get(js))}
    return out


def jax_dense_golden():
    spec = {**DENSE}
    cfg, params, state = jax_load_dpdist(DENSE_NET)
    cloud, q, index = dense_field_queries(spec)
    d = jax_dense(params, state, cfg, jnp.asarray(cloud), jnp.asarray(q[index][None]),
                  pretransform="on")
    return {"net": DENSE_NET, "spec": spec, "values": np.asarray(d)[0].astype(np.float64).tolist()}


def compute_golden():
    return {"seed": GOLDEN_SEED, "clouds": golden_spec(), "stride": GOLDEN_STRIDE,
            "train": {"batch_size": GOLDEN_TRAIN_B, "num_point": 64, "steps": GOLDEN_STEPS},
            "seeded": ("init_dpdist(DPDistConfig(...config), "
                       "torch.Generator().manual_seed(seed), device)"),
            "variants": {name: jax_variant_golden(name) for name in NAMES},
            "dense": jax_dense_golden()}


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_variants.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    g = compute_golden()
    with open(VARIANTS_GOLDEN_PATH, "w") as f:
        json.dump(g, f, indent=1)
        f.write("\n")
    print("wrote", VARIANTS_GOLDEN_PATH)
