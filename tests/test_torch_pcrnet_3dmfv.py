"""The port's 3dmfv PCRNet encoder (dpdist_tpu_torch/models/pcrnet.py) and
its BN state through the trainer, the checkpoints and the evaluator,
against dpdist_tpu's, on the CPU, at out_features 32 (the reference's
8^3 grid, sigma 0.25) from JAX-initialised weights carried across: the
forward with and without a state, in eval and training; the hoisted
template encoding; the refinement with its state; one train step for the
chamfer and the frozen DPDist loss; checkpoints both ways; the evaluator's
report; and the golden file's step (JAX, the port's seeded weights).

Tolerances: poses and transformed sources within 1e-5 (eval) and 1e-4
(training: batch statistics over 2B clouds amplify rounding); BN states
within 1e-5 relative; losses within 1e-4 relative; gradients as
test_train_step_matches_jax says. A randomly initialised policy's training-mode refinement is chaotic:
1e-6 of input noise moved JAX's own poses by 2.7e-5, 6.8e-4 and 7.8e-3
over three iterations (eval mode: 3e-8), so training is compared over one
iteration, and the chaining of iterations against the port's own single
iterations.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.eval.registration import evaluate_registration as jax_evaluate
from dpdist_tpu.models import pcrnet as jpcr
from dpdist_tpu.parallel import make_mesh
from dpdist_tpu.train.checkpoint import restore_params_maybe_state as jax_restore
from dpdist_tpu.train.logging import RunLogger as JaxRunLogger
from dpdist_tpu.train.pcrnet_trainer import PCRNetTrainer as JaxTrainer

from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
from dpdist_tpu_torch.data.golden import AUE_GOLDEN_PATH
from dpdist_tpu_torch.data.registration import RegistrationDataset
from dpdist_tpu_torch.eval.registration import evaluate_registration
from dpdist_tpu_torch.models import pcrnet as tpcr
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, tree_flatten_with_paths
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

SMALL = dict(num_point=32, encoder="3dmfv", out_features=32, head_widths=(32, 16), max_loops=1)
NET = "results/ckpt_best"
TOL, TOL_TRAIN = 1e-5, 1e-4
# Parameter gradients per leaf, relative to its largest entry: against the
# float64 backward of the same cotangent, and against JAX's float32
# gradient, which through batch-statistics BN parts from the float64 one
# by up to 2.4 % (float64_grads).
REL_GRAD, JAX_GRAD = 1e-4, 5e-2
REL_GRAD_DPDIST = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(tree):
    return tpcr.params_to_device(jax.device_get(tree), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _close_trees(got, want, rtol=TOL, atol=1e-6):
    g, w = tree_flatten_with_paths(got), tree_flatten_with_paths(jax.device_get(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=p)


def _setup(seed=0):
    jcfg, cfg = JaxPCRNetConfig(**SMALL), PCRNetConfig(**SMALL)
    jparams, jstate = jpcr.init_pcrnet(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)
    # Running statistics away from (0, 1), so eval mode's normalisation counts.
    jstate = {"mfv_bn": [{k: {"mean": r.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                              "var": r.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
                          for k, v in blk.items()} for blk in jstate["mfv_bn"]]}
    return jcfg, cfg, jparams, jstate, _to_port(jparams), _to_port(jstate)


def _clouds(seed, B=2, N=32):
    tmpl, src, _ = RegistrationDataset(num_point=N, n_templates=4, families=("chair", "box"),
                                       seed=seed, max_rotate_deg=30.0).sample_batch(B)
    return tmpl, src


def test_init_tree_matches_jax():
    jcfg, cfg = JaxPCRNetConfig(**SMALL), PCRNetConfig(**SMALL)
    jparams, jstate = jpcr.init_pcrnet(jax.random.PRNGKey(0), jcfg)
    params = tpcr.init_pcrnet(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tpcr.init_pcrnet_state(cfg, "cpu")
    for a, b in ((params, jparams), (state, jstate)):
        g, w = tree_flatten_with_paths(a), tree_flatten_with_paths(jax.device_get(b))
        assert [(p, tuple(t.shape)) for p, t in g] == [(p, np.shape(t)) for p, t in w]
    _close_trees(state, jstate, 0, 0)
    assert tpcr.feature_dim(cfg) == 8 * 4 * 2


@pytest.mark.parametrize("mode", ["eval_state", "eval_no_state", "train_state", "train_no_state"])
def test_apply_pcrnet_matches_jax(mode):
    jcfg, cfg, jparams, jstate, params, state = _setup()
    tmpl, src = _clouds(0)
    train = mode.startswith("train")
    js, ts = (jstate, state) if mode.endswith("_state") else (None, None)
    want, jns = jax.jit(functools.partial(jpcr.apply_pcrnet, cfg=jcfg, train=train,
                                          return_state=True))(
        jparams, source=src, template=tmpl, state=js)
    got, tns = tpcr.apply_pcrnet(params, cfg, torch.tensor(src), torch.tensor(tmpl), state=ts,
                                 train=train, return_state=True)
    _close(got, want, TOL_TRAIN if train or js is None else TOL)
    if js is None:
        assert tns is None and jns is None
    else:
        _close_trees(tns, jns)
        if not train:
            assert tns is ts
    assert tpcr.template_feats_invariant(cfg, ts, train) == jpcr.template_feats_invariant(
        jcfg, js, train)
    if mode == "eval_state":
        tf = tpcr.encode_template(params, cfg, torch.tensor(tmpl), state=state)
        _close(tpcr.apply_pcrnet(params, cfg, torch.tensor(src), None, template_feats=tf,
                                 state=state), want, TOL)


@pytest.mark.parametrize("train", [False, True])
def test_pcrnet_refine_matches_jax(train):
    """Eval (3 iterations): the template hoisted, running statistics.
    Training (1 iteration): batch statistics, the state's EMA returned."""
    jcfg, cfg, jparams, jstate, params, state = _setup(1)
    tmpl, src = _clouds(1)
    iterations = 1 if train else 3
    want = jax.jit(functools.partial(jpcr.pcrnet_refine, cfg=jcfg, iterations=iterations,
                                     train=train, return_trajectory=True, return_state=True,
                                     stop_gradient_iters=False))(
        jparams, source=src, template=tmpl, state=jstate)
    with torch.no_grad():
        got = tpcr.pcrnet_refine(params, cfg, torch.tensor(src), torch.tensor(tmpl),
                                 iterations=iterations, train=train, return_trajectory=True,
                                 return_state=True, stop_gradient_iters=False, state=state)
    tol = TOL_TRAIN if train else TOL
    for g, w in zip(got[:4], want[:4]):
        _close(g, w, tol)
    _close_trees(got[4], want[4])


def test_training_refinement_chains_its_state():
    """Three training iterations equal three chained single iterations,
    each on the last one's source and state (the reference's scan carry)."""
    _, cfg, _, _, params, state = _setup(2)
    tmpl, src = (torch.tensor(a) for a in _clouds(2))
    with torch.no_grad():
        _, _, poses, st = tpcr.pcrnet_refine(params, cfg, src, tmpl, iterations=3, train=True,
                                             state=state, return_state=True)
        s, x = state, src
        for i in range(3):
            pose, x, s = tpcr.pcrnet_iteration(params, cfg, x, tmpl, state=s, train=True)
            assert torch.equal(pose, poses[i])
    for (p, a), (_, b) in zip(tree_flatten_with_paths(st), tree_flatten_with_paths(s)):
        assert torch.equal(a, b), p


def _pair(tmp_path, loss_type):
    jcfg, cfg = JaxPCRNetConfig(**SMALL), PCRNetConfig(**SMALL)
    tcfg = dict(batch_size=2, optimizer="momentum", learning_rate=1.0, momentum=0.9)
    jdp, tdp = (jax_load_dpdist(NET), load_dpdist_checkpoint(NET)) if loss_type == "dpdist" \
        else (None, None)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**tcfg), loss_type=loss_type, dpdist=jdp,
                     run_dir=str(tmp_path / "jax"), mesh=make_mesh(data=1),
                     logger=JaxRunLogger(str(tmp_path / "jax"), echo=False))
    ttr = PCRNetTrainer(cfg, TrainConfig(**tcfg), loss_type=loss_type, dpdist=tdp,
                        run_dir=str(tmp_path / "port"), device="cpu",
                        logger=RunLogger(str(tmp_path / "port"), echo=False))
    ttr.params = tpcr.params_to_device(jax.device_get(jtr.params), "cpu", requires_grad=True)
    ttr.state = _to_port(jtr.state)
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    return jtr, ttr


def jax_reference(jcfg, loss_type, params, state, tmpl, src, cot):
    """JAX's side of one training loop (jitted): the loss at JAX's own
    transformed source, the new state, the loss's gradient at the
    transformed source `cot` holds (the port's), and the parameter
    gradients for the cotangent `cot[1]`. Returns (loss, new_state,
    input_gradient, grads)."""
    from dpdist_tpu.losses import make_frozen_dpdist_loss
    from dpdist_tpu.ops.chamfer import chamfer_distance

    if loss_type == "dpdist":
        dcfg, dparams, dstate = jax_load_dpdist(NET)
        dp_loss = make_frozen_dpdist_loss(dparams, dstate, dcfg)

        def loss_of(x, t):
            return dp_loss(x, t)
    else:
        def loss_of(x, t):
            return chamfer_distance(t, x, sqrt=True)

    @jax.jit
    def run(params, state, tmpl, src, out_at, cotangent):
        def forward(p):
            out, _, _, ns = jpcr.pcrnet_refine(p, jcfg, src, tmpl, iterations=1, state=state,
                                               train=True, return_state=True)
            return out, ns

        (out, new_state), vjp = jax.vjp(forward, params)
        (grads,) = vjp((cotangent, jax.tree_util.tree_map(jnp.zeros_like, new_state)))
        return loss_of(out, tmpl), new_state, jax.grad(loss_of)(out_at, tmpl), grads

    return run(params, state, *(jnp.asarray(a) for a in (tmpl, src) + cot))


def float64_grads(params, cfg, state, tmpl, src, cotangent):
    """The policy's gradients (one training loop) for a cotangent of the
    transformed source, computed by the port in float64 on the float32
    3DmFV volumes: the reference for the float32 backward. JAX's float32
    gradient through batch-statistics BN parts from it by up to 2.4 % of a
    leaf's largest entry on the CPU (block 2's 1^3 conv, measured), the
    port's by 1.7e-6."""
    from dpdist_tpu_torch.ops.threedmfv import threedmfv

    p64 = {k: [{b: {"w": t["w"].detach().double().requires_grad_(True),
                    "b": t["b"].detach().double().requires_grad_(True)}
                for b, t in blk.items()} for blk in v] if k == "mfv_blocks" else
           ([{kk: t.detach().double().requires_grad_(True) for kk, t in lp.items()} for lp in v]
            if isinstance(v, list) else
            {kk: t.detach().double().requires_grad_(True) for kk, t in v.items()})
           for k, v in params.items()}
    s64 = jax.tree_util.tree_map(lambda t: t.double(), state)
    fv = {}

    def fv64(points, n, sigma):   # the float32 volume, then float64
        key = points.shape
        if key not in fv:
            fv[key] = threedmfv(points.float(), n, sigma).double()
        return fv[key]

    import dpdist_tpu_torch.models.pcrnet as module

    orig, module.threedmfv = module.threedmfv, fv64
    try:
        out = tpcr.pcrnet_refine(p64, cfg, torch.tensor(src).double(),
                                 torch.tensor(tmpl).double(), iterations=1, state=s64,
                                 train=True)[0]
    finally:
        module.threedmfv = orig
    leaves = [t for _, t in tree_flatten_with_paths(p64)]
    return torch.autograd.grad((out * cotangent.double()).sum(), leaves)


@pytest.mark.parametrize("loss_type", ["chamfer", "dpdist"])
def test_train_step_matches_jax(loss_type, tmp_path):
    """One training step (one refinement loop): the loss and the state
    after it against JAX's (jax_reference); the loss's gradient
    in the transformed source against JAX's at the port's transformed
    source (both losses' input gradients jump where a point's nearest
    neighbour, 3DmFV pooling argmax or cell switches, so they are compared
    at one point: chamfer within 1e-5, DPDist by the per-point criterion of
    tests/test_torch_losses_optim.py); the parameter gradients against the
    float64 backward of that cotangent (float64_grads) within REL_GRAD of
    each leaf's largest entry, and against JAX's within JAX_GRAD."""
    jtr, ttr = _pair(tmp_path, loss_type)
    tmpl, src = _clouds(2)
    with torch.enable_grad():
        out = tpcr.pcrnet_refine(ttr.params, ttr.pcfg, torch.tensor(src), torch.tensor(tmpl),
                                 iterations=1, state=ttr.state, train=True)[0]
        out_at = out.detach().requires_grad_(True)
        (cot,) = torch.autograd.grad(ttr._single_loss(out_at, torch.tensor(tmpl)), out_at)
    want = float64_grads(ttr.params, ttr.pcfg, ttr.state, tmpl, src, cot)
    jloss, jstate, jcot, jgrads = jax_reference(jtr.pcfg, loss_type, jtr.params, jtr.state,
                                                tmpl, src, (out.detach().numpy(), cot.numpy()))
    loss, grads, state = ttr.loss_grads_state(torch.tensor(tmpl), torch.tensor(src))
    assert float(loss) == pytest.approx(float(jloss), rel=TOL_TRAIN)
    _close_trees(state, jstate)
    jcot = np.asarray(jcot)
    err = np.abs(cot.numpy() - jcot).max(-1).flatten() / np.abs(jcot).max()
    if loss_type == "chamfer":
        assert err.max() <= 1e-5
    else:
        assert err.max() <= 5e-2 and np.mean(err > 1e-3) <= 0.05
    jgrads = dict(tree_flatten_with_paths(jax.device_get(jgrads)))
    # A conv bias before a BN has a zero gradient in exact arithmetic (the
    # batch mean removes it): float32 leaves it at rounding size, 1e-6 here,
    # under 1e-5 of the largest gradient entry of any leaf.
    floor = 1e-5 * max(float(w.abs().max()) for w in want)
    for (path, _), g, w in zip(tree_flatten_with_paths(ttr.params), grads, want):
        w = w.numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL_GRAD * scale + floor,
                                   err_msg=path)
        if scale > floor:    # JAX's rounding-sized bias gradients reach 1.4e-5
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[path]), rtol=0,
                                       atol=JAX_GRAD * scale, err_msg=path)
    m = ttr.train_step(tmpl, src)
    assert float(m["loss"]) == float(loss) and ttr.global_step == 1
    _close_trees(ttr.state, jstate)


def test_checkpoint_state_both_ways_and_evaluator(tmp_path):
    """The BN state is saved with the params and restored by either package;
    the evaluator runs on the running statistics, as JAX's."""
    jtr, ttr = _pair(tmp_path, "chamfer")
    ttr.train_step(*_clouds(3))
    path = ttr.save(tag="best")
    jp, js = jpcr.init_pcrnet(jax.random.PRNGKey(9), JaxPCRNetConfig(**SMALL))
    params, state, step = jax_restore(path, jp, js)
    assert step == 1 and state is not None
    _close_trees(ttr.state, state, 0, 0)
    fresh = PCRNetTrainer(PCRNetConfig(**SMALL), TrainConfig(batch_size=2), device="cpu",
                          run_dir=str(tmp_path / "fresh"),
                          logger=RunLogger(str(tmp_path / "fresh"), echo=False))
    fresh.restore(path)
    _close_trees(fresh.state, jax.tree_util.tree_map(np.asarray, state), 0, 0)
    jpath = jtr.save(tag="final")
    fresh.restore(jpath)
    _close_trees(fresh.state, jtr.state, 0, 0)

    kw = dict(num_point=32, n_templates=4, families=("chair", "box"), seed=5,
              max_rotate_deg=30.0)
    from dpdist_tpu.data.registration import RegistrationDataset as JaxDataset

    want = jax_evaluate(jax.device_get(jtr.params), jtr.pcfg, JaxDataset(**kw), num_cases=4,
                        iterations=3, batch_size=4, state=jax.device_get(jtr.state))
    got = evaluate_registration(fresh.params, fresh.pcfg, RegistrationDataset(**kw),
                                num_cases=4, iterations=3, batch_size=4, state=fresh.state,
                                device="cpu")
    for key in ("rot_err_mean_deg", "trans_err_mean"):
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-5), key


def golden_pcrnet_step(golden, device="cpu", run_dir=None):
    """The port's counterpart of the golden file's pcrnet_3dmfv section: the
    trainer from its seeded weights (tcfg.seed 0) and initial state, one
    step on the section's batch, the state's per-block sums after it, and an
    8-iteration eval refinement. Returns (metrics, block sums, poses)."""
    import tempfile

    g = golden["pcrnet_3dmfv"]
    cfg = PCRNetConfig.from_json(g["config"])
    data = {**g["data"], "families": tuple(g["data"]["families"])}
    tmpl, src, _ = RegistrationDataset(num_point=cfg.num_point, **data).sample_batch(
        g["batch_size"])
    with tempfile.TemporaryDirectory() as tmp:
        tr = PCRNetTrainer(cfg, TrainConfig(batch_size=g["batch_size"],
                                            learning_rate=g["learning_rate"]),
                           loss_type=g["loss_type"], dpdist=load_dpdist_checkpoint(NET),
                           device=device, run_dir=run_dir or tmp,
                           logger=RunLogger(run_dir or tmp, echo=False))
        m = tr.train_step(tmpl, src)
        sums = [float(sum(float(t.sum()) for _, t in tree_flatten_with_paths(b)))
                for b in tr.state["mfv_bn"]]
        with torch.no_grad():
            _, _, poses = tpcr.pcrnet_refine(
                tr.params, cfg, torch.as_tensor(src, device=device),
                torch.as_tensor(tmpl, device=device), iterations=8,
                stop_gradient_iters=False, state=tr.state)
    return m, sums, poses.cpu().numpy()


def test_golden_step_holds():
    """The golden file's 3dmfv PCRNet step (JAX on the port's seeded weights
    and state, the frozen DPDist loss, B = 8, 4 loops, Adam): its loss within
    1e-4 relative, its gradient norm within 5e-3, the state's sums after it
    within 1e-4 relative; the eval refinement's poses after the step within
    1e-3 (Adam's first step moves weights by lr * sign(g), so a gradient
    entry near 0 may move them the other way)."""
    golden = json.loads(AUE_GOLDEN_PATH.read_text())
    g = golden["pcrnet_3dmfv"]
    m, sums, poses = golden_pcrnet_step(golden)
    assert float(m["loss"]) == pytest.approx(g["loss"], rel=1e-4)
    assert float(m["grad_norm"]) == pytest.approx(g["grad_norm"], rel=REL_GRAD_DPDIST)
    np.testing.assert_allclose(sums, g["state_block_sums"], rtol=1e-4)
    np.testing.assert_allclose(poses, np.asarray(g["eval_poses"]), rtol=0, atol=1e-3)


def test_train_pcrnet_and_eval_registration_clis_take_3dmfv(tmp_path):
    """train_pcrnet --encoder 3dmfv writes a checkpoint with the BN state,
    which eval_registration evaluates on its running statistics."""
    from dpdist_tpu_torch.cli import eval_registration, train_pcrnet
    from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint_state

    log_dir = str(tmp_path / "run")
    trainer = train_pcrnet.main(
        ["--loss_type", "chamfer", "--encoder", "3dmfv", "--num_point", "32",
         "--out_features", "32", "--max_loops", "1", "--batch_size", "2", "--max_epoch", "1",
         "--batches_per_epoch", "2", "--families", "chair", "box", "--n_templates", "4",
         "--eval_cases", "2", "--log_dir", log_dir, "--device", "cpu"])
    assert trainer.global_step == 2
    ckpt = str(tmp_path / "run" / "pcrnet_ckpt_final")
    cfg, params, state = load_pcrnet_checkpoint_state(ckpt)
    assert cfg.encoder == "3dmfv" and len(state["mfv_bn"]) == 6
    for (p, a), (_, b) in zip(tree_flatten_with_paths(state), tree_flatten_with_paths(trainer.state)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=p)
    rep = eval_registration.main(["--ckpt", ckpt, "--num_cases", "4", "--iterations", "2",
                                  "--families", "chair", "box", "--n_templates", "4",
                                  "--report_dir", str(tmp_path / "eval"), "--device", "cpu"])
    assert rep["num_cases"] == 4 and np.isfinite(rep["rot_err_mean_deg"])
