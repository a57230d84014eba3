"""The port's PCRNet policy (dpdist_tpu_torch/models/pcrnet.py) against
dpdist_tpu's, on the CPU: the forward, the refinement with its pose
history and trajectory, and the gradients of last-iteration and full-BPTT
refinement, at a small width from JAX-initialised weights and with the
committed production policy.

Tolerances: poses and transformed sources within 2e-5 (float32 sums of
widths up to 2048 in other orders); parameter gradients within 1e-4 of
each leaf's largest entry.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.models import pcrnet as jpcr
from dpdist_tpu.train.checkpoint import restore_params_maybe_state as jax_restore

from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.models import pcrnet as tpcr
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

POLICY = "results/policy_mf_tsn1200clip_dpdist_final"
SMALL = dict(num_point=16, out_features=32, head_widths=(32, 16), max_loops=3)
TOL = 2e-5
REL_GRAD = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread: these eager ops are small, and on a CPU shared by
    the suite's parallel workers a thread pool's barriers wait on cores
    that other workers hold (with 8 threads, the registration CLI test's
    training took 186 s among 6 workers against 4.4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return JaxPCRNetConfig(**{**SMALL, **over}), PCRNetConfig(**{**SMALL, **over})


def _params(jcfg, seed=0):
    jparams, jstate = jpcr.init_pcrnet(jax.random.PRNGKey(seed), jcfg)
    return jparams, jstate, tpcr.params_to_device(jax.device_get(jparams), "cpu")


def _clouds(seed, B=3, N=16):
    r = np.random.default_rng(seed)
    tmpl = r.uniform(-0.6, 0.6, (B, N, 3)).astype(np.float32)
    src = (tmpl + r.normal(0, 0.05, tmpl.shape)).astype(np.float32)[:, r.permutation(N)]
    return tmpl, src


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("over", [{}, {"encoder": "pointnet_avg"}, {"lim_rot": 10.0}],
                         ids=["pointnet", "pointnet_avg", "lim_rot"])
def test_apply_pcrnet_matches_jax(over):
    jcfg, cfg = _cfgs(**over)
    jparams, jstate, params = _params(jcfg)
    tmpl, src = _clouds(0)
    want = jpcr.apply_pcrnet(jparams, jcfg, src, tmpl, state=jstate)
    got = tpcr.apply_pcrnet(params, cfg, torch.tensor(src), torch.tensor(tmpl))
    _close(got, want)
    assert tpcr.template_feats_invariant(cfg)
    tf = tpcr.encode_template(params, cfg, torch.tensor(tmpl))
    _close(tpcr.apply_pcrnet(params, cfg, torch.tensor(src), None, template_feats=tf), want)


@pytest.mark.parametrize("over", [{}, {"encoder": "pointnet_avg"}, {"lim_rot": 10.0}],
                         ids=["pointnet", "pointnet_avg", "lim_rot"])
def test_refine_eval_with_trajectory_matches_jax(over):
    jcfg, cfg = _cfgs(**over)
    jparams, jstate, params = _params(jcfg, seed=1)
    tmpl, src = _clouds(1)
    want = jpcr.pcrnet_refine(jparams, jcfg, src, tmpl, iterations=5, state=jstate,
                              return_trajectory=True)
    with torch.no_grad():
        got = tpcr.pcrnet_refine(params, cfg, torch.tensor(src), torch.tensor(tmpl),
                                 iterations=5, return_trajectory=True)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        _close(g, w, 5e-5)


@functools.partial(jax.jit, static_argnums=(1, 4))
def _jax_refine_grads(jparams, jcfg, src, tmpl, stop_gradient_iters, coef):
    def f(p):
        out, T, poses, traj = jpcr.pcrnet_refine(p, jcfg, src, tmpl, iterations=4,
                                                 stop_gradient_iters=stop_gradient_iters,
                                                 return_trajectory=True, train=True)
        return jnp.sum(out * coef) + jnp.sum(traj ** 2) * 0.1 + jnp.sum(T[:, :3, :] ** 2)

    return jax.grad(f)(jparams)


@pytest.mark.parametrize("stop_gradient_iters", [True, False], ids=["last", "bptt"])
def test_refine_gradients_match_jax(stop_gradient_iters):
    """Gradients in every parameter leaf through 4 refinement iterations:
    only the last one's (the default training mode, earlier sources and
    transforms detached) or all of them (full BPTT). A loss on the
    trajectory and on T sees where gradients stop."""
    jcfg, cfg = _cfgs()
    jparams, _, params = _params(jcfg, seed=2)
    tmpl, src = _clouds(2)
    coef = np.random.default_rng(3).normal(size=src.shape).astype(np.float32)
    want = jax.device_get(_jax_refine_grads(jparams, jcfg, src, tmpl, stop_gradient_iters, coef))
    params = tpcr.params_to_device(params, "cpu", requires_grad=True)
    out, T, _, traj = tpcr.pcrnet_refine(params, cfg, torch.tensor(src), torch.tensor(tmpl),
                                         iterations=4, stop_gradient_iters=stop_gradient_iters,
                                         return_trajectory=True)
    f = torch.sum(out * torch.tensor(coef)) + torch.sum(traj ** 2) * 0.1 + torch.sum(
        T[:, :3, :] ** 2)
    leaves = tree_flatten_with_paths(params)
    grads = torch.autograd.grad(f, [t for _, t in leaves])
    wants = dict(tree_flatten_with_paths(want))
    for (path, _), g in zip(leaves, grads):
        w = np.asarray(wants[path])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=REL_GRAD * np.abs(w).max(),
                                   err_msg=path)


def test_max_pool_ties_split_the_gradient_as_jax():
    """Duplicated source points give identical feature rows, so the max
    over points ties. JAX splits the gradient evenly among tied maxima;
    so does the port (torch.amax). torch.max(dim).values hands all of it to
    one point: the same test then fails."""
    jcfg, cfg = _cfgs()
    jparams, jstate, params = _params(jcfg, seed=4)
    tmpl, src = _clouds(4)
    src[:, 8:] = src[:, :8]   # every point twice
    want = np.asarray(jax.grad(lambda s: jnp.sum(
        jpcr.apply_pcrnet(jparams, jcfg, s, tmpl, state=jstate) ** 2))(src))

    def port_grad():
        s = torch.tensor(src, requires_grad=True)
        return torch.autograd.grad(torch.sum(tpcr.apply_pcrnet(
            params, cfg, s, torch.tensor(tmpl)) ** 2), s)[0].numpy()

    tol = REL_GRAD * np.abs(want).max()
    np.testing.assert_allclose(port_grad(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(port_grad()[:, :8], port_grad()[:, 8:], rtol=0, atol=tol)

    def encode_with_torch_max(p, c, points):
        x = points
        for lp in p["encoder"]:
            x = torch.relu(tpcr.dense_apply(lp, x))
        return torch.max(x, dim=1).values

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpcr, "_encode", encode_with_torch_max)
        got = port_grad()
    assert np.abs(got - want).max() > 100 * tol


def test_production_policy_refines_as_jax():
    """The committed production policy (pointnet 3-64-64-64-128-1024, head
    2048-1024-512-256-7), B = 4 cases of the production protocol's data, 8
    iterations in eval mode: poses, transform and refined source."""
    from dpdist_tpu_torch.data.registration import RegistrationDataset, default_eval_poses

    with open(POLICY + ".json") as f:
        jcfg = JaxPCRNetConfig.from_json(json.load(f)["metadata"]["pcrnet_config"])
    tp, ts = jpcr.init_pcrnet(jax.random.PRNGKey(0), jcfg)
    jparams, jstate, _ = jax_restore(POLICY, tp, ts)
    cfg, params = load_pcrnet_checkpoint(POLICY)
    params = tpcr.params_to_device(params, "cpu")
    ds = RegistrationDataset(pose_file=default_eval_poses(), num_point=cfg.num_point,
                             n_templates=5, families=("chair", "sphere", "box", "cylinder",
                                                      "torus"), sparse=1, s_rand_points=1.0,
                             centroid_sub=False, seed=777)
    tmpl, src, _ = ds.sample_batch(4)
    want = jax.jit(functools.partial(jpcr.pcrnet_refine, cfg=jcfg, iterations=8, state=jstate,
                                     stop_gradient_iters=False))(jparams, source=src,
                                                                 template=tmpl)
    with torch.no_grad():
        got = tpcr.pcrnet_refine(params, cfg, torch.tensor(src), torch.tensor(tmpl),
                                 iterations=8, stop_gradient_iters=False)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_3dmfv_encoder_raises():
    """The 3dmfv encoder is ported (its parity with JAX:
    tests/test_torch_pcrnet_3dmfv.py); it raises where the reference
    refuses: a hoisted template encoding in training or without running
    statistics, where BN couples the two clouds. An unknown encoder raises."""
    cfg = PCRNetConfig(**{**SMALL, "encoder": "3dmfv", "mfv_grid": 2})
    params = tpcr.init_pcrnet(cfg, torch.Generator().manual_seed(0), "cpu")
    state = tpcr.init_pcrnet_state(cfg, "cpu")
    clouds = torch.zeros(1, 16, 3), torch.zeros(1, 16, 3)
    tf = tpcr.encode_template(params, cfg, clouds[1], state=state)
    assert tpcr.template_feats_invariant(cfg, state, train=False)
    for st, train in ((state, True), (None, False)):
        assert not tpcr.template_feats_invariant(cfg, st, train)
        with pytest.raises(ValueError, match="batch-independent"):
            tpcr.apply_pcrnet(params, cfg, clouds[0], None, template_feats=tf, state=st,
                              train=train)
    with pytest.raises(ValueError, match="unknown PCRNet encoder"):
        tpcr.init_pcrnet(PCRNetConfig(encoder="dgcnn"), device="cpu")


def test_init_pcrnet_structure_and_xavier_limits():
    """The same tree, shapes and key paths as JAX's init (so checkpoints load
    both ways; the pointnet policy has no state, JAX's is {}), weights within
    the xavier limits, zero biases."""
    jcfg, cfg = _cfgs()
    jparams, jstate = jpcr.init_pcrnet(jax.random.PRNGKey(0), jcfg)
    assert jstate == {}
    params = tpcr.init_pcrnet(cfg, torch.Generator().manual_seed(0), "cpu")
    got = tree_flatten_with_paths(params)
    want = tree_flatten_with_paths(jax.device_get(jparams))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == w.shape, path
        if path.endswith("/b"):
            assert float(t.abs().max()) == 0.0
        else:
            fan_in, fan_out = (3, 192) if path == "encoder/0/w" else t.shape
            assert float(t.abs().max()) <= (6.0 / (fan_in + fan_out)) ** 0.5


def test_dropout():
    """Inverted dropout: train=False or keep 1 is the identity; kept entries
    are scaled by 1 / keep, dropped ones are 0, about keep of them kept."""
    from dpdist_tpu_torch.nn import dropout

    x = torch.ones(200, 100)
    assert dropout(None, x, 0.7, train=False) is x
    assert dropout(None, x, 1.0, train=True) is x
    y = dropout(torch.Generator().manual_seed(0), x, 0.7, train=True)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
