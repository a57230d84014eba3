"""The DPDist distance on clouds above 128 points: the model's kernel
routing (models.dpdist.route) against the reference's branch conditions,
the forward, the served distance and the frozen loss at np = 256 on both
committed nets, and eval_pair on cloud files, against dpdist_tpu.

On the CPU the port's "table" path runs each kernel wrapper's plain
version (the same wrappers, autograd Functions and backwards as on the
card); JAX runs its XLA path.
"""

import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import dpdist_distance as jax_distance
from dpdist_tpu.models.dpdist import _fused_gather_mode as jax_fused_gather_mode
from dpdist_tpu.models.dpdist import resolve_for_grad as jax_resolve_for_grad

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x
from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_bwd, table_gather_x
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.models import apply_dpdist, dpdist_distance
from dpdist_tpu_torch.models.dpdist import Route, route
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax

# The module, not the function dpdist_tpu.ops re-exports under its name.
jax_threedmfv_module = importlib.import_module("dpdist_tpu.ops.threedmfv")

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
# Port against dpdist_tpu on the CPU: the encode and the decoder sum in
# other orders (tests/test_torch_dpdist.py's tolerance).
TOL = 1e-4
# Input gradients, per point relative to the largest entry (the criterion
# of tests/test_torch_losses_optim.py, which says why).
REL_GRAD, REL_GRAD_FEW, OUTLIERS = 1e-3, 5e-2, 0.05
# Chamfer and EMD of eval_pair (tests/test_torch_chamfer_emd.py's).
TOL_CHAMFER = TOL_EMD = 1e-5

MFV = Route("mfv", ("mfv_gather_x",) * 2, ("mfv_gather_x",) * 2)
OFF = Route("off", ("plain",) * 2, ("plain",) * 2)


def _table(encode, gather):
    return Route("table", encode, gather)


K2, KX, K6, P = ("threedmfv",) * 2, ("table_gather_x",) * 2, ("table_gather",) * 2, ("plain",) * 2


def _close_rel(got, want):
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    assert err.max() <= REL_GRAD_FEW, err.max()
    assert np.mean(err > REL_GRAD) <= OUTLIERS, np.sort(err.ravel())[-8:]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_a,n_b,grad,want", [
    # A pure forward: the fused kernel up to 128 points, the table path above.
    (64, 64, False, MFV),
    (128, 128, False, MFV),
    (129, 129, False, _table(K2, K6)),
    (300, 300, False, _table(K2, K6)),
    (64, 300, False, _table(("plain", "threedmfv"), ("table_gather", "table_gather_x"))),
    (300, 64, False, _table(("threedmfv", "plain"), ("table_gather_x", "table_gather"))),
    # A gradient context: always the table path.
    (64, 64, True, _table(P, KX)),
    (128, 128, True, _table(K2, KX)),
    (129, 129, True, _table(K2, K6)),
    (300, 300, True, _table(K2, K6)),
    (64, 300, True, _table(("plain", "threedmfv"), ("table_gather", "table_gather_x"))),
])
def test_route_on_cuda_follows_the_reference(n_a, n_b, grad, want):
    assert route(DPDistConfig(), "cuda", n_a, n_b, grad=grad) == want


@pytest.mark.parametrize("fused_gather,grad", [
    ("auto", False), ("auto", True), ("mfv", False), ("mfv", True), ("table", False),
    ("full", False), ("full", True), ("on", False), ("on", True),
])
def test_route_mode_is_the_reference_mode_on_its_accelerator(monkeypatch, fused_gather, grad):
    """The mode before the size rules is what the reference resolves on
    its accelerator (its _on_tpu patched to True), for float32. Not for
    "off": the reference resolves it there as "auto" (its
    _fused_gather_mode has no case for it), while the port keeps "off" the
    plain composition on every device (test_route_off_is_plain)."""
    monkeypatch.setattr(jax_threedmfv_module, "_on_tpu", lambda: True)
    jcfg = JaxConfig(fused_gather=fused_gather)
    if grad:
        jcfg = jax_resolve_for_grad(jcfg)
    want = jax_fused_gather_mode(jcfg)
    got = route(DPDistConfig(fused_gather=fused_gather), "cuda", 64, 64, grad=grad)
    assert got.mode == want


@pytest.mark.parametrize("grad", [False, True])
def test_route_off_is_plain(grad):
    for n in (64, 300):
        assert route(DPDistConfig(fused_gather="off"), "cuda", n, n, grad=grad) == OFF


@pytest.mark.parametrize("n", [64, 300])
def test_route_on_cpu(n):
    """"auto" takes the plain composition on the CPU, forward or gradient;
    explicit modes keep their size rules there (the wrappers then run their
    plain versions)."""
    assert route(DPDistConfig(), "cpu", n, n) == OFF
    assert route(DPDistConfig(), "cpu", n, n, grad=True) == OFF
    table = route(DPDistConfig(fused_gather="table"), "cpu", n, n)
    assert table == route(DPDistConfig(fused_gather="table"), "cuda", n, n)


# ---------------------------------------------------------------------------
# The slice at np = 256 against JAX's XLA path
# ---------------------------------------------------------------------------

def _inputs(seed, B=2, n_a=256, n_b=256):
    """Clouds of which some points lie outside [-1, 1]^3."""
    r = np.random.default_rng(seed)
    return (r.uniform(-0.9, 0.9, (B, n_a, 3)).astype(np.float32),
            r.uniform(-1.1, 1.1, (B, n_b, 3)).astype(np.float32))


@functools.partial(jax.jit, static_argnums=(2,))
def jax_frozen_value_and_grad(params, state, cfg, pcA, pcB):
    """JAX's frozen loss (penalty 1.0) and its gradient in pcA, jitted with
    the parameters as arguments so that the two nets share one compile."""
    return jax.value_and_grad(jax_frozen_loss(params, state, cfg))(pcA, pcB)


@pytest.fixture(scope="module", params=NETS)
def net(request):
    cfg, params, state = jax_load(request.param)
    tcfg, tparams_np, _ = load_dpdist_checkpoint(request.param)
    return request.param, (cfg, params, state), (tcfg, params_from_jax(tparams_np, "cpu"))


def _launches():
    return [w.launches for w in (mfv_x, threedmfv_kernel, table_gather_x, table_gather,
                                 table_gather_bwd, nn_min_sqdist)]


@pytest.mark.parametrize("n_a,n_b", [(256, 256), (64, 300)])
def test_table_path_forward_matches_jax(net, n_a, n_b):
    """Predictions and distances of the table path (row 7 and row 6's
    wrappers at 256 points; mixed sizes add row 2's) against JAX."""
    _, (cfg, params, state), (tcfg, tparams) = net
    pcA, pcB = _inputs(n_a + n_b, n_a=n_a, n_b=n_b)
    jAB, jBA, _ = jax_apply(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB))
    want = jax_distance(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB), per_example=True)
    tA, tB = torch.as_tensor(pcA), torch.as_tensor(pcB)
    table = tcfg.replace(fused_gather="table")
    with torch.no_grad():
        pAB, pBA = apply_dpdist(tparams, table, tA, tB)
        got = dpdist_distance(tparams, table, tA, tB, per_example=True)
        off = dpdist_distance(tparams, tcfg, tA, tB, per_example=True)
    np.testing.assert_allclose(pAB.numpy(), np.asarray(jAB), atol=TOL, rtol=0)
    np.testing.assert_allclose(pBA.numpy(), np.asarray(jBA), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(off.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.asarray(jAB)[..., 0].min() == 0.0    # off-grid points were masked
    assert _launches() == [0] * 6


def test_frozen_loss_at_np256_matches_jax(net):
    """The frozen loss and d/dpcA on the table path (as a gradient context
    resolves on the card) against JAX's XLA path; the parameters get no
    gradient, and the encode of pcB is not replayed."""
    _, (cfg, params, state), (tcfg, tparams) = net
    pcA, pcB = _inputs(7)
    want, jgrad = jax_frozen_value_and_grad(params, state, cfg.replace(fused_gather="off"),
                                            jnp.asarray(pcA), jnp.asarray(pcB))
    leaves = [t.requires_grad_(True) for lp in tparams["decoder"]["layers"] for t in lp.values()]
    loss_fn = make_frozen_dpdist_loss(tparams, tcfg.replace(fused_gather="table"))
    tA = torch.tensor(pcA, requires_grad=True)
    replays = threedmfv_kernel.replays
    got = loss_fn(tA, torch.as_tensor(pcB))
    (grad,) = torch.autograd.grad(got, tA)
    assert threedmfv_kernel.replays == replays + 1
    assert abs(float(got.detach()) - float(want)) <= TOL
    _close_rel(grad.numpy(), np.asarray(jgrad))
    assert all(t.grad is None for t in leaves)
    for t in leaves:
        t.requires_grad_(False)


@pytest.mark.parametrize("N", [64, 150])
def test_full_float32_runs_table_and_matches_jax(net, N):
    """fused_gather="full" in float32: the reference runs its table path
    (the Pallas gathers, here in interpret mode), and so does the port."""
    _, (cfg, params, state), (tcfg, tparams) = net
    pcA, pcB = _inputs(N, n_a=N, n_b=N)
    full = tcfg.replace(fused_gather="full")
    assert route(full, "cuda", N, N).mode == "table"
    want = jax_distance(params, state, cfg.replace(fused_gather="full"), jnp.asarray(pcA),
                        jnp.asarray(pcB), per_example=True)
    tA, tB = torch.as_tensor(pcA), torch.as_tensor(pcB)
    with torch.no_grad():
        got = dpdist_distance(tparams, full, tA, tB, per_example=True)
        table = dpdist_distance(tparams, tcfg.replace(fused_gather="table"), tA, tB,
                                per_example=True)
    assert torch.equal(got, table)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_served_distance_at_np256(net):
    """FrozenDistance at np = 256 on the CPU against JAX, with and without
    an input gradient."""
    path, (cfg, params, state), _ = net
    pcA, pcB = _inputs(9, B=3)
    want = np.asarray(jax_distance(params, state, cfg, jnp.asarray(pcA), jnp.asarray(pcB),
                                   per_example=True))
    model = load_frozen_distance(path, device="cpu", fused_gather="table")
    with torch.no_grad():
        got = model(torch.as_tensor(pcA), torch.as_tensor(pcB))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    tA = torch.tensor(pcA, requires_grad=True)
    d = model(tA, torch.as_tensor(pcB))
    (g,) = torch.autograd.grad(d.sum(), tA)
    np.testing.assert_allclose(d.detach().numpy(), want, atol=TOL, rtol=0)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# eval_pair on cloud files
# ---------------------------------------------------------------------------

def test_eval_pair_on_cloud_files_matches_jax(tmp_path, capsys):
    """Two csv clouds of 300 and 310 points (so N > 128, trimmed to 300 as
    the reference trims): all three keys against JAX's eval_pair."""
    from dpdist_tpu.cli.eval_pair import main as jax_main

    from dpdist_tpu_torch.cli.eval_pair import main
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    files = []
    for name, family, n in (("a.txt", "chair", 300), ("b.txt", "box", 310)):
        pts = synthetic_surface(family, seed=len(files), n_points=n) * 0.8
        np.savetxt(tmp_path / name, pts, delimiter=",")
        files.append(str(tmp_path / name))
    args = ["--dpdist_ckpt", NETS[0], "--cloud_a", files[0], "--cloud_b", files[1],
            "--num_point", "10000"]
    jax_main(args)
    want = json.loads(capsys.readouterr().out)
    got = main(args + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == set(want) == {"dpdist", "chamfer", "emd"}
    assert abs(got["dpdist"] - want["dpdist"]) <= TOL
    assert abs(got["chamfer"] - want["chamfer"]) <= TOL_CHAMFER
    assert abs(got["emd"] - want["emd"]) <= TOL_EMD
