"""The serving export of the frozen distance (dpdist_tpu_torch/serving.py:
export_frozen_distance, save_exported, load_exported, the export_serving
and run_serving CLIs, and the kernels as ops, kernels/ops.py) against
dpdist_tpu.serving's jax.export artifacts on the same weights, carried
across, and the same inputs made with numpy. (The registration policy's
export is tests/test_torch_serving_registration.py.)

Tolerances: distances and per-pair losses within 1e-6 relative (both
packages run the plain composition: the 3DmFV sums differ in order only);
their source gradients within 1e-5 relative + 1e-7 absolute, the bound
tests/test_serving.py holds JAX's own artifacts to; the native program
against the portable one on the CPU within 1e-6 relative (the ops run the
kernels' plain versions, which sum in another order).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu import serving as jserving
from dpdist_tpu.configs import DPDistConfig as JaxDPDistConfig
from dpdist_tpu.models import init_dpdist as jax_init_dpdist
from dpdist_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from dpdist_tpu_torch import serving
from dpdist_tpu_torch.cli.export_serving import main as export_main
from dpdist_tpu_torch.cli.run_serving import main as run_main
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels import ops
from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist
from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
from dpdist_tpu_torch.serving import FrozenDistance
from dpdist_tpu_torch.train import params_from_jax

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
REL_DIST = 1e-6
REL_GRAD, ABS_GRAD = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: many small eager ops on a CPU shared by xdist
    workers stall at the thread pool's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dist():
    """(JAX params, state, port params, state, a, b) at the small config."""
    jp, js = jax_init_dpdist(jax.random.PRNGKey(0), JaxDPDistConfig(**SMALL))
    p = params_from_jax(jax.device_get(jp), "cpu")
    s = params_from_jax(jax.device_get(js), "cpu", model="state")
    rng = np.random.default_rng(0)
    a, b = (rng.uniform(-0.8, 0.8, (2, 16, 3)).astype(np.float32) for _ in range(2))
    return jp, js, p, s, a, b


_EXPORTS = {}


def _export_dist(p, s, **kw):
    """export_frozen_distance at the small config on the CPU, batch 2 unless
    kw says otherwise, once per module for the same arguments."""
    key = ("dist", tuple(sorted(kw.items())))
    if key not in _EXPORTS:
        kw = {"batch": 2, **kw}
        cfg = DPDistConfig(**SMALL, **kw.pop("cfg", {}))
        _EXPORTS[key] = serving.export_frozen_distance(p, s, cfg, device="cpu", **kw)
    return _EXPORTS[key]


def _call(ep, *clouds):
    out = ep.module()(*(torch.as_tensor(c) for c in clouds))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _close_rel(got, want, rel):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rel, atol=0)


def test_export_roundtrip_matches_jax(dist, tmp_path):
    jp, js, p, s, a, b = dist
    ep = _export_dist(p, s)
    want = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(**SMALL), batch=2).call(a, b)
    _close_rel(_call(ep, a, b), want, REL_DIST)
    path = str(tmp_path / "model.pt2")
    serving.save_exported(ep, path)
    assert os.path.getsize(path) > 0
    _close_rel(_call(serving.load_exported(path), a, b), want, REL_DIST)
    assert serving.exported_inputs(ep) == (2, 16)


def test_export_symbolic_batch_serves_any_size(dist):
    jp, js, p, s, a, b = dist
    ep = serving.export_frozen_distance(p, s, DPDistConfig(**SMALL), device="cpu")
    assert serving.exported_inputs(ep) == (None, 16)
    jexp = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(**SMALL))
    for B in (1, 3, 5):
        ta, tb = np.tile(a[:1], (B, 1, 1)), np.tile(b[:1], (B, 1, 1))
        out = _call(ep, ta, tb)
        assert out.shape == (B,)
        np.testing.assert_array_equal(out, np.full(B, out[0]))
        _close_rel(out, jexp.call(ta, tb), REL_DIST)


def test_export_with_grad_matches_jax(dist):
    jp, js, p, s, a, b = dist
    vals, grads = _call(_export_dist(p, s, with_grad=True), a, b)
    assert vals.shape == (2,) and grads.shape == (2, 16, 3)
    wv, wg = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(**SMALL), batch=2,
                                             with_grad=True).call(a, b)
    _close_rel(vals, wv, REL_DIST)
    np.testing.assert_allclose(grads, np.asarray(wg), rtol=REL_GRAD, atol=ABS_GRAD)


def test_export_cli(dist, tmp_path, capsys):
    jp, js, _, _, a, b = dist
    ck = str(tmp_path / "ckpt_1")
    jax_save_checkpoint(ck, {"params": jp, "state": js},
                        metadata={"model_config": JaxDPDistConfig(**SMALL).to_json()})
    out = str(tmp_path / "model.pt2")
    export_main(["--dpdist_ckpt", ck, "--out", out, "--batch", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "bytes": os.path.getsize(out), "inputs": [[2, 16, 3]] * 2,
                    "device": "cpu", "with_grad": False, "native_kernels": False}
    want = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(**SMALL), batch=2).call(a, b)
    _close_rel(_call(serving.load_exported(out), a, b), want, REL_DIST)


def test_export_canonical_config_traces(tmp_path):
    """The portable export at the canonical config (512 Gaussians, k=5, MLP
    1024^3): the weights are in the file (over 1 MB), and a pair matches
    JAX's canonical artifact on the same weights. The batch is pinned to 1
    here (a symbolic batch traces the canonical config 4x slower; it is
    held at the small config)."""
    jp, js = jax_init_dpdist(jax.random.PRNGKey(0), JaxDPDistConfig())
    ep = serving.export_frozen_distance(params_from_jax(jax.device_get(jp), "cpu"),
                                        params_from_jax(jax.device_get(js), "cpu",
                                                        model="state"),
                                        DPDistConfig(), batch=1, device="cpu")
    assert serving.exported_inputs(ep) == (1, 64)
    path = str(tmp_path / "canonical.pt2")
    serving.save_exported(ep, path)
    assert os.path.getsize(path) > 1_000_000
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-0.8, 0.8, (1, 64, 3)).astype(np.float32) for _ in range(2))
    want = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(), batch=1).call(a, b)
    _close_rel(_call(serving.load_exported(path), a, b), want, REL_DIST)


def test_run_serving_cli_distance_with_grad(dist, tmp_path, capsys):
    jp, js, p, s, a, b = dist
    art = str(tmp_path / "model.pt2")
    serving.save_exported(_export_dist(p, s, with_grad=True), art)
    np.save(str(tmp_path / "t.npy"), a)
    np.save(str(tmp_path / "s.npy"), b)
    run_main(["--artifact", art, "--template", str(tmp_path / "t.npy"),
              "--source", str(tmp_path / "s.npy"), "--device", "cpu"])
    brief = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(brief["distance"]) == 2 and len(brief["grad_norm_per_pair"]) == 2
    wv, wg = jserving.export_frozen_distance(jp, js, JaxDPDistConfig(**SMALL), batch=2,
                                             with_grad=True).call(a, b)
    _close_rel(np.asarray(brief["distance"]), wv, REL_DIST)
    np.testing.assert_allclose(brief["grad_norm_per_pair"],
                               np.linalg.norm(np.asarray(wg).reshape(2, -1), axis=-1),
                               rtol=REL_GRAD)


def test_portable_artifact_loads_without_the_port(dist, tmp_path):
    """A process that imports neither dpdist_tpu_torch nor JAX loads the
    portable program with torch alone and gets the same distances."""
    _, _, p, s, a, b = dist
    path = str(tmp_path / "model.pt2")
    serving.save_exported(_export_dist(p, s), path)
    np.save(str(tmp_path / "a.npy"), a)
    np.save(str(tmp_path / "b.npy"), b)
    code = ("import sys, numpy as np, torch\n"
            "ep = torch.export.load('model.pt2')\n"
            "d = ep.module()(*(torch.as_tensor(np.load(f)) for f in ('a.npy', 'b.npy')))\n"
            "np.save('d.npy', d.numpy())\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('dpdist_tpu_torch', 'dpdist_tpu', 'jax', 'jaxlib')], sorted(sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = FrozenDistance(DPDistConfig(**SMALL, fused_gather="off"), p, s)(
        torch.as_tensor(a), torch.as_tensor(b)).detach().numpy()
    np.testing.assert_array_equal(np.load(str(tmp_path / "d.npy")), want)


def _dpdist_ops(ep):
    return sorted({str(n.target).split(".")[1] for n in ep.graph.nodes
                   if str(n.target).startswith("dpdist.")})


# Native programs on the CPU: the ops `route` names for the card, each
# running its plain version here. "auto" at 16 points: row 1; "table":
# row 2; "on": row 10; at 128 points "table" encodes by row 7, and at 129
# queries gathers by row 6; bf16 "full": row 9.
NATIVE = [
    ({}, 16, ["mfv_x"]),
    ({"fused_gather": "table"}, 16, ["table_gather_x"]),
    ({"fused_gather": "on"}, 16, ["gather_patches_fused"]),
    ({"fused_gather": "table"}, 129, ["table_gather", "threedmfv"]),
    ({"fused_gather": "full", "dtype": "bfloat16"}, 16, ["fused_forward"]),
]


@pytest.mark.parametrize("over,num_point,want_ops", NATIVE,
                         ids=["mfv", "table", "on", "table129", "full_bf16"])
def test_native_export_holds_the_kernel_ops(dist, over, num_point, want_ops):
    """portable=False, symbolic batch: the graph holds the dpdist ops route
    names for the card, and on the CPU the program serves B = 1 and 3 as
    the eager model does (its wrappers' plain versions)."""
    _, _, p, s, _, _ = dist
    cfg = DPDistConfig(**{**SMALL, **over})
    ep = serving.export_frozen_distance(p, s, cfg, num_point=num_point, portable=False,
                                        device="cpu")
    assert _dpdist_ops(ep) == want_ops
    assert serving.exported_inputs(ep) == (None, num_point)
    rng = np.random.default_rng(6)
    for B in (1, 3):
        a, b = (rng.uniform(-1.1, 1.1, (B, num_point, 3)).astype(np.float32) for _ in range(2))
        with torch.no_grad():
            want = FrozenDistance(cfg, p, s)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        _close_rel(_call(ep, a, b), want, REL_DIST)


@pytest.mark.parametrize("num_point,want_ops", [
    (16, ["table_gather_bwd", "table_gather_x"]),
    (129, ["table_gather", "table_gather_bwd", "threedmfv"]),
], ids=["np16", "np129"])
def test_native_grad_export_holds_row_3(dist, num_point, want_ops):
    """The native with_grad program holds the gathers and their adjoint,
    row 3 (and at 129 points row 7, whose backward replays the plain
    encode), and equals the portable one on the CPU."""
    _, _, p, s, _, _ = dist
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(-0.8, 0.8, (2, num_point, 3)).astype(np.float32) for _ in range(2))
    ep = _export_dist(p, s, with_grad=True, portable=False, num_point=num_point)
    assert _dpdist_ops(ep) == want_ops
    vals, grads = _call(ep, a, b)
    wv, wg = _call(_export_dist(p, s, with_grad=True, num_point=num_point), a, b)
    _close_rel(vals, wv, REL_DIST)
    np.testing.assert_allclose(grads, wg, rtol=REL_GRAD, atol=ABS_GRAD)


def test_per_pair_barrier_equals_vmap_grad(dist):
    """At points outside the grid, with_grad's values and gradients are
    vmap(grad(one)) of the port's frozen loss on single pairs: the barrier
    is taken per pair, not over the batch."""
    _, _, p, s, _, _ = dist
    cfg = DPDistConfig(**SMALL)
    rng = np.random.default_rng(7)
    a, b = (torch.as_tensor(rng.uniform(-1.4, 1.4, (2, 16, 3)).astype(np.float32))
            for _ in range(2))
    assert bool((a.abs() > 1).any() and (b.abs() > 1).any())
    loss_fn = make_frozen_dpdist_loss(p, cfg, state=s)

    def one(x, y):
        return loss_fn(x[None], y[None])

    want_v = torch.func.vmap(one)(a, b)
    want_g = torch.func.vmap(torch.func.grad(one))(a, b)
    vals, grads = _export_dist(p, s, with_grad=True).module()(a, b)
    _close_rel(vals.numpy(), want_v.numpy(), REL_DIST)
    np.testing.assert_allclose(grads.numpy(), want_g.numpy(), rtol=REL_GRAD, atol=ABS_GRAD)
    # A batch-wide barrier would differ: the pairs' barriers are not equal.
    per_pair = torch.relu(a.abs() - 1).mean(dim=(1, 2))
    assert float(per_pair.max() - per_pair.min()) > 1e-3


def test_native_export_raises_at_a_kernel_without_an_op():
    """Row 8 has no op: a native export that would reach it raises, naming it."""
    assert ops.dispatch(nn_min_sqdist) is nn_min_sqdist
    with ops.exporting("native"), pytest.raises(NotImplementedError, match="row 8"):
        ops.dispatch(nn_min_sqdist)
    with pytest.raises(ValueError, match="export mode"):
        with ops.exporting("tpu"):
            pass


def test_native_full_bounds_the_symbolic_batch(dist):
    """A native bf16 "full" program's symbolic batch stops where row 9's
    batch limit does (kernels.fused_forward.fused_forward_batch_fits)."""
    _, _, p, s, a, b = dist
    from dpdist_tpu_torch.kernels.fused_forward import fused_forward_batch_fits

    cfg = DPDistConfig(**SMALL, fused_gather="full", dtype="bfloat16")
    ep = serving.export_frozen_distance(p, s, cfg, portable=False, device="cpu")
    (rng,) = [r for sym, r in ep.range_constraints.items()]
    assert fused_forward_batch_fits(2 * rng.upper, 16, cfg.grid_size, cfg.fv_channels)
    assert not fused_forward_batch_fits(2 * (rng.upper + 1), 16, cfg.grid_size,
                                        cfg.fv_channels)
