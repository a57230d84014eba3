"""The serving export of the registration policy
(dpdist_tpu_torch/serving.py:export_registration, and the export_serving
and run_serving CLIs on a policy) against dpdist_tpu.serving's jax.export
artifacts on the same weights, carried across, and the same inputs made
with numpy. Transforms and aligned clouds within 1e-5 relative + 1e-6
absolute, the bounds tests/test_serving.py holds JAX's own artifacts to;
early_exit against the fixed-length loop exactly. (The frozen distance's
export is tests/test_torch_serving.py; the two files run on separate
workers.)
"""

import json

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu import serving as jserving
from dpdist_tpu.cli.run_serving import main as jax_run_main
from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.models import init_pcrnet as jax_init_pcrnet
from dpdist_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from dpdist_tpu_torch import serving
from dpdist_tpu_torch.cli.export_serving import main as export_main
from dpdist_tpu_torch.cli.run_serving import main as run_main
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.data.io import read_ply, write_ply
from dpdist_tpu_torch.geometry.se3 import invert_transform
from dpdist_tpu_torch.models.pcrnet import init_pcrnet, pcrnet_refine
from dpdist_tpu_torch.train import params_from_jax

SMALL_PCR = dict(num_point=32, out_features=64, max_loops=2, eval_iterations=3,
                 head_widths=(64, 32))
REL_T, ABS_T = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: many small eager ops on a CPU shared by xdist
    workers stall at the thread pool's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _call(ep, *clouds):
    out = ep.module()(*(torch.as_tensor(c) for c in clouds))
    return tuple(o.numpy() for o in out)


def _close_T(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=REL_T, atol=ABS_T)


_EXPORTS = {}

@pytest.fixture(scope="module")
def policy():
    """(JAX params, state, port params, template, source) of a small policy."""
    jp, js = jax_init_pcrnet(jax.random.PRNGKey(1), JaxPCRNetConfig(**SMALL_PCR))
    rng = np.random.default_rng(3)
    tpl, src = (rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32) for _ in range(2))
    return jp, js, params_from_jax(jax.device_get(jp), "cpu", model="pcrnet"), tpl, src


def _export_reg(p, **kw):
    """export_registration of the small policy at batch 2 on the CPU, once
    per module for the same arguments."""
    key = ("reg", tuple(sorted(kw.items())))
    if key not in _EXPORTS:
        _EXPORTS[key] = serving.export_registration(p, PCRNetConfig(**SMALL_PCR), state={},
                                                     batch=2, device="cpu", **kw)
    return _EXPORTS[key]


def test_export_registration_policy(policy, tmp_path):
    jp, js, p, tpl, src = policy
    T_pred, aligned = _call(_export_reg(p), tpl, src)
    assert T_pred.shape == (2, 4, 4) and aligned.shape == (2, 32, 3)
    wT, wa = jserving.export_registration(jp, JaxPCRNetConfig(**SMALL_PCR), batch=2).call(tpl,
                                                                                          src)
    _close_T(T_pred, wT)
    _close_T(aligned, wa)

    # The CLI path, through a checkpoint file the JAX package wrote.
    ck = str(tmp_path / "pcrnet_ckpt_best")
    jax_save_checkpoint(ck, {"params": jp, "state": js},
                        metadata={"pcrnet_config": JaxPCRNetConfig(**SMALL_PCR).to_json()})
    out = str(tmp_path / "policy.pt2")
    export_main(["--pcrnet_ckpt", ck, "--out", out, "--batch", "2", "--iterations", "3",
                 "--device", "cpu"])
    T2, _ = _call(serving.load_exported(out), tpl, src)
    _close_T(T2, T_pred)


# The reference's stop cases: freezing at once (inf), never (0: all
# iterations run), and mid-way (inf at period 2 with chamfer selection).
STOPS = ({"stop_threshold": float("inf")}, {"stop_threshold": 0.0},
         {"stop_threshold": float("inf"), "stop_period": 2, "stop_select": "chamfer"})


@pytest.mark.parametrize("kw", STOPS, ids=["inf", "zero", "chamfer"])
def test_export_registration_early_exit_equals_masked_loop(policy, kw):
    """early_exit returns what the fixed-length loop with the stop masked in
    returns, and both what JAX's export of the same protocol does."""
    jp, _, p, tpl, src = policy
    Tm, am = _call(_export_reg(p, **kw), tpl, src)
    Te, ae = _call(_export_reg(p, early_exit=True, **kw), tpl, src)
    np.testing.assert_array_equal(Te, Tm)
    np.testing.assert_array_equal(ae, am)
    wT, wa = jserving.export_registration(jp, JaxPCRNetConfig(**SMALL_PCR), batch=2,
                                          early_exit=True, **kw).call(tpl, src)
    _close_T(Te, wT)
    _close_T(ae, wa)


def test_export_registration_stop_protocol(policy):
    """Threshold 0 never fires (the fixed-iteration policy); an infinite
    threshold with chamfer selection on a self-aligned pair freezes the
    identity, so T_pred == I and aligned == source. A 3dmfv policy without
    a BN state exports with a symbolic batch; early_exit without a
    threshold raises."""
    _, _, p, tpl, src = policy
    Tb, ab = _call(_export_reg(p), tpl, src)
    Tn, an = _call(_export_reg(p, stop_threshold=0.0), tpl, src)
    _close_T(Tn, Tb)
    _close_T(an, ab)
    Tc, ac = _call(_export_reg(p, stop_threshold=float("inf"), stop_select="chamfer"), tpl, tpl)
    np.testing.assert_allclose(Tc, np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)),
                               atol=1e-5)
    np.testing.assert_allclose(ac, tpl, atol=1e-5)
    # A 3dmfv policy exports too: without a state (batch-statistics BN, the
    # two clouds encoded as one batch on every trip) and with a symbolic
    # batch, served at B = 1 and 2; over the config's 3 iterations its
    # program gives the eager refinement bit for bit
    # (tests/test_torch_serving_3dmfv.py holds every form against JAX's).
    cfg3 = PCRNetConfig(**{**SMALL_PCR, "encoder": "3dmfv", "out_features": 32})
    p3 = init_pcrnet(cfg3, torch.Generator().manual_seed(0), "cpu")
    ep3 = serving.export_registration(p3, cfg3, batch=None, device="cpu")
    for n in (1, 2):
        T3, a3 = _call(ep3, tpl[:n], src[:n])
        with torch.no_grad():
            want_a, want_T, _ = pcrnet_refine(p3, cfg3, torch.as_tensor(src[:n]),
                                              torch.as_tensor(tpl[:n]),
                                              iterations=cfg3.eval_iterations,
                                              stop_gradient_iters=False)
        np.testing.assert_array_equal(T3, invert_transform(want_T).numpy())
        np.testing.assert_array_equal(a3, want_a.numpy())
    with pytest.raises(ValueError, match="early_exit requires stop_threshold"):
        serving.export_registration(p, PCRNetConfig(**SMALL_PCR), early_exit=True,
                                    device="cpu")


def test_run_serving_cli_registration(policy, tmp_path, capsys):
    """run_serving on .ply clouds (resampled from 48 to 32 points, padded to
    the static batch 2, cut back to 1) gives JAX's run_serving outputs on
    JAX's artifact; then the synthetic pair with --bench."""
    jp, _, p, _, _ = policy
    art = str(tmp_path / "policy.pt2")
    serving.save_exported(_export_reg(p), art)
    jart = str(tmp_path / "policy.jax")
    jserving.save_exported(jserving.export_registration(jp, JaxPCRNetConfig(**SMALL_PCR),
                                                        batch=2), jart)
    rng = np.random.default_rng(5)
    tpl_p, src_p = str(tmp_path / "t.ply"), str(tmp_path / "s.ply")
    write_ply(tpl_p, rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32))
    write_ply(src_p, rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32))
    out_json, out_ply = str(tmp_path / "res.json"), str(tmp_path / "aligned.ply")
    run_main(["--artifact", art, "--template", tpl_p, "--source", src_p, "--resample",
              "--out_json", out_json, "--out_aligned", out_ply, "--device", "cpu"])
    res = json.load(open(out_json))
    assert res["batch"] == 1 and res["num_point"] == 32 and res["device"] == "cpu"
    assert np.asarray(res["T_pred"]).shape == (1, 4, 4)
    assert np.asarray(res["euler_deg"]).shape == (1, 3)
    assert read_ply(out_ply).shape == (32, 3)
    brief = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "T_pred" not in brief and brief["num_point"] == 32
    jax_json = str(tmp_path / "jax.json")
    jax_run_main(["--artifact", jart, "--template", tpl_p, "--source", src_p, "--resample",
                  "--out_json", jax_json])
    want = json.load(open(jax_json))
    for key in ("T_pred", "translation"):
        _close_T(np.asarray(res[key]), want[key])
    np.testing.assert_allclose(res["euler_deg"], want["euler_deg"], rtol=0, atol=1e-3)
    capsys.readouterr()

    run_main(["--artifact", art, "--synthetic", "chair", "--bench", "2", "--device", "cpu"])
    brief = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert brief["batch"] == 2 and brief["bench_ms_per_call"] > 0
