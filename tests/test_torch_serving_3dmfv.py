"""The serving export of a 3dmfv registration policy
(dpdist_tpu_torch/serving.py:export_registration with encoder="3dmfv", and
the export_serving and run_serving CLIs on such a checkpoint) against
dpdist_tpu.serving's jax.export programs on the same JAX-initialised
weights and BN state, carried across by params_from_jax, and the same
inputs made with numpy, at the small 3dmfv config of
tests/test_torch_pcrnet_3dmfv.py (the reference's 8^3 grid and sigma 0.25,
out_features 32, 3 iterations).

Each form is exported once (FORMS): portable under the stop protocol
(stop_select "last" with early exit, "chamfer" fixed-length) and without a
BN state with a symbolic batch; native (the kernels as dpdist:: ops; on the
CPU their plain versions run) at 32 points, fixed-length, where the encode
is plain, and at 160 under "period0" with early exit and a symbolic batch,
where row 7's op encodes the hoisted template and, inside the loop, the
source. Symbolic batches are served at B = 1 and 3. T_pred and the
aligned cloud within 1e-5 of JAX's, the eval-mode bound of
tests/test_torch_pcrnet_3dmfv.py (without a state see TOL_BATCH_STATS);
every program equal bit for bit to the port's eager fixed-length
refinement and stop, so early exit returns what the fixed-length loop
does. Also: the Gaussian centres built by torch ops (so
they trace inside the loop) equal to the numpy construction's bit for bit;
the export_serving -> run_serving CLIs on a 3dmfv checkpoint.
"""

import json

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu import serving as jserving
from dpdist_tpu.cli.export_serving import main as jax_export_main
from dpdist_tpu.cli.run_serving import main as jax_run_main
from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.models import pcrnet as jpcr
from dpdist_tpu.ops.threedmfv import threedmfv_grid as jax_threedmfv_grid

from dpdist_tpu_torch import serving
from dpdist_tpu_torch.cli.export_serving import main as export_main
from dpdist_tpu_torch.cli.run_serving import main as run_main
from dpdist_tpu_torch.configs import PCRNetConfig
from dpdist_tpu_torch.data.io import write_ply
from dpdist_tpu_torch.eval.registration import accumulate_with_stopping
from dpdist_tpu_torch.geometry.se3 import apply_transform, invert_transform
from dpdist_tpu_torch.models.pcrnet import pcrnet_refine
from dpdist_tpu_torch.ops.threedmfv import threedmfv_centers
from dpdist_tpu_torch.train import params_from_jax
from dpdist_tpu_torch.train.checkpoint import save_checkpoint

SMALL = dict(num_point=32, encoder="3dmfv", out_features=32, head_widths=(32, 16),
             eval_iterations=3)
TOL = 1e-5
# Without a BN state the encoder normalises with the statistics of the
# 2B-cloud batch, and the refinement is ill-conditioned: 1e-6 of input
# noise moved JAX's own program by 1.4e-4 after one iteration and 1.7e-2
# after three (the port parted from JAX by 1.2e-5 and 6.9e-4). That form
# is held against JAX over one iteration, by tests/test_torch_pcrnet_3dmfv.py's
# bound for batch statistics, and against the eager refinement bit for bit;
# over three iterations, against the eager refinement bit for bit, by
# tests/test_torch_serving_registration.py::test_export_registration_stop_protocol.
TOL_BATCH_STATS = 1e-4
INF = float("inf")
# name -> (export arguments of both packages, the port's only: portable,
# with the BN state). Thresholds inf freeze a case at its first check:
# early exit then returns after one trip (period 1) or two (period 2).
FORMS = {
    "last_early": ({"stop_threshold": INF, "early_exit": True}, {}),
    "chamfer": ({"stop_threshold": INF, "stop_period": 2, "stop_select": "chamfer"}, {}),
    "no_state": ({"iterations": 1, "batch": None}, {"with_state": False}),
    "native": ({}, {"portable": False}),
    "native_np160_symbolic": ({"num_point": 160, "batch": None, "stop_threshold": INF,
                               "stop_period": 2, "stop_select": "period0", "early_exit": True},
                              {"portable": False}),
}
STOP_KEYS = ("stop_threshold", "stop_period", "stop_select")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: many small eager ops on a CPU shared by xdist
    workers stall at the thread pool's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def policy():
    """(JAX params, JAX state, port params, port state, clouds) of a small
    3dmfv policy; the running statistics moved off (0, 1) so that eval
    mode's normalisation counts; clouds {num_point: (template, source)},
    (3, N, 3) each."""
    jp, js = jpcr.init_pcrnet(jax.random.PRNGKey(1), JaxPCRNetConfig(**SMALL))
    r = np.random.default_rng(1)
    js = {"mfv_bn": [{k: {"mean": r.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                          "var": r.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
                      for k, v in blk.items()} for blk in js["mfv_bn"]]}
    jp = jax.device_get(jp)
    rng = np.random.default_rng(3)
    clouds = {n: tuple(rng.uniform(-0.6, 0.6, (3, n, 3)).astype(np.float32) for _ in range(2))
              for n in (32, 160)}
    return (jp, js, params_from_jax(jp, "cpu", model="pcrnet"),
            params_from_jax(js, "cpu", model="pcrnet"), clouds)


_PROGRAMS = {}


def _programs(policy, form):
    """(the port's program, JAX's exported function) of a form, once per
    module."""
    if form not in _PROGRAMS:
        jp, js, p, s, _ = policy
        kw, port = FORMS[form]
        kw = {"batch": 2, **kw}
        state = (s, js) if port.get("with_state", True) else (None, None)
        num_point = kw.get("num_point", SMALL["num_point"])
        ep = serving.export_registration(p, PCRNetConfig(**{**SMALL, "num_point": num_point}),
                                         state=state[0], portable=port.get("portable", True),
                                         device="cpu", **kw)
        jax_ep = jserving.export_registration(
            jp, JaxPCRNetConfig(**{**SMALL, "num_point": num_point}), state=state[1],
            portable=port.get("portable", True), **kw)
        _PROGRAMS[form] = (ep, jax_ep)
    return _PROGRAMS[form]


def _eager(p, s, cfg, tpl, src, iterations, **stop):
    """The port's eager fixed-length refinement with the stop applied:
    (T_pred, aligned), as the programs return them."""
    with torch.no_grad():
        aligned, T, poses = pcrnet_refine(p, cfg, src, tpl, iterations=iterations,
                                          stop_gradient_iters=False, state=s)
        if stop.get("stop_threshold") is not None:
            T = accumulate_with_stopping(poses, src, tpl, **stop)[0]
            aligned = apply_transform(src, T)
    return invert_transform(T), aligned


def _op_targets(ep):
    """The dpdist:: ops the program calls, in its graph and its loop's."""
    return [str(n.target) for gm in ep.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function" and "dpdist" in str(n.target)]


@pytest.mark.parametrize("dims", [2, 3])
def test_centres_equal_the_numpy_construction(dims):
    """threedmfv_centers builds the centres in float64 torch ops, as
    np.linspace forms them, and rounds them once: equal bit for bit to the
    reference's numpy grid for g = 1..16."""
    for g in range(1, 17):
        got = threedmfv_centers(g ** dims, dims)
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.from_numpy(jax_threedmfv_grid(g ** dims, dims))), g


@pytest.mark.parametrize("form", list(FORMS))
def test_export_3dmfv_policy_matches_jax(policy, form):
    jp, js, p, s, clouds = policy
    kw, port = FORMS[form]
    num_point = kw.get("num_point", SMALL["num_point"])
    cfg = PCRNetConfig(**{**SMALL, "num_point": num_point})
    state = s if port.get("with_state", True) else None
    ep, jax_ep = _programs(policy, form)
    ops_held = _op_targets(ep)
    if num_point >= 128 and not port.get("portable", True):
        # Row 7's op: the hoisted template's encode and the source's in
        # the loop's body.
        assert ops_held == ["dpdist.threedmfv.default"] * 2
    else:
        assert ops_held == []
    tpl, src = clouds[num_point]
    stop = {k: kw[k] for k in STOP_KEYS if k in kw}
    for n in ((1, 3) if kw.get("batch", 2) is None else (2,)):
        T, aligned = (o.numpy() for o in ep.module()(torch.as_tensor(tpl[:n]),
                                                      torch.as_tensor(src[:n])))
        assert T.shape == (n, 4, 4) and aligned.shape == (n, num_point, 3)
        wT, wa = jax_ep.call(tpl[:n], src[:n])
        tol = TOL if port.get("with_state", True) else TOL_BATCH_STATS
        np.testing.assert_allclose(T, np.asarray(wT), rtol=0, atol=tol)
        np.testing.assert_allclose(aligned, np.asarray(wa), rtol=0, atol=tol)
        eT, ea = _eager(p, state, cfg, torch.as_tensor(tpl[:n]), torch.as_tensor(src[:n]),
                        kw.get("iterations", cfg.eval_iterations), **stop)
        np.testing.assert_array_equal(T, eT.numpy())
        np.testing.assert_array_equal(aligned, ea.numpy())


def test_export_serving_cli_3dmfv_checkpoint(policy, tmp_path, capsys):
    """A 3dmfv checkpoint with its BN state, written by the port's
    save_checkpoint: export_serving --pcrnet_ckpt -> run_serving on .ply
    clouds (resampled from 48 to 32 points) and on the synthetic chair pair
    gives what JAX's export_serving -> run_serving give on the same file."""
    _, _, p, s, _ = policy
    ck = str(tmp_path / "pcrnet_ckpt_best")
    save_checkpoint(ck, {"params": p, "state": s},
                    metadata={"pcrnet_config": PCRNetConfig(**SMALL).to_json()})
    art, jart = str(tmp_path / "policy.pt2"), str(tmp_path / "policy.jax")
    stop = ["--stop_threshold", "1e-3", "--stop_period", "2", "--stop_select", "period0",
            "--early_exit"]
    line = export_main(["--pcrnet_ckpt", ck, "--out", art, "--batch", "2", *stop,
                        "--device", "cpu"])
    assert line["inputs"] == [[2, SMALL["num_point"], 3]] * 2
    jax_export_main(["--pcrnet_ckpt", ck, "--out", jart, "--batch", "2", *stop])
    rng = np.random.default_rng(5)
    tpl_p, src_p = str(tmp_path / "t.ply"), str(tmp_path / "s.ply")
    write_ply(tpl_p, rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32))
    write_ply(src_p, rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32))
    inputs = [["--template", tpl_p, "--source", src_p, "--resample"],
              ["--synthetic", "chair"]]
    for i, args in enumerate(inputs):
        got, want = str(tmp_path / f"port{i}.json"), str(tmp_path / f"jax{i}.json")
        run_main(["--artifact", art, *args, "--out_json", got, "--device", "cpu"])
        jax_run_main(["--artifact", jart, *args, "--out_json", want])
        res, ref = json.load(open(got)), json.load(open(want))
        assert res["num_point"] == SMALL["num_point"] and res["device"] == "cpu"
        assert np.isfinite(np.asarray(res["T_pred"])).all()
        for key in ("T_pred", "translation"):
            np.testing.assert_allclose(np.asarray(res[key]), np.asarray(ref[key]), rtol=0,
                                       atol=TOL)
        np.testing.assert_allclose(res["euler_deg"], ref["euler_deg"], rtol=0, atol=1e-3)
    capsys.readouterr()
