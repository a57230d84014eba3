"""The port's registration data and evaluator (dpdist_tpu_torch/data/
registration.py, eval/registration.py) against dpdist_tpu's, on the CPU.

    PYTHONPATH=. python tests/test_torch_registration.py --write-golden

writes dpdist_tpu_torch/assets/golden_registration.json from the JAX
package on the CPU (a few minutes): the production protocol's report on
all 5,070 poses; the per-case final errors of the first 256 cases at 8
and at 50 iterations; the loss and gradient norm of one seeded
production-recipe train step, from scratch and resumed from the committed
policy. chip_smoke.py holds the card against it.

The production protocol (scripts/chain_r5e.sh's MF arguments with the
period0 stop): the committed policy, 5 families, 125 templates, the
sparse split, no centroid subtraction, seed 777, the committed 5,070
poses, 50 iterations, stop threshold 1e-3, period 2, period0, batches of
64 (the evaluator's default; the dataset's draws depend on it).

Per case, the port and JAX agree to float32 rounding at each step
(rotation errors near 0 deg move by ~0.02 deg per ulp of the cosine);
over many iterations a case near a decision can part
(scripts/torch_registration_spread.py measured on the CPU, all 5,070
cases: at 8 iterations 14 cases part by more than 0.01 deg, 4 by more
than 0.1, 1 by 1.10 deg, translation by at most 1.3e-4; at 50 iterations
with the stop, 21 cases change an accuracy bucket). Hence the per-case
tolerances below.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.data import registration as jreg
from dpdist_tpu.eval import registration as jeval
from dpdist_tpu.models import init_pcrnet as jax_init
from dpdist_tpu.train.checkpoint import restore_params_maybe_state as jax_restore

from dpdist_tpu_torch.cli.common import load_pcrnet_checkpoint
from dpdist_tpu_torch.data import registration as treg
from dpdist_tpu_torch.eval import registration as teval
from dpdist_tpu_torch.nn.layers import params_to_device

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_PATH = ROOT / "dpdist_tpu_torch" / "assets" / "golden_registration.json"
POLICY = str(ROOT / "results" / "policy_mf_tsn1200clip_dpdist_final")
# The archived TPU run of this protocol evaluated the recipe's best
# checkpoint (results/policy_mf_tsn1200clip_dpdist), not its final one; the
# golden file holds its buckets and JAX's on the CPU for that checkpoint,
# for information.
ARCHIVED_REPORT = ROOT / "results" / "postfix_r5" / "px50stop_mf_tsn1200clip_dpdist_clean.json"
BEST_POLICY = str(ROOT / "results" / "policy_mf_tsn1200clip_dpdist")
DPDIST_NET = str(ROOT / "results" / "dpdist_multi_r4_ckpt_best")
FAMILIES = ("chair", "sphere", "box", "cylinder", "torus")
MF = dict(n_templates=125, families=FAMILIES, sparse=1, s_rand_points=1.0, centroid_sub=False,
          seed=777)
STOP = dict(stop_threshold=1e-3, stop_period=2, stop_select="period0")
EVAL_CASES, EVAL_ITERATIONS, BATCH = 5070, 50, 64
PER_CASE, PER_CASE_ITERATIONS = 256, (8, 50)
# The production recipe's first step (scripts/chain_r5e.sh's MF1200): B =
# 16, train_single over 8 loops, grad_clip 1.0, noise_prob 1.0, the dpdist
# loss on the committed multi-family net; dataset seed 0.
RECIPE = dict(n_templates=125, families=FAMILIES, sparse=1, s_rand_points=1.0,
              centroid_sub=False, seed=0, max_rotate_deg=45.0)
RECIPE_BATCH = 16
# Per case at 8 iterations (the port's CPU against JAX's): rotation within
# TOL_ROT and translation within TOL_TRANS on all but OUTLIERS of the
# cases, and within TOL_ROT_FEW / TOL_TRANS_FEW on every case.
TOL_ROT, TOL_TRANS, OUTLIERS = 0.05, 1e-5, 0.01
TOL_ROT_FEW, TOL_TRANS_FEW = 2.0, 1e-3


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


def _cases(n):
    """The first n production cases, in the protocol's batches."""
    ds = treg.RegistrationDataset(pose_file=treg.default_eval_poses(), num_point=64, **MF)
    done, out = 0, []
    while done < n:
        b = min(BATCH, n - done)
        out.append(ds.sample_batch(b))
        done += b
    return out


@functools.lru_cache(maxsize=None)
def _jax_policy(path=POLICY):
    with open(path + ".json") as f:
        jcfg = JaxPCRNetConfig.from_json(json.load(f)["metadata"]["pcrnet_config"])
    tp, ts = jax_init(jax.random.PRNGKey(0), jcfg)
    params, state, _ = jax_restore(path, tp, ts)
    return jcfg, params, state


_jax_program = jax.jit(jeval._eval_program, static_argnames=(
    "cfg", "iterations", "stop_threshold", "stop_period", "stop_select"))


def jax_per_case(n, iterations):
    """JAX's final (rot, trans) errors of the first n production cases."""
    jcfg, params, state = _jax_policy()
    rot, trans = [], []
    for tmpl, src, gt in _cases(n):
        _, te, re, *_ = _jax_program(params, state, jcfg, jnp.asarray(tmpl), jnp.asarray(src),
                                     jnp.asarray(gt), iterations=iterations, **STOP)
        rot.append(np.asarray(re)[-1])
        trans.append(np.asarray(te)[-1])
    return np.concatenate(rot), np.concatenate(trans)


def port_per_case(n, iterations):
    cfg, params = load_pcrnet_checkpoint(POLICY)
    params = params_to_device(params, "cpu")
    rot, trans = [], []
    for tmpl, src, gt in _cases(n):
        _, te, re, *_ = teval._eval_program(params, cfg,
                                            *(torch.as_tensor(a) for a in (tmpl, src, gt)),
                                            iterations, **STOP)
        rot.append(re[-1].numpy())
        trans.append(te[-1].numpy())
    return np.concatenate(rot), np.concatenate(trans)


def check_per_case(rot, trans, want_rot, want_trans):
    """The per-case criterion above; returns (worst rot, worst trans, share
    outside TOL_ROT / TOL_TRANS)."""
    d_rot, d_trans = np.abs(rot - want_rot), np.abs(trans - want_trans)
    outside = float(np.mean((d_rot > TOL_ROT) | (d_trans > TOL_TRANS)))
    assert d_rot.max() <= TOL_ROT_FEW and d_trans.max() <= TOL_TRANS_FEW, (d_rot.max(),
                                                                           d_trans.max())
    assert outside <= OUTLIERS, outside
    return float(d_rot.max()), float(d_trans.max()), outside


# ---------------------------------------------------------------- data


def test_pose_csv_copy_is_byte_identical():
    """The port reads its own copy, byte for byte the reference's."""
    assert Path(treg.default_eval_poses()).parent == ROOT / "dpdist_tpu_torch" / "assets"
    assert (Path(treg.default_eval_poses()).read_bytes()
            == Path(jreg.default_eval_poses()).read_bytes())


@pytest.mark.parametrize("kw,batch_kw", [
    (dict(pose_file="default", num_point=64, **MF), {}),
    (dict(pose_file="default", num_point=64, **MF), dict(noise_prob=1.0,
                                                         occlusion_fraction=0.25)),
    (dict(num_point=32, n_templates=6, families=("chair", "box", "cone"), seed=3),
     dict(random_points_prob=0.5, noise_prob=0.5, occlusion_fraction=0.3)),
    (dict(num_point=32, n_templates=4, sparse=2, s_rand_points=0.5, seed=4), dict(noise_prob=0.5)),
    (dict(num_point=32, n_templates=4, sparse=1, s_rand_points=0.0, centroid_sub=True, seed=5),
     {}),
], ids=["MF", "MF_noise_occlusion", "random_poses", "sparse2", "sparse1_first_points"])
def test_dataset_batches_equal_jax(kw, batch_kw):
    """Byte for byte, over several batches that draw from one generator,
    with return_info's template indices and families."""
    if kw.get("pose_file") == "default":
        kw = {**kw, "pose_file": jreg.default_eval_poses()}
        tkw = {**kw, "pose_file": treg.default_eval_poses()}
    else:
        tkw = kw
    jds, tds = jreg.RegistrationDataset(**kw), treg.RegistrationDataset(**tkw)
    np.testing.assert_array_equal(tds.templates, jds.templates)
    for b in (5, 64, 3):
        want = jds.sample_batch(b, return_info=True, **batch_kw)
        got = tds.sample_batch(b, return_info=True, **batch_kw)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[3]["template_idx"], want[3]["template_idx"])
        assert got[3]["family"] == want[3]["family"]


def test_perturbed_dataset_and_h5_templates_equal_jax(tmp_path):
    from dpdist_tpu.data.io import write_templates_h5

    templates = np.random.default_rng(6).uniform(-0.8, 0.8, (5, 96, 3)).astype(np.float32)
    h5 = str(tmp_path / "templates.h5")
    write_templates_h5(h5, templates)
    jds = jreg.PerturbedRegistrationDataset(jreg.RegistrationDataset(
        h5_path=h5, num_point=48, seed=8), noise=True, occlusion_fraction=0.25)
    tds = treg.PerturbedRegistrationDataset(treg.RegistrationDataset(
        h5_path=h5, num_point=48, seed=8), noise=True, occlusion_fraction=0.25)
    for _ in range(3):
        for g, w in zip(tds.sample_batch(4), jds.sample_batch(4)):
            np.testing.assert_array_equal(g, w)


def test_generate_poses_and_apply_pose6_equal_jax():
    for gaussian in (False, True):
        want = jreg.generate_poses(50, max_rotate_deg=30.0, t_clip=0.05, gaussian=gaussian,
                                   rng=np.random.default_rng(9))
        got = treg.generate_poses(50, max_rotate_deg=30.0, t_clip=0.05, gaussian=gaussian,
                                  rng=np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)
    pts = np.random.default_rng(10).uniform(-1, 1, (50, 20, 3)).astype(np.float32)
    np.testing.assert_array_equal(treg.apply_pose6_np(pts, want), jreg.apply_pose6_np(pts, want))


# ---------------------------------------------------------------- stop protocols


def _pose_sequence(seed, iterations=12, B=6, flip_cycle=False):
    """(iterations, B, 7) poses shrinking towards the identity, the last two
    cases fixed at the identity from iteration 3; with flip_cycle, cases 0
    and 1 alternate a 180-degree flip about z with its inverse (a period-2
    cycle whose period-1 measure stays ~8)."""
    r = np.random.default_rng(seed)
    scale = 0.3 * 0.5 ** np.arange(iterations)[:, None, None]
    t = r.normal(size=(iterations, B, 3)) * scale * 0.1
    q = np.concatenate([np.ones((iterations, B, 1)), r.normal(size=(iterations, B, 3)) * scale],
                       -1)
    poses = np.concatenate([t, q], -1).astype(np.float32)
    poses[3:, -2:] = np.float32([0, 0, 0, 1, 0, 0, 0])
    if flip_cycle:
        flip = np.float32([0.001, 0, 0, 1e-4, 0, 0, 1])   # ~180 degrees about z
        poses[:, :2] = flip
        poses[1::2, :2, 3:] *= np.float32([1, 1, 1, -1])
    return poses


@functools.partial(jax.jit, static_argnames=("stop_threshold", "stop_period", "stop_select"))
def _jax_accumulate(poses, source, template, stop_threshold, stop_period, stop_select):
    return jeval.accumulate_with_stopping(poses, source, template,
                                          stop_threshold=stop_threshold,
                                          stop_period=stop_period, stop_select=stop_select)


@pytest.mark.parametrize("flip_cycle", [False, True], ids=["shrinking", "flip_cycle"])
@pytest.mark.parametrize("stop_period", [1, 2, 3])
@pytest.mark.parametrize("stop_select", ["last", "chamfer", "period0"])
def test_accumulate_with_stopping_matches_jax(stop_select, stop_period, flip_cycle):
    poses = _pose_sequence(11, flip_cycle=flip_cycle)
    r = np.random.default_rng(12)
    tmpl = r.uniform(-0.5, 0.5, (poses.shape[1], 24, 3)).astype(np.float32)
    src = (tmpl + r.normal(0, 0.02, tmpl.shape)).astype(np.float32)
    for thr in (None, 1e-3):
        want = _jax_accumulate(poses, src, tmpl, thr, stop_period, stop_select)
        got = teval.accumulate_with_stopping(torch.tensor(poses), torch.tensor(src),
                                             torch.tensor(tmpl), stop_threshold=thr,
                                             stop_period=stop_period, stop_select=stop_select)
        for name, g, w in zip(("T_final", "T_curve", "ce"), got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        if thr is not None and flip_cycle and stop_period == 2:
            assert bool(got[3][:2].all()), "the period-2 check must catch the flip cycle"


def test_stop_period_must_be_positive():
    with pytest.raises(ValueError, match="stop_period"):
        teval.init_stop_carry(torch.float32, 2, 0, torch.zeros(2, 4, 3), torch.zeros(2, 4, 3),
                              "last")


# ---------------------------------------------------------------- evaluator


def _report_close(got, want, tol_deg=0.01):
    """Accuracy buckets and counts equal; mean errors close."""
    for k, w in want.items():
        if k.startswith(("time", "curve")):
            continue
        g = got[k]
        if isinstance(w, dict):
            _report_close(g, w, tol_deg)
        elif k.startswith(("acc", "sym_acc", "num", "iter", "stop", "converge")):
            assert g == pytest.approx(w, abs=1e-9) if isinstance(w, float) else g == w, k
        elif "rot" in k:
            assert g == pytest.approx(w, abs=tol_deg, rel=1e-4), k
        else:
            assert g == pytest.approx(w, abs=1e-6, rel=1e-4), k


@pytest.mark.parametrize("stop", [STOP, {}], ids=["period0", "no_stop"])
def test_evaluate_registration_report_matches_jax(stop, tmp_path):
    """The production policy on the first 16 production cases, 10
    iterations, in batches of 6 (a ragged tail of 4, which JAX pads and the
    port runs as it is): the report's buckets overall and per family equal
    JAX's, mean errors within 0.01 deg / 1e-6, and the report files
    written."""
    jcfg, jparams, jstate = _jax_policy()
    cfg, params = load_pcrnet_checkpoint(POLICY)
    kw = dict(num_cases=16, iterations=10, batch_size=6, **stop)
    want = jeval.evaluate_registration(
        jparams, jcfg, jreg.RegistrationDataset(pose_file=jreg.default_eval_poses(),
                                                num_point=64, **MF), state=jstate, **kw)
    got = teval.evaluate_registration(
        params, cfg, treg.RegistrationDataset(pose_file=treg.default_eval_poses(), num_point=64,
                                              **MF),
        report_dir=str(tmp_path), device="cpu", **kw)
    assert set(got) == set(want)
    _report_close(got, want)
    np.testing.assert_allclose(got["curve_rot_err_mean"], want["curve_rot_err_mean"],
                               atol=0.01)
    for name in ("registration_report.json", "per_case_errors.csv", "iteration_curves.csv",
                 "log_data.h5"):
        assert (tmp_path / name).is_file(), name


def test_golden_per_case_at_8_iterations_holds():
    """JAX recomputes the golden file's first 256 cases at 8 iterations (so
    the file cannot drift), and the port's CPU path stays within the
    per-case tolerance of them."""
    golden = json.loads(GOLDEN_PATH.read_text())
    g8 = golden["per_case"]["8"]
    rot, trans = jax_per_case(PER_CASE, 8)
    np.testing.assert_allclose(rot, g8["rot"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(trans, g8["trans"], rtol=0, atol=1e-8)
    check_per_case(*port_per_case(PER_CASE, 8), np.asarray(g8["rot"]), np.asarray(g8["trans"]))


# ---------------------------------------------------------------- golden


def recipe_batch():
    """The production recipe's first train batch (template, source, pose6)."""
    ds = treg.RegistrationDataset(num_point=64, **RECIPE)
    return ds.sample_batch(RECIPE_BATCH, random_points_prob=1.0, noise_prob=1.0)


def _buckets(report):
    """The accuracy buckets overall and per family, and converged_frac."""
    def acc(r):
        return {k: v for k, v in r.items() if k.startswith("acc_")}

    return {"all": {**acc(report), "converged_frac": report["converged_frac"]},
            **{f: acc(r) for f, r in report["per_family"].items()}}


def jax_protocol_report(path=POLICY):
    jcfg, params, state = _jax_policy(path)
    ds = jreg.RegistrationDataset(pose_file=jreg.default_eval_poses(), num_point=64, **MF)
    report = jeval.evaluate_registration(params, jcfg, ds, num_cases=EVAL_CASES,
                                         iterations=EVAL_ITERATIONS, batch_size=BATCH,
                                         state=state, **STOP)
    return {k: v for k, v in report.items() if not k.startswith("time")}


def compute_golden() -> dict:
    import tempfile

    from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint
    from dpdist_tpu.configs import TrainConfig
    from dpdist_tpu.parallel import make_mesh
    from dpdist_tpu.train.pcrnet_trainer import PCRNetTrainer

    jcfg = _jax_policy()[0]
    report = jax_protocol_report()
    per_case = {}
    for it in PER_CASE_ITERATIONS:
        rot, trans = jax_per_case(PER_CASE, it)
        per_case[str(it)] = {"rot": rot.tolist(), "trans": trans.tolist()}

    template, source, pose6 = recipe_batch()
    steps = {}
    for name in ("scratch", "resumed"):
        with tempfile.TemporaryDirectory() as tmp:
            trainer = PCRNetTrainer(jcfg, TrainConfig(batch_size=RECIPE_BATCH, grad_clip=1.0),
                                    loss_type="dpdist",
                                    dpdist=load_dpdist_checkpoint(DPDIST_NET),
                                    train_single=True, run_dir=tmp, mesh=make_mesh(data=1))
            if name == "resumed":
                trainer.restore(POLICY)
            m = trainer.train_step(template, source, pose6)
            steps[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    return {
        "policy": "results/policy_mf_tsn1200clip_dpdist_final",
        "dpdist_net": "results/dpdist_multi_r4_ckpt_best",
        "protocol": {"dataset": {k: list(v) if isinstance(v, tuple) else v
                                 for k, v in MF.items()},
                     "pose_file": "dpdist_tpu_torch/assets/eval_poses_45deg_5070.csv",
                     "num_cases": EVAL_CASES, "iterations": EVAL_ITERATIONS,
                     "batch_size": BATCH, **STOP},
        "report": report,
        "per_case": per_case,
        "archived": {
            "note": "the archived TPU run of this protocol evaluated the best checkpoint, not "
                    "the final one; information only",
            "checkpoint": "results/policy_mf_tsn1200clip_dpdist",
            "tpu_report": str(ARCHIVED_REPORT.relative_to(ROOT)),
            "tpu_buckets": _buckets(json.loads(ARCHIVED_REPORT.read_text())),
            "jax_cpu_buckets": _buckets(jax_protocol_report(BEST_POLICY)),
        },
        "train_step": {"recipe": {"dataset": {k: list(v) if isinstance(v, tuple) else v
                                              for k, v in RECIPE.items()},
                                  "batch_size": RECIPE_BATCH, "train_single": True,
                                  "max_loops": 8, "grad_clip": 1.0, "noise_prob": 1.0,
                                  "random_points_prob": 1.0, "loss_type": "dpdist",
                                  "init": "jax.random.PRNGKey(0)"},
                       **steps},
    }


if __name__ == "__main__":
    if "--write-golden" not in sys.argv:
        sys.exit("usage: PYTHONPATH=. python tests/test_torch_registration.py --write-golden")
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    with open(GOLDEN_PATH, "w") as f:
        json.dump(compute_golden(), f, indent=1)
        f.write("\n")
    print("wrote", GOLDEN_PATH)


def test_golden_train_step_holds(tmp_path):
    """The port's CPU path on the golden production-recipe step: the loss
    within 1e-5 (relative) of JAX's, from scratch (JAX's initial weights
    carried over) and resumed from the committed policy. The gradient norm
    within 3e-2: full BPTT through the frozen DPDist loss is ill-conditioned
    at these weights (scripts/torch_registration_spread.py --train: noise of
    1e-6 on the source moves the port's own resumed gradient by 1.4 %; the
    two packages' resumed gradients part by up to 2.8 % in a leaf, their
    norms by 0.63 %), where the last-iteration gradient and chamfer's BPTT
    one agree to 1.3e-4 and 1.6e-5."""
    from dpdist_tpu_torch.configs import TrainConfig
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

    golden = json.loads(GOLDEN_PATH.read_text())["train_step"]
    cfg = load_pcrnet_checkpoint(POLICY)[0]
    template, source, pose6 = recipe_batch()
    for name in ("scratch", "resumed"):
        trainer = PCRNetTrainer(cfg, TrainConfig(batch_size=RECIPE_BATCH, grad_clip=1.0),
                                loss_type="dpdist", dpdist=load_dpdist_checkpoint(DPDIST_NET),
                                train_single=True, run_dir=str(tmp_path), device="cpu",
                                logger=RunLogger(str(tmp_path), echo=False))
        if name == "resumed":
            trainer.restore(POLICY)
        else:
            jparams, _ = jax_init(jax.random.PRNGKey(0), _jax_policy()[0])
            trainer.params = params_to_device(jax.device_get(jparams), "cpu",
                                              requires_grad=True)
        m = trainer.train_step(template, source, pose6)
        assert float(m["loss"]) == pytest.approx(golden[name]["loss"], rel=1e-5), name
        assert float(m["grad_norm"]) == pytest.approx(golden[name]["grad_norm"], rel=3e-2), name
