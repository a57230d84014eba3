"""The port's registration CLIs in-process on the CPU at tiny sizes:
make_templates (its files against the reference CLI's), train_pcrnet (the
frozen DPDist loss, full BPTT, best-checkpoint selection on a family,
--archive_to, --resume), eval_registration on the trained checkpoint
against the reference CLI's report, and eval_matrix."""

import json

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.cli import eval_matrix, eval_registration, make_templates, train_pcrnet

TINY = ["--num_point", "32", "--out_features", "32", "--max_loops", "2", "--batch_size", "2",
        "--families", "chair", "box", "--n_templates", "4", "--device", "cpu"]


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


def test_make_templates_writes_the_reference_files(tmp_path):
    import h5py

    from dpdist_tpu.cli import make_templates as jax_make_templates

    args = ["--families", "chair", "torus", "--n_templates", "3", "--num_point", "64",
            "--num_poses", "20", "--seed", "4"]
    jax_make_templates.main(args + ["--out_dir", str(tmp_path / "jax")])
    make_templates.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "templates_eval.h5" in names and "itr_net_train_data45.csv" in names
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert list(fa) == list(fb) == ["templates"]
                np.testing.assert_array_equal(fa["templates"][()], fb["templates"][()])
                assert fa["templates"].dtype == fb["templates"].dtype
        else:
            assert a.read_bytes() == b.read_bytes(), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_pcrnet for 10 epochs of one batch on the frozen DPDist loss
    (committed canonical net), evaluated at epoch 10 on chair, archived."""
    d = tmp_path_factory.mktemp("pcrnet")
    args = TINY + ["--loss_type", "dpdist", "--dpdist_ckpt", "results/ckpt_best",
                   "--max_epoch", "10", "--batches_per_epoch", "1", "--eval_cases", "4",
                   "--select_family", "chair", "--train_single", "--grad_clip", "1.0",
                   "--noise_prob", "1.0", "--archive_to", str(d / "archive" / "policy")]
    trainer = train_pcrnet.main(args + ["--log_dir", str(d / "run")])
    return d, args, trainer


def test_train_pcrnet_cli(trained):
    d, args, trainer = trained
    assert trainer.global_step == 10
    for name in ("pcrnet_ckpt_best", "pcrnet_ckpt_final"):
        assert (d / "run" / f"{name}.npz").is_file(), name
    meta = json.loads((d / "archive" / "policy.json").read_text())["metadata"]
    assert meta["select_family"] == "chair" and meta["loss_type"] == "dpdist"
    assert np.isfinite(meta["select_err"])
    lines = [json.loads(x) for x in (d / "run" / "metrics.jsonl").read_text().splitlines()]
    assert len([x for x in lines if "train_loss" in x]) == 10
    assert all(np.isfinite(x["train_loss"]) for x in lines if "train_loss" in x)
    # --resume continues from a checkpoint: the step count carries on.
    resumed = train_pcrnet.main(
        [a if a != "10" else "1" for a in args]
        + ["--log_dir", str(d / "resumed"), "--resume", str(d / "run" / "pcrnet_ckpt_final")])
    assert resumed.global_step == 11


def test_eval_registration_cli_matches_the_reference(trained, tmp_path, capsys):
    from dpdist_tpu.cli import eval_registration as jax_eval_registration

    d, _, _ = trained
    args = ["--ckpt", str(d / "run" / "pcrnet_ckpt_final"), "--pose_file", "default",
            "--num_cases", "8", "--iterations", "3", "--families", "chair", "box",
            "--n_templates", "4", "--stop_threshold", "1e-3", "--stop_period", "2",
            "--stop_select", "period0"]
    jax_eval_registration.main(args + ["--report_dir", str(tmp_path / "jax")])
    want = json.loads((tmp_path / "jax" / "registration_report.json").read_text())
    capsys.readouterr()
    got = eval_registration.main(args + ["--report_dir", str(tmp_path / "port"),
                                         "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == {k: v for k, v in got.items() if not k.startswith("curve_")}
    for key in ("num_cases", "iterations", "acc_rot2.5_trans0.05", "acc_rot5.0_trans0.05",
                "acc_rot10.0_trans0.1", "acc_rot20.0_trans0.2", "converged_frac"):
        assert got[key] == want[key], key
    assert got["rot_err_mean_deg"] == pytest.approx(want["rot_err_mean_deg"], abs=0.01)
    assert got["per_family"].keys() == want["per_family"].keys() == {"chair", "box"}
    assert json.loads((tmp_path / "port" / "registration_report.json").read_text())[
        "num_cases"] == 8


def test_eval_matrix_cli(trained, tmp_path, capsys):
    d, _, _ = trained
    ck = str(d / "run" / "pcrnet_ckpt_final")
    args = ["--ckpts", f"a={ck}", f"b={ck}", "--conditions", "clean", "noise",
            "--num_cases", "6", "--iterations", "2", "--families", "chair", "box",
            "--n_templates", "4", "--out_dir", str(tmp_path), "--device", "cpu"]
    reports = eval_matrix.main(args)
    assert set(reports) == {"a_clean", "a_noise", "b_clean", "b_noise"}

    def untimed(r):
        return {k: v for k, v in r.items() if not k.startswith("time")}

    assert untimed(reports["a_clean"]) == untimed(reports["b_clean"])
    assert untimed(reports["a_noise"]) != untimed(reports["a_clean"])
    rows = (tmp_path / "summary.txt").read_text().splitlines()
    assert len(rows) == 4 * 3   # all + 2 families per cell
    capsys.readouterr()
    eval_matrix.main(args + ["--skip_existing"])
    assert capsys.readouterr().out.count("(cached)") == 12


def test_data_parallel_raises(tmp_path):
    with pytest.raises(ValueError, match="world size 1"):
        train_pcrnet.main(TINY + ["--loss_type", "chamfer", "--data_parallel", "2",
                                  "--log_dir", str(tmp_path)])
