"""The AUE and compare_losses CLIs on the CPU, end to end on gen_data's
synthetic data: train_aue (the pn AUE at 16 points, both opt_types) trains
for 2 epochs, keeps and archives its best checkpoint, resumes from a
checkpoint that dpdist_tpu's train_aue wrote, and its checkpoints restore
through the JAX package; --data_parallel other than the world size (1
without torchrun) raises; compare_losses writes the report it returns.
(The 3dmfv AUE's CLI runs at full width, 512 Gaussians; it runs on the
card, in chip_smoke.py.)"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import main as jax_train_aue
from dpdist_tpu.configs import AUEConfig as JaxAUEConfig
from dpdist_tpu.models import init_aue as jax_init
from dpdist_tpu.train.checkpoint import restore_checkpoint as jax_restore

from dpdist_tpu_torch.cli import compare_losses, gen_data, train_aue
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

NET = "results/ckpt_best"
GEN = ["--families", "chair", "--n_train", "4", "--n_test", "2", "--n_surface", "600",
       "--num_neg_points", "100", "--seed", "3"]
AUE = ["--dpdist_ckpt", NET, "--encoder_aue", "pn", "--num_point", "16", "--batch_size", "2",
       "--category", "chair"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aue_data")
    gen_data.main(GEN + ["--out", str(root), "--device", "cpu"])
    return str(root)


@pytest.mark.parametrize("opt_type", ["ours", "chamfer"])
def test_train_aue_trains_archives_and_restores_in_jax(data_root, tmp_path, opt_type):
    log_dir = str(tmp_path / "run")
    archive = str(tmp_path / "archive" / "aue")
    trainer = train_aue.main(AUE + ["--data_root", data_root, "--log_dir", log_dir,
                                    "--opt_type", opt_type, "--max_epoch_aue", "2",
                                    "--archive_to", archive, "--device", "cpu"])
    assert trainer.global_step == 4                  # 2 epochs of 2 batches of 2
    assert trainer.tcfg.learning_rate == 1e-3        # max(--learning_rate, 1e-3)
    metrics = [json.loads(l) for l in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert len([m for m in metrics if "train_loss" in m]) == 2
    evals = [m for m in metrics if "eval_dpdist" in m]
    assert len(evals) == 1 and np.isfinite(evals[0]["eval_chamfer"])
    meta = json.load(open(archive + ".json"))["metadata"]
    assert meta["opt_type"] == opt_type and np.isfinite(meta["eval_score"])
    jp, js = jax_init(jax.random.PRNGKey(0), JaxAUEConfig(num_point=16, encoder="pn"))
    tree, step, md = jax_restore(os.path.join(log_dir, "aue_ckpt_4"), {"params": jp, "state": js})
    assert step == 4 and md["opt_type"] == opt_type
    got = dict(tree_flatten_with_paths({"params": trainer.params, "state": trainer.state}))
    for path, leaf in tree_flatten_with_paths(jax.device_get(tree)):
        np.testing.assert_array_equal(np.asarray(leaf), got[path].detach().numpy(), err_msg=path)


def test_train_aue_resumes_from_a_jax_checkpoint(data_root, tmp_path):
    jax_dir, log_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train_aue(AUE + ["--data_root", data_root, "--log_dir", jax_dir, "--opt_type", "chamfer",
                         "--max_epoch_aue", "1", "--data_parallel", "1"])
    trainer = train_aue.main(AUE + ["--data_root", data_root, "--log_dir", log_dir,
                                    "--opt_type", "chamfer", "--max_epoch_aue", "2",
                                    "--resume", os.path.join(jax_dir, "aue_ckpt_2"),
                                    "--start_epoch", "1", "--device", "cpu"])
    assert trainer.global_step == 4                  # resumed at 2, one more epoch
    assert os.path.isfile(os.path.join(log_dir, "aue_ckpt_4.npz"))


def test_train_aue_rejects_data_parallel(data_root, tmp_path):
    with pytest.raises(ValueError, match="world size 1"):
        train_aue.main(AUE + ["--data_root", data_root, "--log_dir", str(tmp_path),
                              "--data_parallel", "2", "--device", "cpu"])


def test_compare_losses_writes_its_report(tmp_path):
    out = str(tmp_path / "report.json")
    report = compare_losses.main(["--dpdist_ckpt", NET, "--n_surfaces", "1", "--num_point", "32",
                                  "--kinds", "resample", "translate", "--out", out,
                                  "--device", "cpu"])
    assert json.load(open(out)) == report
    assert set(report) == {"resample", "translate"}
    assert report["translate"]["magnitudes"] == [0.0, 0.02, 0.05, 0.1, 0.2]
    assert all(np.isfinite(report["translate"]["emd"]))


def test_train_epoch_snapshots_and_eval_epoch(data_root, tmp_path):
    """train_epoch steps on the full batches and writes the reconstruction
    snapshot (save_cloud_pair, where matplotlib imports); eval_epoch
    averages the monitor over the test split."""
    from dpdist_tpu_torch.configs import AUEConfig, TrainConfig
    from dpdist_tpu_torch.data.modelnet import SurfacePairDataset
    from dpdist_tpu_torch.train.aue_trainer import AUETrainer
    from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint
    from dpdist_tpu_torch.train.logging import RunLogger

    tr = AUETrainer(AUEConfig(encoder="pn", num_point=16), TrainConfig(batch_size=2),
                    *load_dpdist_checkpoint(NET), opt_type="chamfer", device="cpu",
                    run_dir=str(tmp_path), logger=RunLogger(str(tmp_path), echo=False))
    ds, test_ds = (SurfacePairDataset(data_root, batch_size=2, npoints=32, split=split,
                                      class_choice="chair") for split in ("train", "test"))
    loss = tr.train_epoch(ds, 0, snapshot_every=1)
    assert np.isfinite(loss) and tr.global_step == 2
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    assert os.path.isfile(tmp_path / "rec_epoch0.png") == (matplotlib is not None)
    dp, ch = tr.eval_epoch(test_ds, 0)
    assert np.isfinite(dp) and np.isfinite(ch)
