"""The DPDist CLIs on the CPU: gen_data writes the files dpdist_tpu's
gen_data writes for the same flags and seed, train_dpdist trains for 2
epochs in float32 and in bfloat16, resumes, and its checkpoints load in
load_frozen_distance and in the JAX package's restore_checkpoint."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.gen_data import main as jax_gen_data
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.train.checkpoint import restore_checkpoint as jax_restore

from dpdist_tpu_torch.cli import gen_data, train_dpdist
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train import latest_checkpoint
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
from reference_native import _reference_native_so, reference_native  # noqa: F401

GEN = ["--families", "chair", "box", "--n_train", "2", "--n_test", "1", "--n_surface", "1500",
       "--num_neg_points", "200", "--seed", "1"]
TRAIN = ["--num_point", "16", "--embedding_size", "64", "--K", "3", "--mlp", "32", "32", "32",
         "--batch_size", "2", "--eval_every", "1", "--category", "all", "--device", "cpu"]


def _tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    gen_data.main(GEN + ["--out", str(root / "mine"), "--device", "cpu"])
    return root


def test_gen_data_equals_jax(data_root, reference_native):
    jax_gen_data(GEN + ["--out", str(data_root / "ref")])
    mine, ref = _tree(data_root / "mine"), _tree(data_root / "ref")
    assert sorted(mine) == sorted(ref) and mine == ref


def test_gen_data_from_modelnet_equals_jax(tmp_path, reference_native):
    """--from_modelnet on a ModelNet-layout tree of csv point files: the
    same ground-truth files as dpdist_tpu's gen_data, and models that
    already have theirs are skipped."""
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    for name in ("mine", "ref"):
        root = tmp_path / name
        ids = {"train": ["chair_0001", "box_0002"], "test": ["chair_0003"]}
        for split, names in ids.items():
            (root / f"modelnet40_{split}.txt").parent.mkdir(parents=True, exist_ok=True)
            (root / f"modelnet40_{split}.txt").write_text("\n".join(names) + "\n")
            for i, sid in enumerate(names):
                fam = sid.split("_")[0]
                (root / fam).mkdir(exist_ok=True)
                pts = synthetic_surface(fam, seed=10 + i + len(split), n_points=1200)
                np.savetxt(root / fam / f"{sid}.txt", pts, fmt="%.6f", delimiter=",")
    args = ["--num_neg_points", "150", "--seed", "2"]
    gen_data.main(args + ["--from_modelnet", str(tmp_path / "mine"), "--device", "cpu"])
    jax_gen_data(args + ["--from_modelnet", str(tmp_path / "ref")])
    mine, ref = _tree(tmp_path / "mine"), _tree(tmp_path / "ref")
    assert sorted(mine) == sorted(ref) and mine == ref and len(mine) == 2 + 3 * 4
    before = _tree(tmp_path / "mine")
    gen_data.main(args + ["--from_modelnet", str(tmp_path / "mine"), "--device", "cpu",
                          "--seed", "3"])
    assert _tree(tmp_path / "mine") == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_dpdist_trains_resumes_and_serves(data_root, tmp_path, dtype):
    log_dir = str(tmp_path / "run")
    args = TRAIN + ["--data_root", str(data_root / "mine"), "--log_dir", log_dir,
                    "--dtype", dtype, "--max_epoch", "2"]
    trainer = train_dpdist.main(args + ["--archive_to", str(tmp_path / "archive" / "dpdist")])
    assert trainer.global_step == 4   # 2 epochs of 2 full batches (4 train models)
    metrics = [json.loads(l) for l in open(os.path.join(log_dir, "metrics.jsonl"))]
    losses = [m["train_loss"] for m in metrics if "train_loss" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert os.path.isfile(str(tmp_path / "archive" / "dpdist.npz"))
    last = latest_checkpoint(log_dir)
    assert last.endswith("ckpt_4")
    resumed = train_dpdist.main(args + ["--resume", "--max_epoch", "1"])
    assert resumed.global_step == 6
    # The checkpoint serves, and restores through the JAX package.
    model = load_frozen_distance(last, device="cpu")
    assert model.cfg.dtype == dtype and model.cfg.mlp == (32, 32, 32)
    pcA, pcB = (torch.as_tensor(np.random.default_rng(s).uniform(-0.8, 0.8, (2, 16, 3))
                                .astype(np.float32)) for s in (1, 2))
    with torch.no_grad():
        d = model(pcA, pcB)
    assert d.shape == (2,) and bool(torch.isfinite(d).all())
    jparams, jstate = jax_init(jax.random.PRNGKey(0), JaxConfig(num_point=16, embedding_size=64,
                                                                 k=3, mlp=(32, 32, 32)))
    tree, step, _ = jax_restore(last, {"params": jparams, "state": jstate})
    assert step == 4
    for lp, mine in zip(tree["params"]["decoder"]["layers"],
                        model.params()["decoder"]["layers"]):
        np.testing.assert_array_equal(np.asarray(lp["w"]), mine["w"].numpy())


def test_train_dpdist_rejects_data_parallel(data_root, tmp_path):
    with pytest.raises(ValueError, match="world size 1"):
        train_dpdist.main(TRAIN + ["--data_root", str(data_root / "mine"), "--log_dir",
                                   str(tmp_path), "--data_parallel", "2"])


@pytest.mark.parametrize("flags", [["--BN", "1"], ["--implicit_net_type", "3"],
                                   ["--full_fv", "small"], ["--K", "0"],
                                   ["--encoder", "pointnet", "--K", "0", "--BN", "1"]],
                         ids=["bn", "conv3", "small_fv", "k0", "pointnet"])
def test_train_dpdist_variant_flags(data_root, tmp_path, flags):
    """The reference's ablation flags train end to end: train_dpdist for one
    epoch, and the checkpoint (with its BN state) restores through JAX's
    restore_checkpoint and serves in load_frozen_distance."""
    log_dir = str(tmp_path / "run")
    trainer = train_dpdist.main(TRAIN + flags + ["--data_root", str(data_root / "mine"),
                                                 "--log_dir", log_dir, "--max_epoch", "1"])
    last = latest_checkpoint(log_dir)
    jcfg = JaxConfig.from_json(trainer.mcfg.to_json())
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    tree, _, _ = jax_restore(last, {"params": jparams, "state": jstate})
    got = tree_flatten_with_paths(jax.device_get(tree["state"]))
    want = tree_flatten_with_paths(trainer.state)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert len(want) == (8 if "--BN" in flags else 0) + (6 if "pointnet" in flags else 0)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    model = load_frozen_distance(last, device="cpu")
    pcA, pcB = (torch.as_tensor(np.random.default_rng(s).uniform(-0.8, 0.8, (2, 16, 3))
                                .astype(np.float32)) for s in (1, 2))
    with torch.no_grad():
        d = model(pcA, pcB)
    assert d.shape == (2,) and bool(torch.isfinite(d).all())
