"""The port's data layer against dpdist_tpu, on the CPU: the surface-pair
dataset's batches, the augmentations, the file formats, the native
parser, the registration corruptions, and one trainer step with encoder
occlusion. Every comparison is byte for byte except the trainer step.
"""

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.data import augment as jax_augment
from dpdist_tpu.data import io as jax_io
from dpdist_tpu.data.gtgen import generate_synthetic_dataset as jax_generate
from dpdist_tpu.data.modelnet import SurfacePairDataset as JaxDataset
from dpdist_tpu.data.registration import add_noise_np as jax_add_noise
from dpdist_tpu.data.registration import add_occlusions_np as jax_add_occlusions
from dpdist_tpu.native import fast_loadtxt as jax_fast_loadtxt
from dpdist_tpu.train import DPDistTrainer as JaxTrainer
from dpdist_tpu.train.logging import RunLogger as JaxRunLogger

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.data import augment, io
from dpdist_tpu_torch.data.modelnet import SurfacePairDataset
from dpdist_tpu_torch.data.registration import add_noise_np, add_occlusions_np
from dpdist_tpu_torch.native import available, fast_loadtxt
from dpdist_tpu_torch.train import params_from_jax
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.trainer import DPDistTrainer
from reference_native import _reference_native_so, reference_native  # noqa: F401

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
# One occluded train step, port (plain PyTorch) against JAX (XLA), both on
# the CPU: the tolerances of tests/test_torch_trainer.py.
TOL_LOSS, TOL_PARAM = 1e-5, 1e-6


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """A small ground-truth dataset written by the JAX package (two
    families, five models each)."""
    root = str(tmp_path_factory.mktemp("data"))
    jax_generate(root, families=("chair", "box"), n_train=3, n_test=2, n_surface=1500,
                 num_neg_points=200, seed=2)
    return root


@pytest.mark.parametrize("split,class_choice,augmented", [
    ("train", None, False), ("train", None, True), ("test", "box", True)])
def test_dataset_batches_equal_jax(dataset_root, split, class_choice, augmented):
    """Two epochs of SurfacePairDataset against dpdist_tpu's for one seed:
    the same batches, byte for byte, with augment on and off, shuffled
    (train) or not (test), and with a class filter."""
    kw = dict(batch_size=2, npoints=32, split=split, class_choice=class_choice, seed=5)
    mine, ref = SurfacePairDataset(dataset_root, **kw), JaxDataset(dataset_root, **kw)
    assert len(mine) == len(ref) > 0 and mine.num_neg_points == ref.num_neg_points == 200
    for _ in range(2):
        mine.reset()
        ref.reset()
        n = 0
        while ref.has_next_batch():
            assert mine.has_next_batch()
            (d1, l1), (d2, l2) = mine.next_batch(augment=augmented), ref.next_batch(
                augment=augmented)
            assert d1.dtype == d2.dtype and d1.tobytes() == d2.tobytes()
            assert l1.dtype == l2.dtype and l1.tobytes() == l2.tobytes()
            n += 1
        assert not mine.has_next_batch() and n == ref.num_batches


@pytest.mark.parametrize("name,args", [
    ("rotate_point_cloud", ()), ("rotate_point_cloud_z", ()),
    ("rotate_perturbation_point_cloud", ()), ("jitter_point_cloud", ()),
    ("shift_point_cloud", ()), ("random_scale_point_cloud", ()),
    ("random_point_dropout", ()), ("shuffle_points", ()), ("augment_batch", ()),
    ("rotate_point_cloud_by_angle", (0.7,)),
])
def test_augment_equals_jax(name, args):
    batch = np.random.default_rng(1).uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    rngs = (np.random.default_rng(9), np.random.default_rng(9))
    if args:
        got, want = (getattr(m, name)(batch, *args) for m in (augment, jax_augment))
    else:
        got, want = (getattr(m, name)(batch, r) for m, r in zip((augment, jax_augment), rngs))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_augment_with_normals_equals_jax():
    batch = np.random.default_rng(2).uniform(-1, 1, (2, 30, 6)).astype(np.float32)
    for name in ("rotate_point_cloud_with_normal", "rotate_perturbation_point_cloud_with_normal"):
        got = getattr(augment, name)(batch, np.random.default_rng(4))
        want = getattr(jax_augment, name)(batch, np.random.default_rng(4))
        assert got.tobytes() == want.tobytes()
    got = augment.rotate_point_cloud_by_angle_with_normal(batch, 0.3)
    assert got.tobytes() == jax_augment.rotate_point_cloud_by_angle_with_normal(batch, 0.3).tobytes()
    labels = np.arange(2)
    got = augment.shuffle_data(batch, labels, np.random.default_rng(5))
    want = jax_augment.shuffle_data(batch, labels, np.random.default_rng(5))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("fmt", ["xyz", "ply_binary", "ply_ascii", "pose", "h5"])
def test_io_round_trips_against_jax(tmp_path, fmt):
    """Each format written by the port is byte for byte the file the JAX
    package writes, and each package reads the other's file back."""
    pts = np.random.default_rng(3).uniform(-1, 1, (50, 3)).astype(np.float32)
    writers = {
        "xyz": ("write_xyz_txt", "read_xyz_txt", pts, {}),
        "ply_binary": ("write_ply", "read_ply", pts, {"binary": True}),
        "ply_ascii": ("write_ply", "read_ply", pts, {"binary": False}),
        "pose": ("write_pose_csv", "read_pose_csv", np.concatenate([pts[:8], pts[8:16]], 1), {}),
        "h5": ("write_templates_h5", "read_templates_h5", pts.reshape(5, 10, 3), {}),
    }
    write, read, data, kw = writers[fmt]
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    mine.mkdir()
    ref.mkdir()
    getattr(io, write)(str(mine / "f"), data, **kw)
    getattr(jax_io, write)(str(ref / "f"), data, **kw)
    if fmt != "h5":   # h5 files carry creation metadata
        assert (mine / "f").read_bytes() == (ref / "f").read_bytes()
    for reader in (io, jax_io):
        for path in (mine / "f", ref / "f"):
            back = getattr(reader, read)(str(path))
            assert back.dtype == np.float32
            np.testing.assert_array_equal(back, getattr(jax_io, read)(str(ref / "f")))


def test_fast_loadtxt_equals_jax_and_numpy(tmp_path, reference_native):
    """The native parser (built into the port's own build directory) reads
    the ground-truth files as dpdist_tpu's does and as np.loadtxt does."""
    assert available()
    rows = np.random.default_rng(6).uniform(-2, 2, (300, 4)).astype(np.float32)
    path = str(tmp_path / "rows.txt")
    np.savetxt(path, rows, fmt="%.6f", delimiter=",")
    got = fast_loadtxt(path, 4)
    assert got.tobytes() == jax_fast_loadtxt(path, 4).tobytes()
    assert got.tobytes() == np.loadtxt(path, delimiter=",").astype(np.float32).tobytes()
    with pytest.raises(ValueError):
        fast_loadtxt(path, 7)   # 1,200 values are no whole number of rows of 7
    with pytest.raises(FileNotFoundError):
        fast_loadtxt(str(tmp_path / "missing.txt"), 4)


def test_native_nn_distance_equals_jax(reference_native):
    """The native library's nearest-neighbour pass, which both packages
    build from one source: the same squared distances and indices."""
    from dpdist_tpu.native import nn_distance_native as jax_nn
    from dpdist_tpu_torch.native import nn_distance_native

    r = np.random.default_rng(12)
    a, b = r.uniform(-1, 1, (500, 3)), r.uniform(-1, 1, (700, 3))
    (d, i), (jd, ji) = nn_distance_native(a, b), jax_nn(a, b)
    assert d.tobytes() == jd.tobytes() and np.array_equal(i, ji)
    brute = ((a[:, None] - b[None]) ** 2).sum(-1)
    assert np.array_equal(i, brute.argmin(1))


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5])
def test_registration_corruptions_equal_jax(fraction):
    src = np.random.default_rng(7).uniform(-1, 1, (3, 64, 3)).astype(np.float32)
    got = add_occlusions_np(src, fraction, np.random.default_rng(1))
    want = jax_add_occlusions(src, fraction, np.random.default_rng(1))
    assert got.tobytes() == want.tobytes()
    got = add_noise_np(src, np.random.default_rng(2))
    assert got.tobytes() == jax_add_noise(src, np.random.default_rng(2)).tobytes()
    with pytest.raises(ValueError):
        add_occlusions_np(src, 1.0, np.random.default_rng(0))


def test_occluded_train_step_matches_jax(tmp_path):
    """Encoder occlusion through the noise channel, with add_noise on top:
    the port's noise equals the JAX trainer's (the same draws in the same
    order), and one train step from the same parameters gives the same
    loss and parameters."""
    tcfg = dict(batch_size=2, augment=False, encoder_occlusion=0.3,
                encoder_occlusion_prob=0.6, add_noise=0.01, seed=3)
    jtrainer = JaxTrainer(JaxConfig(**SMALL), JaxTrainConfig(**tcfg), run_dir=str(tmp_path / "j"),
                          logger=JaxRunLogger(str(tmp_path / "j"), echo=False))
    trainer = DPDistTrainer(DPDistConfig(**SMALL), TrainConfig(**tcfg), run_dir=str(tmp_path / "t"),
                            device="cpu", logger=RunLogger(str(tmp_path / "t"), echo=False))
    trainer._set_params(params_from_jax(jax.device_get(jtrainer.params), "cpu"))
    r = np.random.default_rng(8)
    batches = [(r.uniform(-0.9, 0.9, (2, 6 * 16, 3)).astype(np.float32),
                r.uniform(0.0, 0.3, (2, 4 * 16)).astype(np.float32)) for _ in range(3)]
    for data, labels in batches[:2]:
        want = np.asarray(jtrainer._make_batch(data, labels)["noise"])
        got = trainer.make_batch(data, labels)[3]
        assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()
    selected = [np.abs(trainer.make_batch(d, l)[3].numpy()).max() > 0.1 for d, l in batches * 3]
    assert any(selected)   # some items were occluded
    jtrainer._np_rng = np.random.default_rng(11)
    trainer._np_rng = np.random.default_rng(11)
    want = float(np.asarray(jtrainer.train_step(*batches[2])["loss"]))
    got = float(trainer.train_step(*batches[2])["loss"])
    assert abs(got - want) <= TOL_LOSS
    lr = TrainConfig().learning_rate
    jlayers = jax.device_get(jtrainer.params)["decoder"]["layers"]
    for lp, jlp in zip(trainer.params["decoder"]["layers"], jlayers):
        for key in ("w", "b"):
            diff = np.abs(lp[key].detach().numpy() - np.asarray(jlp[key]))
            assert np.all(diff <= 2 * lr + TOL_PARAM)
            assert np.mean(diff <= TOL_PARAM) >= 0.99
