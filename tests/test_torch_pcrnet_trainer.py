"""The port's PCRNet trainer (dpdist_tpu_torch/train/pcrnet_trainer.py)
against dpdist_tpu's PCRNetTrainer (value_and_grad + optax), on the CPU:
one train step from the same JAX-initialised weights on the same batch,
for the three loss types, last-iteration and full-BPTT modes,
action_reg, fp_reg and grad_clip; checkpoints both ways.

Most cases step with momentum SGD at learning rate 1, so the parameter
change of the first step IS the (clipped) gradient: it is held within
REL_GRAD of the largest entry of each leaf (1e-4; 2e-3 through the frozen
DPDist loss, whose input gradients through the encode part from JAX's by
up to a few % on a few points, tests/test_torch_losses_optim.py). One
case steps with Adam, as the recipes do.
"""

import jax
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.models import init_pcrnet as jax_init
from dpdist_tpu.parallel import make_mesh
from dpdist_tpu.train.checkpoint import restore_params_maybe_state as jax_restore
from dpdist_tpu.train.logging import RunLogger as JaxRunLogger
from dpdist_tpu.train.pcrnet_trainer import PCRNetTrainer as JaxTrainer

from dpdist_tpu_torch.configs import PCRNetConfig, TrainConfig
from dpdist_tpu_torch.data.registration import RegistrationDataset
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.train.checkpoint import load_dpdist_checkpoint, tree_flatten_with_paths
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer

SMALL = dict(num_point=32, out_features=32, head_widths=(32, 16), max_loops=3)
CANONICAL_NET = "results/ckpt_best"
TOL_LOSS = 1e-5
REL_GRAD, REL_GRAD_DPDIST = 1e-4, 2e-3


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


def _batch(seed, B=2, N=32):
    ds = RegistrationDataset(num_point=N, n_templates=4, families=("chair", "box"), seed=seed,
                             max_rotate_deg=30.0)
    return ds.sample_batch(B, noise_prob=0.5)


def _pair(tmp_path, loss_type, *, optimizer="momentum", lr=1.0, grad_clip=0.0, **kw):
    jcfg, cfg = JaxPCRNetConfig(**SMALL), PCRNetConfig(**SMALL)
    tcfg = dict(batch_size=2, optimizer=optimizer, learning_rate=lr, momentum=0.9,
                grad_clip=grad_clip)
    jdp = tdp = None
    if loss_type == "dpdist":
        jdp, tdp = jax_load_dpdist(CANONICAL_NET), load_dpdist_checkpoint(CANONICAL_NET)
    jtr = JaxTrainer(jcfg, JaxTrainConfig(**tcfg), loss_type=loss_type, dpdist=jdp,
                     run_dir=str(tmp_path / "jax"), mesh=make_mesh(data=1),
                     logger=JaxRunLogger(str(tmp_path / "jax"), echo=False), **kw)
    ttr = PCRNetTrainer(cfg, TrainConfig(**tcfg), loss_type=loss_type, dpdist=tdp,
                        run_dir=str(tmp_path / "port"), device="cpu",
                        logger=RunLogger(str(tmp_path / "port"), echo=False), **kw)
    ttr.params = params_to_device(jax.device_get(jtr.params), "cpu", requires_grad=True)
    ttr.opt_state = ttr.optimizer.init(ttr.params)
    return jtr, ttr


CASES = {
    "chamfer_last": ("chamfer", {}),
    "chamfer_single_action_reg_clip": ("chamfer", dict(train_single=True, action_reg=0.5,
                                                       grad_clip=0.05)),
    "chamfer_last_fp_reg": ("chamfer", dict(fp_reg=0.3, fp_steps=2)),
    "emd_last": ("emd", {}),
    "emd_single": ("emd", dict(train_single=True)),
    "dpdist_last": ("dpdist", {}),
    "dpdist_single_fp_reg_clip": ("dpdist", dict(train_single=True, fp_reg=0.2, fp_steps=2,
                                                 grad_clip=0.05)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, tmp_path):
    loss_type, kw = CASES[case]
    jtr, ttr = _pair(tmp_path, loss_type, **kw)
    template, source, pose6 = _batch(list(CASES).index(case))
    before = {p: t.detach().clone() for p, t in tree_flatten_with_paths(ttr.params)}
    jm = jtr.train_step(template, source, pose6=pose6)
    tm = ttr.train_step(template, source, pose6=pose6)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL_LOSS, abs=1e-7)
    rel = REL_GRAD_DPDIST if loss_type == "dpdist" else REL_GRAD
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=rel)
    after = dict(tree_flatten_with_paths(jax.device_get(jtr.params)))
    for path, t in tree_flatten_with_paths(ttr.params):
        want = before[path].numpy() - np.asarray(after[path])   # the step: lr 1 x gradient
        got = (before[path] - t.detach()).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-7,
                                   err_msg=path)


def test_adam_step_matches_jax(tmp_path):
    """The recipes' Adam at its default learning rate. Its first step moves
    a weight by lr * g / (|g| + 1e-8): lr * sign(g) where |g| >> 1e-8, so
    the weights agree within 1e-6 there and within 2 lr where |g| is
    rounding-sized."""
    jtr, ttr = _pair(tmp_path, "chamfer", optimizer="adam", lr=1e-4, train_single=True)
    template, source, _ = _batch(5)
    jm, tm = jtr.train_step(template, source), ttr.train_step(template, source)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL_LOSS)
    after = dict(tree_flatten_with_paths(jax.device_get(jtr.params)))
    for path, t in tree_flatten_with_paths(ttr.params):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(after[path]), rtol=0,
                                   atol=2e-4 + 1e-6, err_msg=path)
        assert np.mean(np.abs(t.detach().numpy() - np.asarray(after[path])) > 1e-6) < 0.01


def test_checkpoints_both_ways(tmp_path):
    """save -> restore equal; a JAX-written PCRNet checkpoint restores into
    the port, and the port's into JAX."""
    jtr, ttr = _pair(tmp_path, "chamfer")
    ttr.train_step(*_batch(6)[:2])
    path = ttr.save(tag="best")
    fresh = PCRNetTrainer(PCRNetConfig(**SMALL), TrainConfig(batch_size=2), device="cpu",
                          run_dir=str(tmp_path / "fresh"),
                          logger=RunLogger(str(tmp_path / "fresh"), echo=False))
    fresh.restore(path)
    assert fresh.global_step == 1
    for (p, a), (_, b) in zip(tree_flatten_with_paths(fresh.params),
                              tree_flatten_with_paths(ttr.params)):
        assert torch.equal(a, b), p
        assert a.requires_grad
    jtemplate, jstate = jax_init(jax.random.PRNGKey(3), JaxPCRNetConfig(**SMALL))
    jparams, _, step = jax_restore(path, jtemplate, jstate)
    assert step == 1
    for (p, a), (_, b) in zip(tree_flatten_with_paths(jax.device_get(jparams)),
                              tree_flatten_with_paths(ttr.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(), err_msg=p)

    jtr.train_step(*_batch(7)[:2])
    jpath = jtr.save(tag="final")
    fresh.restore(jpath)
    for (p, a), (_, b) in zip(tree_flatten_with_paths(fresh.params),
                              tree_flatten_with_paths(jax.device_get(jtr.params))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b), err_msg=p)


def test_trainer_refuses_what_the_reference_refuses(tmp_path):
    cfg, tcfg = PCRNetConfig(**SMALL), TrainConfig(batch_size=2)
    log = RunLogger(str(tmp_path), echo=False)
    with pytest.raises(ValueError, match="dpdist"):
        PCRNetTrainer(cfg, tcfg, loss_type="dpdist", device="cpu", logger=log)
    with pytest.raises(ValueError, match="train_single"):
        PCRNetTrainer(cfg, tcfg, action_reg=0.1, device="cpu", logger=log)
    tr = PCRNetTrainer(cfg, tcfg, fp_reg=0.1, device="cpu", logger=log)
    with pytest.raises(ValueError, match="pose6"):
        tr.train_step(*_batch(8)[:2])


def test_action_norms_near_zero_match_jax():
    """action_reg's and fp_reg's norms of translations and quaternion
    vectors near zero (1e-6, 1e-12; not exactly zero) and their gradients
    agree with JAX's. At exactly zero JAX's gradient is NaN, the port's 0
    (torch's norm): a state float data does not reach."""
    import jax.numpy as jnp

    from dpdist_tpu.geometry import normalize_quat as jax_normalize_quat

    from dpdist_tpu_torch.train.pcrnet_trainer import _action_magnitude

    r = np.random.default_rng(9)
    poses = r.normal(size=(4, 3, 7)).astype(np.float32)
    poses[0, :, :3] *= 1e-6
    poses[1, :, :3] *= 1e-12
    poses[2, :, 4:] *= 1e-6
    poses[3, :, 4:] *= 1e-12

    def jax_mag(p):
        t = jnp.linalg.norm(p[..., :3], axis=-1)
        q = jax_normalize_quat(p[..., 3:7])
        return jnp.mean(t + jnp.linalg.norm(q[..., 1:], axis=-1))

    want, jgrad = jax.value_and_grad(jax_mag)(poses)
    p = torch.tensor(poses, requires_grad=True)
    got = _action_magnitude(p)
    (grad,) = torch.autograd.grad(got, p)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    zero = torch.zeros(1, 7, requires_grad=True)
    (g0,) = torch.autograd.grad(_action_magnitude(zero + torch.tensor([0, 0, 0, 1.0, 0, 0, 0])),
                                zero)
    assert bool(torch.isfinite(g0).all())
    assert bool(jnp.isnan(jax.grad(jax_mag)(jnp.float32([[0, 0, 0, 1, 0, 0, 0]]))).any())
