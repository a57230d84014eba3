"""The port's DPDist trainer and checkpoint writer against dpdist_tpu, on
the CPU at a small width."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
from dpdist_tpu.data.batching import assemble_dpdist_batch as jax_assemble
from dpdist_tpu.losses import l1_sample_loss as jax_l1
from dpdist_tpu.models import apply_dpdist as jax_apply
from dpdist_tpu.models import init_dpdist as jax_init
from dpdist_tpu.train.checkpoint import restore_checkpoint as jax_restore
from dpdist_tpu.train.checkpoint import save_checkpoint as jax_save
from dpdist_tpu.train.optim import make_optimizer as jax_make_optimizer

from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
from dpdist_tpu_torch.models import apply_dpdist
from dpdist_tpu_torch.train import (
    archived_metric,
    latest_checkpoint,
    params_from_jax,
    params_to_numpy,
)
from dpdist_tpu_torch.train.logging import RunLogger
from dpdist_tpu_torch.train.trainer import DPDistTrainer

SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
# Loss and gradients, port (plain PyTorch) against JAX (XLA), both on the
# CPU: the encodes differ by up to 2e-5 and the sums run in other orders.
TOL_LOSS = 1e-5
TOL_GRAD_REL = 1e-3


def _batch(seed, B=2, N=16):
    r = np.random.default_rng(seed)
    data = r.uniform(-0.9, 0.9, (B, 6 * N, 3)).astype(np.float32)
    labels = r.uniform(0.0, 0.3, (B, 4 * N)).astype(np.float32)
    return data, labels


def _trainer(tmp_path, jparams=None, **train):
    cfg = DPDistConfig(**SMALL)
    tcfg = TrainConfig(batch_size=2, augment=False, **train)
    logger = RunLogger(str(tmp_path), echo=False)
    trainer = DPDistTrainer(cfg, tcfg, run_dir=str(tmp_path), device="cpu", logger=logger)
    if jparams is not None:
        trainer._set_params(params_from_jax(jax.device_get(jparams), "cpu"))
    return trainer


def test_one_train_step_matches_jax(tmp_path):
    """One value_and_grad + make_optimizer (Adam) step of the JAX package,
    from the same JAX-initialised params and the same batch: loss, grads
    and params after the step.

    Adam's first step moves a weight by lr * g / (|g| + 1e-8). Where |g| is
    far above 1e-8 that is lr * sign(g) to float rounding, and the params
    agree to 1e-6. Where |g| is near 1e-8 a difference of 1e-10 in g (the
    grads' own tolerance) moves the weight by up to lr in either
    direction, so there the params agree to 2 * lr.
    """
    jcfg = JaxConfig(**SMALL)
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    data, labels = _batch(0)
    pcA, pcB, lab = (jnp.asarray(a) for a in jax_assemble(data, labels))

    def loss_fn(p):
        pred_AB, _, _ = jax_apply(p, jstate, jcfg.replace(fused_gather="off"), pcA, pcB,
                                  train=True)
        return jax_l1(pred_AB, lab)

    want_loss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    opt = jax_make_optimizer(JaxTrainConfig(batch_size=2))
    updates, _ = opt.update(jgrads, opt.init(jparams), jparams)
    jafter = optax.apply_updates(jparams, updates)

    trainer = _trainer(tmp_path, jparams)
    loss, grads = trainer.loss_and_grads(*trainer.make_batch(data, labels))
    assert abs(float(loss) - float(want_loss)) <= TOL_LOSS
    want_leaves = [np.asarray(lp[key]) for lp in jgrads["decoder"]["layers"] for key in ("b", "w")]
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL_GRAD_REL * np.abs(w).max(), rtol=0)

    metrics = trainer.train_step(data, labels)
    assert abs(float(metrics["loss"]) - float(want_loss)) <= TOL_LOSS
    gnorm = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want_leaves))
    assert abs(float(metrics["grad_norm"]) - gnorm) <= TOL_GRAD_REL * gnorm
    lr = TrainConfig().learning_rate
    for lp, jlp, jg in zip(trainer.params["decoder"]["layers"], jafter["decoder"]["layers"],
                           jgrads["decoder"]["layers"]):
        for key in ("w", "b"):
            got, want = lp[key].detach().numpy(), np.asarray(jlp[key])
            large = np.abs(np.asarray(jg[key])) > 1e-6
            assert np.all(np.abs(got - want)[large] <= 1e-6)
            assert np.all(np.abs(got - want) <= 2 * lr + 1e-6)
    assert trainer.global_step == 1 and trainer.opt_state["count"] == 1


def test_noise_goes_to_the_encoder_copy_only():
    """apply_dpdist(noise=...) against JAX: noise moves surface(A) only;
    the query points (and so the masks and deltas) stay exact."""
    jcfg = JaxConfig(**SMALL).replace(fused_gather="off")
    jparams, jstate = jax_init(jax.random.PRNGKey(1), jcfg)
    r = np.random.default_rng(1)
    pcA, pcB = (r.uniform(-0.9, 0.9, (2, 16, 3)).astype(np.float32) for _ in range(2))
    noise = (0.05 * r.standard_normal((2, 16, 3))).astype(np.float32)
    jAB, jBA, _ = jax_apply(jparams, jstate, jcfg, jnp.asarray(pcA), jnp.asarray(pcB),
                            noise=jnp.asarray(noise), train=True)
    tparams = params_from_jax(jax.device_get(jparams), "cpu")
    cfg = DPDistConfig(**SMALL)
    with torch.no_grad():
        pAB, pBA = apply_dpdist(tparams, cfg, torch.as_tensor(pcA), torch.as_tensor(pcB),
                                noise=torch.as_tensor(noise), train=True)
        cAB, cBA = apply_dpdist(tparams, cfg, torch.as_tensor(pcA), torch.as_tensor(pcB))
    np.testing.assert_allclose(pAB.numpy(), np.asarray(jAB), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pBA.numpy(), np.asarray(jBA), atol=1e-5, rtol=0)
    assert torch.equal(pBA, cBA) and not torch.equal(pAB, cAB)


def test_port_checkpoint_restores_through_jax(tmp_path):
    """A port checkpoint restores through dpdist_tpu's restore_checkpoint
    against a JAX init_dpdist template, and its config through JAX's
    load_dpdist_checkpoint."""
    trainer = _trainer(tmp_path)
    trainer.train_step(*_batch(2))
    path = trainer.save(tag=trainer.global_step)
    assert latest_checkpoint(str(tmp_path)) == path
    jparams, jstate = jax_init(jax.random.PRNGKey(0), JaxConfig(**SMALL))
    tree, step, meta = jax_restore(path, {"params": jparams, "state": jstate})
    assert step == 1
    mine = params_to_numpy(trainer.params)
    for lp, jlp in zip(mine["decoder"]["layers"], tree["params"]["decoder"]["layers"]):
        for key in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(jlp[key]), lp[key])
    jcfg, jp, _ = jax_load_dpdist(path)
    assert jcfg == JaxConfig(**SMALL)
    assert json.loads(meta["model_config"])["mlp"] == [32, 32, 32]


def test_jax_checkpoint_restores_into_the_trainer(tmp_path):
    jparams, jstate = jax_init(jax.random.PRNGKey(5), JaxConfig(**SMALL))
    path = str(tmp_path / "ckpt_7")
    jax_save(path, {"params": jparams, "state": jstate}, step=7,
             metadata={"model_config": JaxConfig(**SMALL).to_json()})
    trainer = _trainer(tmp_path)
    trainer.restore()
    assert trainer.global_step == 7
    for lp, jlp in zip(trainer.params["decoder"]["layers"], jparams["decoder"]["layers"]):
        assert lp["w"].requires_grad
        np.testing.assert_array_equal(lp["w"].detach().numpy(), np.asarray(jlp["w"]))
    wrong = str(tmp_path / "wrong")
    jax_save(wrong, {"params": {"decoder": {"layers": []}}}, step=1)
    with pytest.raises(ValueError, match="structure mismatch"):
        trainer.restore(wrong)


class _Dataset:
    """The reference's iterator protocol over fixed numpy batches."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def reset(self):
        self.i = 0

    def has_next_batch(self):
        return self.i < len(self.batches)

    def next_batch(self, augment=False):
        self.i += 1
        return self.batches[self.i - 1]


def test_fit_keeps_best_and_archives(tmp_path):
    train = _Dataset([_batch(s) for s in range(3)] + [_batch(9, B=1)])   # a dropped tail
    test = _Dataset([_batch(10), _batch(11, B=1)])
    trainer = _trainer(tmp_path / "run")
    archive = str(tmp_path / "results" / "dpdist")
    best = trainer.fit(train, test, max_epoch=3, eval_every=1, archive_to=archive)
    assert trainer.global_step == 9
    assert np.isfinite(best) and archived_metric(archive, "eval_l1") == pytest.approx(best)
    assert (tmp_path / "run" / "ckpt_best.npz").is_file()
    assert latest_checkpoint(str(tmp_path / "run")).endswith("ckpt_9")
    lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert sum("train_loss" in line for line in lines) == 3
    # A resumed run beats the archive's bar or leaves the archive alone.
    again = _trainer(tmp_path / "run2")
    again.fit(train, test, max_epoch=1, eval_every=1, archive_to=archive)
    assert archived_metric(archive, "eval_l1") <= best


def test_train_epoch_with_and_without_prefetch_agree(tmp_path):
    data = _Dataset([_batch(s) for s in range(3)])
    a, b = _trainer(tmp_path / "a"), _trainer(tmp_path / "b")
    assert a.train_epoch(data, 0, prefetch=True) == b.train_epoch(data, 0, prefetch=False)
    assert torch.equal(a.params["decoder"]["layers"][0]["w"], b.params["decoder"]["layers"][0]["w"])


def test_training_lowers_the_loss_on_a_fixed_batch(tmp_path):
    trainer = _trainer(tmp_path, learning_rate=1e-3)
    data, labels = _batch(3)
    losses = [float(trainer.train_step(data, labels)["loss"]) for _ in range(12)]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_trainer_add_noise_feeds_the_encoder(tmp_path):
    trainer = _trainer(tmp_path, add_noise=0.02)
    pcA, pcB, labels, noise = trainer.make_batch(*_batch(4))
    assert noise is not None and noise.shape == pcA.shape
    assert 0.01 < float(noise.std()) < 0.03
    assert np.isfinite(float(trainer.train_step(*_batch(4))["loss"]))


def test_trainer_defaults_to_cuda_and_rejects_what_is_not_ported(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        DPDistTrainer(DPDistConfig(**SMALL), TrainConfig(), run_dir=str(tmp_path))
    # Encoder occlusion is ported (tests/test_torch_data.py holds it
    # against JAX), and so is every DPDist variant
    # (tests/test_torch_variants.py); a float16 decoder is not.
    with pytest.raises(NotImplementedError, match="float16"):
        DPDistTrainer(DPDistConfig(**SMALL, dtype="float16"), TrainConfig(),
                      run_dir=str(tmp_path), device="cpu")
