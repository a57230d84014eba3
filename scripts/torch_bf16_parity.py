#!/usr/bin/env python3
"""The port's bf16 gradients against the JAX package's, on the CPU.

    PYTHONPATH=. python scripts/torch_bf16_parity.py [--clamp] [--train]

Frozen loss (default): for both committed nets, on the eight golden
pairs (dpdist_tpu_torch/assets/golden_distance.json, 64 points) and six
seeded inputs (four pairs of 64-point synthetic surfaces, x0.8), the bf16 frozen loss
and its gradient in pcA through the port (plain path) and through JAX
(its XLA composition), printing the loss difference and, per point
relative to the largest |g|, the worst difference, the share above 1e-2
and the cosine. --clamp runs the port with its output activation's
gradient as torch.clamp gives it (all of the incoming gradient at the
clip edges) instead of jnp.clip's half, the behaviour before that fault
was repaired.

--train: one bf16 train step (the small config of the tests) at 32 and
64 rows for six seeds: the worst weight leaf against JAX's, and per bias
leaf how far JAX's gradient, the port's, and each from the other, lie
from the float64 sum of the port's own bf16 row gradients, as a share of
the leaf's largest entry.
"""

from __future__ import annotations

import argparse
import functools
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
FAMILIES = ("chair", "box", "sphere", "torus", "cone", "capsule", "cylinder")
SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))


def clouds(seed):
    from dpdist_tpu_torch.data.synthetic import synthetic_surface

    pick = [(FAMILIES[(seed + i) % 7], 100 * seed + i) for i in range(4)]
    pcA = np.stack([synthetic_surface(f, seed=s, n_points=64) * 0.8 for f, s in pick])
    pcB = np.stack([synthetic_surface(FAMILIES[(seed + i + 1) % 7], seed=100 * seed + i + 50,
                                      n_points=64) * 0.8 for i in range(4)])
    return pcA.astype(np.float32), pcB.astype(np.float32)


def frozen(clamp: bool):
    from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
    from dpdist_tpu.losses import make_frozen_dpdist_loss as jax_frozen_loss

    import dpdist_tpu_torch.models.dpdist as model
    from dpdist_tpu_torch.data.golden import golden_clouds, load_golden
    from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
    from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax

    if clamp:
        model._clip = torch.clamp

    @functools.partial(jax.jit, static_argnums=(2,))
    def jax_value_and_grad(params, state, cfg, a, b):
        return jax.value_and_grad(jax_frozen_loss(params, state, cfg, out_of_grid_penalty=1.0))(
            a, b)

    for net in NETS:
        cfg, params, state = jax_load(str(ROOT / net))
        tcfg, tp, _ = load_dpdist_checkpoint(str(ROOT / net))
        tparams = params_from_jax(tp, "cpu")
        loss_fn = make_frozen_dpdist_loss(tparams, tcfg.replace(dtype="bfloat16"),
                                          out_of_grid_penalty=1.0)
        for seed in ["golden"] + list(range(6)):
            pcA, pcB = golden_clouds(load_golden()) if seed == "golden" else clouds(seed)
            value, g_jax = jax_value_and_grad(params, state, cfg.replace(dtype="bfloat16",
                                                                         fused_gather="off"),
                                              jnp.asarray(pcA), jnp.asarray(pcB))
            g_jax = np.asarray(g_jax)
            if seed == "golden":   # how far JAX's own bf16 gradient lies from its f32 one
                _, g32 = jax_value_and_grad(params, state, cfg.replace(fused_gather="off"),
                                            jnp.asarray(pcA), jnp.asarray(pcB))
                g32 = np.asarray(g32)
                e32 = np.abs(g_jax - g32).max(-1) / np.abs(g32).max()
                c32 = float((g_jax * g32).sum() / np.linalg.norm(g_jax) / np.linalg.norm(g32))
                print(f"{net} golden: JAX bf16 vs JAX f32 d/dpcA worst {e32.max():.4f}, "
                      f"cosine {c32:.6f}", flush=True)
            a = torch.tensor(pcA, requires_grad=True)
            v = loss_fn(a, torch.as_tensor(pcB))
            g = torch.autograd.grad(v, a)[0].numpy()
            err = np.abs(g - g_jax).max(-1) / np.abs(g_jax).max()
            cos = float((g * g_jax).sum() / np.linalg.norm(g) / np.linalg.norm(g_jax))
            print(f"{net} seed {seed}: loss |d| {abs(float(v.detach()) - float(value)):.2e}; "
                  f"d/dpcA worst {err.max():.4f}, share > 1e-2 {np.mean(err > 1e-2):.4f}, "
                  f"cosine {cos:.6f}", flush=True)


def train_bias():
    from dpdist_tpu.configs import DPDistConfig as JaxConfig
    from dpdist_tpu.losses import l1_sample_loss as jax_l1
    from dpdist_tpu.models import apply_dpdist as jax_apply
    from dpdist_tpu.models import init_dpdist as jax_init
    from dpdist_tpu.models.dpdist import resolve_for_grad as jax_resolve_for_grad

    from dpdist_tpu_torch.configs import DPDistConfig, TrainConfig
    from dpdist_tpu_torch.nn import layers
    from dpdist_tpu_torch.train import params_from_jax
    from dpdist_tpu_torch.train.logging import RunLogger
    from dpdist_tpu_torch.train.trainer import DPDistTrainer

    jcfg = JaxConfig(**SMALL, dtype="bfloat16")
    jparams, jstate = jax_init(jax.random.PRNGKey(0), jcfg)
    products = []

    def dense_apply(params, x):
        y = torch.matmul(x, params["w"])
        y.retain_grad()
        products.append(y)
        return y + params["b"]

    layers.dense_apply = dense_apply
    for B in (2, 4):
        worst_jax = worst_port = worst_apart = worst_w = 0.0
        for seed in range(6):
            r = np.random.default_rng(seed)
            data = r.uniform(-0.9, 0.9, (B, 6 * 16, 3)).astype(np.float32)
            labels = r.uniform(0.0, 0.3, (B, 4 * 16)).astype(np.float32)
            tmp = tempfile.mkdtemp()
            trainer = DPDistTrainer(DPDistConfig(**SMALL, dtype="bfloat16"),
                                    TrainConfig(batch_size=B, augment=False), run_dir=tmp,
                                    device="cpu", logger=RunLogger(tmp, echo=False))
            trainer._set_params(params_from_jax(jax.device_get(jparams), "cpu"))
            pcA, pcB, lab, _ = trainer.make_batch(data, labels)

            def loss_fn(p):
                pred_AB, _, _ = jax_apply(p, jstate, jax_resolve_for_grad(jcfg),
                                          jnp.asarray(pcA.numpy()), jnp.asarray(pcB.numpy()),
                                          train=True)
                return jax_l1(pred_AB, jnp.asarray(lab.numpy()))

            _, jgrads = jax.value_and_grad(loss_fn)(jparams)
            products.clear()
            _, grads = trainer.loss_and_grads(pcA, pcB, lab)
            for i, y in enumerate(products):
                exact = y.grad.reshape(-1, y.shape[-1]).double().sum(0).numpy()
                jb = np.asarray(jgrads["decoder"]["layers"][i]["b"], np.float64)
                scale = np.abs(jb).max()
                worst_jax = max(worst_jax, np.abs(jb - exact).max() / scale)
                worst_port = max(worst_port, np.abs(grads[2 * i].numpy() - exact).max() / scale)
                worst_apart = max(worst_apart, np.abs(grads[2 * i].numpy() - jb).max() / scale)
                jw = np.asarray(jgrads["decoder"]["layers"][i]["w"])
                worst_w = max(worst_w, np.abs(grads[2 * i + 1].numpy() - jw).max()
                              / np.abs(jw).max())
        print(f"bf16 train step, {B * 16} rows, 6 seeds: weight leaves, port vs JAX, worst "
              f"{worst_w:.4f}; bias gradients from the float64 sum: JAX worst {worst_jax:.4f}, "
              f"port worst {worst_port:.4f}, port vs JAX worst {worst_apart:.4f} of the leaf's "
              f"largest entry", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clamp", action="store_true")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    if args.train:
        train_bias()
    else:
        frozen(args.clamp)
