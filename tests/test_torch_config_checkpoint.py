"""The port's config and checkpoint reader against dpdist_tpu."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.configs import DPDistConfig as JaxConfig
from dpdist_tpu.nn.layers import mlp_apply as jax_mlp_apply
from dpdist_tpu.nn.layers import mlp_init as jax_mlp_init

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.nn.layers import mlp_apply
from dpdist_tpu_torch.train import load_checkpoint, load_dpdist_checkpoint, params_from_jax

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")


def test_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(DPDistConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == ref


@pytest.mark.parametrize("net", NETS)
def test_committed_configs_parse(net):
    with open(net + ".json") as f:
        s = json.load(f)["metadata"]["model_config"]
    ours, ref = DPDistConfig.from_json(s), JaxConfig.from_json(s)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert isinstance(ours.mlp, tuple)
    assert hash(ours) == hash(DPDistConfig.from_json(s))
    for prop in ("grid_size", "fv_channels", "patch_dim"):
        assert getattr(ours, prop) == getattr(ref, prop)
    assert (ours.grid_size, ours.fv_channels, ours.patch_dim) == (8, 20, 2500)


@pytest.mark.parametrize("net", NETS)
def test_load_checkpoint_leaves_equal_npz(net):
    tree, step, metadata = load_checkpoint(net)
    with open(net + ".json") as f:
        meta = json.load(f)
    assert step == meta["step"] and metadata == meta["metadata"]
    with np.load(net + ".npz") as data:
        for i, path in enumerate(meta["paths"]):
            node = tree
            for key in path.split("/"):
                node = node[int(key)] if isinstance(node, list) else node[key]
            np.testing.assert_array_equal(node, data[f"leaf_{i:05d}"])


@pytest.mark.parametrize("net", NETS)
def test_load_dpdist_checkpoint_matches_jax_restore(net):
    cfg, params, _ = load_dpdist_checkpoint(net)
    jcfg, jparams, _ = jax_load(net)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ours = params["decoder"]["layers"]
    ref = jparams["decoder"]["layers"]
    assert len(ours) == len(ref) == 4
    for lo, lr in zip(ours, ref):
        for key in ("w", "b"):
            np.testing.assert_array_equal(lo[key], np.asarray(lr[key]))
    assert ours[0]["w"].shape == (2503, 1024)     # JAX (in, out) layout kept


def test_params_from_jax_reproduces_mlp_apply(rng):
    """JAX-initialised params at small width, carried across, give JAX's
    mlp_apply output (1e-5: float32 sums in another order)."""
    jparams, jstate = jax_mlp_init(jax.random.PRNGKey(3), 11, (16, 16, 3))
    x = rng.normal(size=(2, 7, 11)).astype(np.float32)
    want, _ = jax_mlp_apply(jparams, jstate, jnp.asarray(x))
    tparams = params_from_jax({"decoder": jax.device_get(jparams)}, "cpu")
    got = mlp_apply(tparams["decoder"], torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
