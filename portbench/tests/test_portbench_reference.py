"""The plain references against the port's CPU eager path at small sizes,
on the committed net's weights and on seeded AUE weights."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.core.traffic import pair_pool
from portbench.core.weights import initial_leaves, nest, read_checkpoint
from portbench.reference import aue_3dmfv_dpdist as aue_ref
from portbench.reference import dpdist_3dmfv_k5 as ref

ROOT = Path(__file__).resolve().parents[2]
DPDIST = json.loads((ROOT / "portbench/configs/dpdist_3dmfv_k5.json").read_text())
AUE = json.loads((ROOT / "portbench/configs/aue_3dmfv_dpdist.json").read_text())
TRAFFIC = json.loads((ROOT / "portbench/traffic/serve_b256_np64.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def arrays():
    return read_checkpoint(str(ROOT / DPDIST["checkpoint"]))


def _pairs(n, seed, batch=3):
    spec = dict(TRAFFIC, num_point=n, batch=batch, pool_batches=1)
    a, b = pair_pool(spec, seed)
    return torch.as_tensor(a[0]), torch.as_tensor(b[0])


@pytest.mark.parametrize("n", [64, 200])
def test_distances_match_the_port(arrays, n):
    from dpdist_tpu_torch.serving import FrozenDistance

    from portbench.core.pairs import dpdist_config

    a, b = _pairs(n, 5 + n)
    a[0, 0] = torch.tensor([1.2, 0.0, 0.0])            # one query off the grid
    params = nest(arrays, torch.as_tensor)
    got = FrozenDistance(dpdist_config(DPDIST), params, None).eval()(a, b)
    net = ref.Net(DPDIST, arrays, CPU)
    with ref.Arith("float32", CPU) as arith:
        want = net.distances(arith, a, b)
    assert got.shape == want.shape == (3,)
    assert float((got - want).abs().max()) < 2e-6


def test_frozen_loss_and_source_gradient_match_the_port(arrays):
    from dpdist_tpu_torch.losses.dpdist_loss import make_frozen_dpdist_loss

    from portbench.core.pairs import dpdist_config

    a, b = _pairs(64, 9)
    b = b * 1.02                                          # a few points past the grid's edge
    loss_fn = make_frozen_dpdist_loss(nest(arrays, torch.as_tensor), dpdist_config(DPDIST))
    src = b.clone().requires_grad_(True)
    got = loss_fn(a, src)
    (g_got,) = torch.autograd.grad(got, src)
    net = ref.Net(DPDIST, arrays, CPU)
    src = b.clone().requires_grad_(True)
    with ref.Arith("float32", CPU) as arith:
        want = net.frozen_loss(arith, a, src, 1.0)
    (g_want,) = torch.autograd.grad(want, src)
    assert abs(float(got.detach()) - float(want.detach())) < 1e-6
    assert float((g_got - g_want).norm() / g_want.norm()) < 1e-4


def test_aue_forward_matches_the_port():
    from dpdist_tpu_torch.configs import AUEConfig
    from dpdist_tpu_torch.models.aue import apply_aue, init_aue
    from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths

    cfg = dict(AUE, n_gaussians=8, fv_channels=20)
    pshapes, sshapes = aue_ref.leaf_shapes(cfg)
    acfg = AUEConfig(num_point=cfg["num_point"], encoder="3dmfv", n_gaussians=cfg["n_gaussians"])
    params, state = init_aue(acfg, torch.Generator().manual_seed(0), "cpu")
    leaves = dict(tree_flatten_with_paths(params))
    assert {p: tuple(v.shape) for p, v in leaves.items()} == pshapes
    assert {p: tuple(v.shape) for p, v in tree_flatten_with_paths(state)} == sshapes
    mine = initial_leaves(pshapes, 123, CPU)
    with torch.no_grad():
        for p, v in mine.items():
            leaves[p].copy_(v + 0.01 * (p.rsplit("/", 1)[-1] in ("b", "offset")))
    x1 = torch.as_tensor(pair_pool(dict(TRAFFIC, batch=4, pool_batches=1, rotate="none",
                                        source_angle_deg=0), 4)[0][0])
    rec, new_state = apply_aue(params, state, acfg, x1, train=True)
    rp = {p: v.detach().clone() for p, v in leaves.items()}
    rs = initial_leaves(sshapes, 0, CPU)
    with ref.Arith("float32", CPU) as arith:
        want, want_state = aue_ref.forward(cfg, arith, rp, rs, x1)
    assert float((rec - want).abs().max()) < 1e-5
    for p, v in tree_flatten_with_paths(new_state):
        assert float((v - want_state[p]).abs().max()) < 1e-5, p


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.0e-20])
    got = ref.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0, 3.0e-20])
    assert torch.equal(got[:5], want[:5])
    assert abs(float(got[5]) / 3.0e-20 - 1) < 2 ** -10
    assert np.all(ref.tf32_round(torch.randn(1000)).view(torch.int32).numpy() & 0x1FFF == 0)
