"""The port's points-sharded dense evaluation (dpdist_tpu_torch/eval/dense.py
with a mesh whose 'points' axis holds 2 processes, over gloo) against the
single-process result and against dpdist_tpu's make_mesh(data=1, points=2)
on its virtual CPU mesh, at the size of tests/test_dense_eval.py (embedding
64 on 4^3, k = 3, mlp (32, 32, 32)), JAX-initialised weights carried
across: the pretransformed path, the route path ("off", a BN net),
distance_field, and the refusal of a points axis that does not divide the
queries.

The two processes start once for the file (the `sharded` fixture), import
the port only, take one torch thread each and meet through a file store
under tmp_path. Every case within tests/test_dense_eval.py's 1e-5.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.eval.dense import dense_point_to_surface, distance_field
from dpdist_tpu_torch.parallel import initialize_distributed, make_mesh
from dpdist_tpu_torch.train import params_from_jax

WORLD, JOIN_TIMEOUT_S, TOL = 2, 180, 1e-5
SMALL = dict(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
NETS = {"canonical": SMALL, "bn": {**SMALL, "use_bn": True}}
# name -> (net, pretransform, queries); "field" is distance_field at R = 8.
CASES = {"pretransformed": ("canonical", "on", 1024), "route": ("canonical", "off", 512),
         "route_bn": ("bn", "off", 512), "auto": ("canonical", "auto", 1024),
         "field": ("canonical", None, 8 ** 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case):
    net, _, n = CASES[case]
    r = np.random.default_rng(len(case))
    return (r.uniform(-0.8, 0.8, (2, 16, 3)).astype(np.float32),
            r.uniform(-0.95, 0.95, (2, n, 3)).astype(np.float32))


def _port(case, nets, mesh):
    """The port's (B, N) distances of a case (a (B, R, R, R) field for
    "field")."""
    net, pre, _ = CASES[case]
    params, state = (params_from_jax(t, "cpu") if t is not None else None for t in nets[net])
    cloud, q = (torch.as_tensor(a) for a in _inputs(case))
    cfg = DPDistConfig(**NETS[net])
    if case == "field":
        return distance_field(params, cfg, cloud, state=state, resolution=8, mesh=mesh).numpy()
    return dense_point_to_surface(params, cfg, cloud, q, state=state, mesh=mesh,
                                  pretransform=pre).numpy()


def _worker(rank, store, nets, out_dir):
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{store}", WORLD, rank, device="cpu")
    try:
        mesh = make_mesh(points=WORLD, device="cpu")
        res = {case: _port(case, nets, mesh) for case in CASES}
        cloud, q = (torch.as_tensor(a) for a in _inputs("route"))
        params = params_from_jax(nets["canonical"][0], "cpu")
        try:
            dense_point_to_surface(params, DPDistConfig(**SMALL), cloud, q[:, :511], mesh=mesh)
        except ValueError as e:
            res["odd"] = str(e)
        res["index"] = mesh.index("points")
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{"port": [rank 0, rank 1], "nets": {...}}: the sharded results of
    every case on both processes, from JAX's init."""
    import jax

    from dpdist_tpu.configs import DPDistConfig as JaxConfig
    from dpdist_tpu.models import init_dpdist as jax_init

    tmp = tmp_path_factory.mktemp("dense_sharded")
    nets = {name: jax.device_get(jax_init(jax.random.PRNGKey(i), JaxConfig(**fields)))
            for i, (name, fields) in enumerate(NETS.items())}
    t0 = time.perf_counter()
    mp.spawn(_worker, args=(str(tmp / "store"), nets, str(tmp)), nprocs=WORLD,
             join=True)
    port = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    print(f"test_torch_dense_sharded: two processes in {time.perf_counter() - t0:.1f} s")
    return {"port": port, "nets": nets}


def _jax(case, nets):
    import jax.numpy as jnp

    from dpdist_tpu.configs import DPDistConfig as JaxConfig
    from dpdist_tpu.eval.dense import dense_point_to_surface as jax_dense
    from dpdist_tpu.eval.dense import distance_field as jax_field
    from dpdist_tpu.parallel import make_mesh as jax_make_mesh

    net, pre, _ = CASES[case]
    params, state = nets[net]
    cloud, q = (jnp.asarray(a) for a in _inputs(case))
    mesh = jax_make_mesh(data=1, points=WORLD)
    cfg = JaxConfig(**NETS[net])
    if case == "field":
        return np.asarray(jax_field(params, state, cfg, cloud, resolution=8, mesh=mesh))
    return np.asarray(jax_dense(params, state, cfg, cloud, q, mesh=mesh, pretransform=pre))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_dense_matches_single_process_and_jax(sharded, case):
    """Both processes hold the whole result, equal to each other; equal to
    the single-process result and to JAX's points-sharded one within TOL."""
    a, b = (res[case] for res in sharded["port"])
    np.testing.assert_array_equal(a, b)
    one = _port(case, sharded["nets"], None)
    assert a.shape == one.shape
    np.testing.assert_allclose(a, one, atol=TOL, rtol=0)
    np.testing.assert_allclose(a, _jax(case, sharded["nets"]), atol=TOL, rtol=0)


def test_points_axis_must_divide_the_queries(sharded):
    assert [res["index"] for res in sharded["port"]] == list(range(WORLD))
    for res in sharded["port"]:
        assert "query axis 511 not divisible by points=2" in res["odd"]
