"""The port's data parallelism (dpdist_tpu_torch/parallel) against
dpdist_tpu's, on the CPU: the port at world size 2 over gloo against the
JAX package's make_mesh(data=2) trainers on its 8-device virtual CPU mesh,
from the JAX init carried across, for the three trainers; against the
port's own single-process steps on the whole batch; and the mesh, the
shard and process helpers.

The two processes start once for the file (the `runs` fixture): they run
every scenario of the port side and save their results; JAX runs its side
in this process meanwhile. The workers import the port only (this module
imports JAX inside its fixtures and tests), take one torch thread each and
meet through a file store under tmp_path.

Tolerances (the bounds the single-device counterparts hold):
  - a data-parallel DPDist step against the single-process step on the
    whole batch (BN off): losses rtol 2e-3, atol 1e-5, the JAX package's
    own bound (tests/test_train.py:71);
  - against JAX's data=2 trainers, the golden train steps' (TOL_STEPS in
    tests/test_torch_variants.py): the first loss 1e-4 relative, later
    losses 5e-3, the BN state (relative to the larger of 1 and a leaf's
    largest entry) 4e-6 after the first step and 5e-3 after the third;
    params after Adam steps within 2 lr per step (a bias-corrected Adam
    step moves a weight by at most lr, the first by lr * sign(g), so the
    other way where g is rounding-sized) and within 1e-6 on all but 1 % of
    the weights after the first step, but for the biases that feed a BN
    (tests/test_torch_aue.py's ZERO_GRAD: the batch mean removes their
    gradient, which is rounding);
  - the PCRNet step (momentum SGD at lr 1 under grad_clip, so the first
    step is the clipped averaged gradient): tests/test_torch_pcrnet_
    trainer.py's REL_GRAD_DPDIST 2e-3 of each leaf's largest entry, the
    loss 1e-5; the later losses within 5e-3;
  - the AUE step (Adam, lr 1e-3, "ours"): tests/test_torch_aue.py's
    TOL_TRAIN_LOSS, its "ours" gradient-norm bound TOL_LATER_STEPS (the
    frozen loss's input gradient jumps where a reconstruction point moves
    by rounding) and its bound for the later losses, TOL_LATER_STEPS.
Through the frozen DPDist loss the later steps' gradients are not held:
its input gradient jumps (the output clip at 0, cell edges), and the
single-device port parts from JAX by 7.6 % of the PCRNet params' movement
after three of these steps (measured on the CPU, momentum SGD at lr 1)
where the first step agrees within 7.3e-5; the gradient norms of the AUE's
later steps part by up to 25 % for the same reason.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dpdist_tpu_torch.configs import AUEConfig, DPDistConfig, PCRNetConfig, TrainConfig
from dpdist_tpu_torch.data.golden import aue_batch, dpdist_train_batch
from dpdist_tpu_torch.data.registration import RegistrationDataset
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    process_shard,
    replicate,
    shard_batch,
)
from dpdist_tpu_torch.train import load_dpdist_checkpoint, params_from_jax
from dpdist_tpu_torch.train.aue_trainer import AUETrainer
from dpdist_tpu_torch.train.checkpoint import tree_flatten_with_paths
from dpdist_tpu_torch.train.logging import NullLogger, RunLogger
from dpdist_tpu_torch.train.pcrnet_trainer import PCRNetTrainer
from dpdist_tpu_torch.train.trainer import DPDistTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = os.path.join(ROOT, "results", "ckpt_best")
WORLD, STEPS, JOIN_TIMEOUT_S = 2, 3, 240

DPDIST = dict(num_point=16, embedding_size=64, k=3, mlp=(64, 64, 64))
SCENARIOS = {
    # DPDist without BN, with the encoder-noise draws (made over the global
    # batch before sharding).
    "dpdist": dict(cfg=DPDIST, train=dict(batch_size=8, learning_rate=3e-4, augment=False,
                                          add_noise=0.02)),
    "dpdist_bn": dict(cfg={**DPDIST, "use_bn": True},
                      train=dict(batch_size=8, learning_rate=3e-4, augment=False)),
    "pcrnet": dict(cfg=dict(num_point=32, out_features=32, head_widths=(32, 16), max_loops=3),
                   train=dict(batch_size=4, optimizer="momentum", learning_rate=1.0,
                              momentum=0.9, grad_clip=0.05),
                   kw=dict(loss_type="dpdist", fp_reg=0.2, fp_steps=2)),
    "aue": dict(cfg=dict(num_point=16, encoder="pn"),
                train=dict(batch_size=8, learning_rate=1e-3), kw=dict(opt_type="ours")),
}
TOL_SINGLE = dict(rtol=2e-3, atol=1e-5)
TOL_FIRST, TOL_LATER, TOL_STATE_FIRST, TOL_STATE = 1e-4, 5e-3, 4e-6, 5e-3
TOL_LOSS, REL_GRAD_DPDIST = 1e-5, 2e-3
TOL_TRAIN_LOSS, TOL_LATER_STEPS, TOL_AUE_STATE = 5e-5, 5e-2, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree):
    return {p: np.array(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)
            for p, t in tree_flatten_with_paths(tree)}


def _batches(name):
    """The global batches of a scenario's STEPS steps (the same for every
    process, as every process of a run builds them)."""
    if name.startswith("dpdist"):
        data, labels = dpdist_train_batch({"seed": 3, "batch_size": 8, "num_point": 16})
        return [(data, labels)] * STEPS
    if name == "pcrnet":
        ds = RegistrationDataset(num_point=32, n_templates=4, families=("chair", "box"), seed=7,
                                 max_rotate_deg=30.0)
        return [ds.sample_batch(4, noise_prob=0.5)[:3] for _ in range(STEPS)]
    return [(aue_batch({"families": ["chair", "box", "sphere", "torus"], "seed0": 900 + s,
                        "scale": 0.8, "batch_size": 8, "num_point": 16}),)
            for s in range(STEPS)]


def _trainer(name, init, mesh, run_dir, logger=False):
    """The port's trainer of a scenario on `mesh` (None: one device), from
    the carried-across init (None: the trainer's own seeded init);
    logger=False gives a silent RunLogger, None the trainer's own choice."""
    spec = SCENARIOS[name]
    tcfg = TrainConfig(**spec["train"])
    log = RunLogger(run_dir, echo=False) if logger is False else logger
    if name.startswith("dpdist"):
        tr = DPDistTrainer(DPDistConfig(**spec["cfg"]), tcfg, run_dir=run_dir, mesh=mesh,
                           logger=log, device="cpu")
        if init is None:
            return tr
        tr._set_params(params_from_jax(init["params"], "cpu"))
        tr.state = params_to_device(init["state"], "cpu")
    elif name == "pcrnet":
        tr = PCRNetTrainer(PCRNetConfig(**spec["cfg"]), tcfg, dpdist=load_dpdist_checkpoint(NET),
                           run_dir=run_dir, mesh=mesh, logger=log, device="cpu", **spec["kw"])
        if init is None:
            return tr
        tr.params = params_to_device(init["params"], "cpu", requires_grad=True)
    else:
        dcfg, dparams, _ = load_dpdist_checkpoint(NET)
        tr = AUETrainer(AUEConfig(**spec["cfg"]), tcfg, dcfg, dparams, run_dir=run_dir,
                        mesh=mesh, logger=log, device="cpu", **spec["kw"])
        if init is None:
            return tr
        tr.params = params_from_jax(init["params"], "cpu", model="aue")
        for _, t in tree_flatten_with_paths(tr.params):
            t.requires_grad_(True)
        tr.state = params_from_jax(init["state"], "cpu", model="aue")
    tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def _steps(tr, batches):
    """Per step the loss and gradient norm, and the params and state after
    the first step and after the last."""
    out = {"loss": [], "grad_norm": []}
    for i, batch in enumerate(batches):
        m = tr.train_step(*batch)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i in (0, len(batches) - 1):
            key = "first" if i == 0 else "last"
            out[f"params_{key}"], out[f"state_{key}"] = flat(tr.params), flat(tr.state)
    return out


def _worker(rank, store, inits, out_dir):
    """One process of the port's side: every scenario at world size 2, the
    checks that need a group, and a checkpoint written on rank 0 and
    restored everywhere; results pickled to out_dir/rank<r>.pkl."""
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{store}", WORLD, rank, device="cpu")
    try:
        mesh = make_mesh(data=WORLD, device="cpu")
        res = {"mesh": (mesh.shape, mesh.index("data"), mesh.index("points"))}
        for name in SCENARIOS:
            tr = _trainer(name, inits[name], mesh, os.path.join(out_dir, f"{name}_{rank}"))
            res[name] = _steps(tr, _batches(name))
        # A checkpoint of the BN trainer: rank 0 writes, rank 1 restores.
        run = os.path.join(out_dir, "ckpt_run")
        tr = _trainer("dpdist_bn", inits["dpdist_bn"], mesh, run, logger=None)
        tr.train_step(*_batches("dpdist_bn")[0])
        path = tr.save(tag="dp")
        fresh = _trainer("dpdist_bn", inits["dpdist_bn"], mesh, run, logger=None)
        fresh.restore(path)
        res["ckpt"] = {"saved": flat({"params": tr.params, "state": tr.state}),
                       "restored": flat({"params": fresh.params, "state": fresh.state}),
                       "null_logger": isinstance(tr.logger, NullLogger)}
        # The params start from rank 0's whatever the seed of each process.
        seeded = DPDistTrainer(DPDistConfig(**DPDIST), TrainConfig(batch_size=8, seed=rank),
                               run_dir=run, mesh=mesh, logger=NullLogger(), device="cpu")
        res["replicated"] = flat(seeded.params)
        own = {"w": torch.full((3,), float(rank)), "b": [torch.arange(2.0) + rank]}
        res["replicate"] = flat(replicate(own, mesh))
        res["shard"] = shard_batch({"x": np.arange(8), "y": (torch.arange(8.0), None)}, mesh)
        errors = {}
        for what, fn in (("mesh", lambda: make_mesh(data=3, device="cpu")),
                         ("batch", lambda: DPDistTrainer(
                             DPDistConfig(**DPDIST), TrainConfig(batch_size=7), mesh=mesh,
                             logger=NullLogger(), device="cpu"))):
            try:
                fn()
            except ValueError as e:
                errors[what] = str(e)
        res["errors"] = errors
        res["process_shard"] = process_shard(list(range(7)))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _jax_trainer(name, tmp):
    """JAX's trainer of a scenario on make_mesh(data=2)."""
    import jax  # noqa: F401

    from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load_dpdist
    from dpdist_tpu.configs import AUEConfig as JaxAUEConfig
    from dpdist_tpu.configs import DPDistConfig as JaxDPDistConfig
    from dpdist_tpu.configs import PCRNetConfig as JaxPCRNetConfig
    from dpdist_tpu.configs import TrainConfig as JaxTrainConfig
    from dpdist_tpu.parallel import make_mesh as jax_make_mesh
    from dpdist_tpu.train import AUETrainer as JaxAUE
    from dpdist_tpu.train import DPDistTrainer as JaxDPDist
    from dpdist_tpu.train import PCRNetTrainer as JaxPCRNet
    from dpdist_tpu.train.logging import RunLogger as JaxRunLogger

    spec = SCENARIOS[name]
    tcfg = JaxTrainConfig(**spec["train"])
    common = dict(run_dir=tmp, mesh=jax_make_mesh(data=WORLD),
                  logger=JaxRunLogger(tmp, echo=False))
    if name.startswith("dpdist"):
        return JaxDPDist(JaxDPDistConfig(**spec["cfg"]), tcfg, **common)
    if name == "pcrnet":
        return JaxPCRNet(JaxPCRNetConfig(**spec["cfg"]), tcfg, dpdist=jax_load_dpdist(NET),
                         **common, **spec["kw"])
    return JaxAUE(JaxAUEConfig(**spec["cfg"]), tcfg, *jax_load_dpdist(NET), **common,
                  **spec["kw"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": [rank 0, rank 1], "jax": {...}, "single": {...}, "init":
    {...}}: the port's two processes, JAX's data=2 trainers and the port's
    single-process trainers on the whole batches, from one init."""
    import jax

    tmp = tmp_path_factory.mktemp("parallel")
    t0 = time.perf_counter()
    jtr = {name: _jax_trainer(name, str(tmp / f"jax_{name}")) for name in SCENARIOS}
    inits = {name: {"params": jax.device_get(t.params), "state": jax.device_get(t.state)}
             for name, t in jtr.items()}
    out_dir = tmp / "port"
    out_dir.mkdir()
    ctx = mp.spawn(_worker, args=(str(tmp / "store"), inits, str(out_dir)), nprocs=WORLD,
                   join=False)
    try:
        want = {}
        for name, t in jtr.items():
            out = {"loss": [], "grad_norm": []}
            for i, batch in enumerate(_batches(name)):
                m = t.train_step(*batch)
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                if i in (0, STEPS - 1):
                    key = "first" if i == 0 else "last"
                    out[f"params_{key}"] = flat(jax.device_get(t.params))
                    out[f"state_{key}"] = flat(jax.device_get(t.state))
            want[name] = out
        single = {name: _steps(_trainer(name, inits[name], None, str(tmp / f"one_{name}")),
                               _batches(name))
                  for name in ("dpdist", "dpdist_bn")}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the port's processes did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    port = []
    for r in range(WORLD):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    print(f"test_torch_parallel: both sides in {time.perf_counter() - t0:.1f} s")
    return {"port": port, "jax": want, "single": single, "init": inits}


def _feeds_bn(path, paths):
    """A layer's bias whose output goes through a BN (".../layers/i/b"
    beside ".../bn/i/scale")."""
    head, _, leaf = path.rpartition("/")
    part, _, i = head.rpartition("/")
    return (leaf == "b" and part.endswith("layers")
            and f"{part[:-len('layers')]}bn/{i}/scale" in paths)


def _close_params(got, want, lr, steps, first=False):
    """Adam's criterion (module docstring): within 2 lr a step; after the
    first step within 1e-6 on all but 1 % of the weights that do not feed
    a BN."""
    assert list(got) == list(want)
    off = total = 0
    for p in got:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=2 * lr * steps + 1e-6,
                                   err_msg=p)
        if not _feeds_bn(p, got):
            off += int(np.sum(np.abs(got[p] - want[p]) > 1e-6))
            total += got[p].size
    assert not first or off < 0.01 * total, (off, total)


def _close_state(got, want, tol):
    assert list(got) == list(want)
    for p in got:
        np.testing.assert_allclose(got[p], want[p], rtol=0,
                                   atol=tol * max(1.0, float(np.abs(want[p]).max())), err_msg=p)


def _close_losses(got, want):
    assert abs(got[0] - want[0]) <= TOL_FIRST * abs(want[0]), (got, want)
    for g, w in zip(got[1:], want[1:]):
        assert abs(g - w) <= TOL_LATER * abs(w), (got, want)


# ---------------------------------------------------------------------------
# The helpers, in this process (no group)


def test_process_shard_partition():
    """tests/test_e2e.py:24's partition, and process 0 of 1 without a group."""
    items = list(range(10))
    shards = [process_shard(items, process_index=i, process_count=3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert all(len(s) >= 3 for s in shards)
    assert process_shard(items) == items


def test_initialize_distributed_without_torchrun_starts_nothing(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_initialize_distributed_reads_torchrun_environment(monkeypatch):
    """torchrun's variables stand in for the reference's JAX_* ones; the
    backend follows the device; an init_method URL passes through."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29511"),
                       ("WORLD_SIZE", "4"), ("RANK", "2"), ("LOCAL_RANK", "2")):
        monkeypatch.setenv(var, value)
    assert initialize_distributed(device="cpu") is True
    assert initialize_distributed("file:///tmp/store", 2, 1, device="cpu") is True
    assert calls == [("gloo", dict(init_method="tcp://127.0.0.1:29511", world_size=4, rank=2)),
                     ("gloo", dict(init_method="file:///tmp/store", world_size=2, rank=1))]


def test_make_mesh_needs_the_world_size():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "points": 1} and mesh.device_mesh is None
    assert mesh.writes and mesh.index("data") == 0
    for data, points in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="world size 1"):
            make_mesh(data=data, points=points, device="cpu")


def test_dpdist_trainer_needs_the_batch_to_divide(tmp_path):
    two = Mesh({"data": 2, "points": 1}, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        DPDistTrainer(DPDistConfig(**DPDIST), TrainConfig(batch_size=7), mesh=two,
                      logger=NullLogger(), run_dir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_one_by_one_mesh_is_the_single_device_step(name, tmp_path, monkeypatch):
    """A 1 x 1 mesh starts no group and makes no collective, in its steps
    or its save: its steps are those with no mesh, bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("a 1 x 1 mesh reached torch.distributed")

    for fn in ("init_process_group", "all_reduce", "broadcast", "barrier", "all_gather",
               "all_gather_into_tensor"):
        monkeypatch.setattr(dist, fn, refuse)
    one, none = (_trainer(name, None, mesh, str(tmp_path / tag))
                 for tag, mesh in (("one", make_mesh(device="cpu")), ("none", None)))
    for batch in _batches(name)[:2]:
        a, b = one.train_step(*batch), none.train_step(*batch)
        assert torch.equal(a["loss"], b["loss"]) and torch.equal(a["grad_norm"], b["grad_norm"])
    got, want = flat({"params": one.params, "state": one.state}), flat(
        {"params": none.params, "state": none.state})
    assert list(got) == list(want) and all(np.array_equal(got[p], want[p]) for p in got)
    one.save(tag="one")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# World size 2


def test_mesh_shard_and_replicate_at_world_two(runs):
    for r, res in enumerate(runs["port"]):
        assert res["mesh"] == ({"data": 2, "points": 1}, r, 0)
        np.testing.assert_array_equal(res["shard"]["x"], np.arange(4 * r, 4 * r + 4))
        assert res["shard"]["y"][1] is None
        assert torch.equal(res["shard"]["y"][0], torch.arange(4.0 * r, 4.0 * r + 4))
        assert list(res["replicate"]) == ["b/0", "w"]
        np.testing.assert_array_equal(res["replicate"]["b/0"], [0.0, 1.0])
        np.testing.assert_array_equal(res["replicate"]["w"], [0.0, 0.0, 0.0])
        assert "world size 2" in res["errors"]["mesh"]
        assert "not divisible by data axis 2" in res["errors"]["batch"]
        assert res["process_shard"] == list(range(7))[r::2]
    a, b = (res["replicated"] for res in runs["port"])
    assert all(np.array_equal(a[p], b[p]) for p in a)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_params_identical_across_ranks(runs, name):
    a, b = (res[name] for res in runs["port"])
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    for key in ("params_last", "state_last"):
        assert list(a[key]) == list(b[key])
        for p in a[key]:
            np.testing.assert_array_equal(a[key][p], b[key][p], err_msg=f"{key} {p}")


def test_dpdist_matches_the_single_process_step(runs):
    """Without BN the averaged step is the whole batch's step (equal
    shards): tests/test_train.py:71's bound on three steps' losses."""
    got, one = runs["port"][0]["dpdist"], runs["single"]["dpdist"]
    np.testing.assert_allclose(got["loss"], one["loss"], **TOL_SINGLE)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=REL_GRAD_DPDIST)


@pytest.mark.parametrize("name", ["dpdist", "dpdist_bn"])
def test_dpdist_matches_jax_data_parallel(runs, name):
    """Three steps against JAX's DPDistTrainer on make_mesh(data=2): the
    losses, the params, and the BN state (the mean of the processes' EMAs
    of their local batch statistics) after the first step and the third."""
    got, want = runs["port"][0][name], runs["jax"][name]
    lr = SCENARIOS[name]["train"]["learning_rate"]
    _close_losses(got["loss"], want["loss"])
    _close_params(got["params_first"], want["params_first"], lr, 1, first=True)
    _close_params(got["params_last"], want["params_last"], lr, STEPS)
    _close_state(got["state_first"], want["state_first"], TOL_STATE_FIRST)
    _close_state(got["state_last"], want["state_last"], TOL_STATE)


def test_dpdist_bn_is_not_the_whole_batch_step(runs):
    """With BN each process normalises with its own batch statistics, so
    the data-parallel step is not the whole batch's: the first loss and the
    BN state part from the single-process step's by more than the bounds
    that hold them to JAX's (DDP's rank-0 buffers or SyncBatchNorm's global
    statistics would land on the other side)."""
    got, one, want = (runs["port"][0]["dpdist_bn"], runs["single"]["dpdist_bn"],
                      runs["jax"]["dpdist_bn"])
    assert abs(one["loss"][0] - want["loss"][0]) > 10 * TOL_FIRST * abs(want["loss"][0])
    gap = max(float(np.abs(one["state_first"][p] - want["state_first"][p]).max())
              for p in want["state_first"])
    assert gap > 10 * TOL_STATE_FIRST, gap
    assert abs(got["loss"][0] - want["loss"][0]) <= TOL_FIRST * abs(want["loss"][0])


def test_pcrnet_matches_jax_data_parallel(runs):
    """PCRNetTrainer (pointnet, the frozen DPDist loss, fp_reg with the
    pose sharded, grad_clip) against JAX's on make_mesh(data=2): the first
    step is the clipped averaged gradient (momentum SGD at lr 1), held per
    leaf; three steps' losses and the params after them."""
    got, want, init = runs["port"][0]["pcrnet"], runs["jax"]["pcrnet"], runs["init"]["pcrnet"]
    assert got["loss"][0] == pytest.approx(want["loss"][0], rel=TOL_LOSS)
    assert got["grad_norm"][0] == pytest.approx(want["grad_norm"][0], rel=REL_GRAD_DPDIST)
    assert want["grad_norm"][0] > SCENARIOS["pcrnet"]["train"]["grad_clip"]   # clipped
    start = flat(init["params"])
    for p, w in want["params_first"].items():
        step_want, step_got = start[p] - w, start[p] - got["params_first"][p]
        np.testing.assert_allclose(step_got, step_want, rtol=0,
                                   atol=REL_GRAD_DPDIST * np.abs(step_want).max() + 1e-7,
                                   err_msg=p)
    for g, w in zip(got["loss"][1:], want["loss"][1:]):
        assert g == pytest.approx(w, rel=TOL_LATER)
    gap = max(float(np.abs(got["params_last"][p] - w).max() / np.abs(start[p] - w).max())
              for p, w in want["params_last"].items())
    print(f"PCRNet after {STEPS} steps: params part from JAX's by {gap:.2e} of their "
          f"movement; gradient norms {got['grad_norm']} (JAX {want['grad_norm']})")


def test_aue_matches_jax_data_parallel(runs):
    """AUETrainer (the pn AUE with BN, "ours", Adam) against JAX's on
    make_mesh(data=2): one step's loss, gradient norm, params and BN state;
    three steps' losses and params (Adam's bound)."""
    got, want = runs["port"][0]["aue"], runs["jax"]["aue"]
    lr = SCENARIOS["aue"]["train"]["learning_rate"]
    assert got["loss"][0] == pytest.approx(want["loss"][0], rel=TOL_TRAIN_LOSS)
    assert got["grad_norm"][0] == pytest.approx(want["grad_norm"][0], rel=TOL_LATER_STEPS)
    _close_params(got["params_first"], want["params_first"], lr, 1, first=True)
    _close_state(got["state_first"], want["state_first"], TOL_AUE_STATE)
    for g, w in zip(got["loss"][1:], want["loss"][1:]):
        assert g == pytest.approx(w, rel=TOL_LATER_STEPS)
    _close_params(got["params_last"], want["params_last"], lr, STEPS)


def test_checkpoint_written_on_rank_zero_restores_on_rank_one(runs):
    r0, r1 = (res["ckpt"] for res in runs["port"])
    assert not r0["null_logger"] and r1["null_logger"]
    assert list(r1["restored"]) == list(r0["saved"])
    for p, w in r0["saved"].items():
        np.testing.assert_array_equal(r1["restored"][p], w, err_msg=p)
        np.testing.assert_array_equal(r0["restored"][p], w, err_msg=p)
