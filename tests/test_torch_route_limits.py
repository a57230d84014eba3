"""The model's routing (models.dpdist.route) against the kernels' limits:
a config the reference serves never reaches a kernel that does not take it.
The fused kernels give way to "table", an encode or a gather kernel to the
plain op for that step; the routes of configs that fit stay as they were
(tests/test_torch_large_clouds.py, test_torch_fused_forward.py,
test_torch_gather_fused.py). The committed nets' decoder served at 1,000
Gaussians is held against dpdist_tpu on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpdist_tpu.cli.train_aue import load_dpdist_checkpoint as jax_load
from dpdist_tpu.models import dpdist_distance as jax_distance

import dpdist_tpu_torch.serving as serving
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.fused_forward import (
    MAX_GRID,
    decoder_unfit,
    fused_forward_batch_fits,
    fused_forward_fits,
    pack_decoder,
)
from dpdist_tpu_torch.kernels.mfv_gather import MAX_GAUSSIANS, mfv_x_fits
from dpdist_tpu_torch.kernels.table_gather import (
    MAX_SMEM,
    bwd_bf16_smem,
    bwd_f32_smem,
    gather_smem,
    table_gather_bwd_fits,
    table_gather_fits,
)
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_fits, threedmfv_kernel
from dpdist_tpu_torch.models import init_dpdist
from dpdist_tpu_torch.models import dpdist as model_dpdist
from dpdist_tpu_torch.models.dpdist import Route, resolve_mode, route
from dpdist_tpu_torch.serving import load_frozen_distance
from dpdist_tpu_torch.train.checkpoint import params_to_numpy, save_checkpoint

NETS = ("results/ckpt_best", "results/dpdist_multi_r4_ckpt_best")
TOL = 1e-4   # port vs dpdist_tpu on the CPU (tests/test_torch_dpdist.py's)
P2 = ("plain",) * 2
X2 = ("table_gather_x",) * 2


def test_the_committed_config_fits_every_kernel():
    cfg = DPDistConfig()
    g, k = cfg.grid_size, cfg.k
    assert mfv_x_fits(g, k) and threedmfv_fits(cfg.embedding_size)
    assert table_gather_fits(g, k, cfg.fv_channels)
    assert fused_forward_fits(g, k, cfg.mlp)


@pytest.mark.parametrize("fused_gather,dtype,grad", [
    ("auto", "float32", False),
    ("auto", "float32", True),
    ("auto", "bfloat16", False),
    ("mfv", "float32", False),
    ("mfv", "float32", True),
    ("mfv", "bfloat16", False),
])
def test_route_at_1000_gaussians_is_not_mfv(fused_gather, dtype, grad):
    """G = 1,000 exceeds the fused mfv kernel's 992: the table path, with
    the plain encode below 128 points and table_gather_x."""
    cfg = DPDistConfig(embedding_size=1000, fused_gather=fused_gather, dtype=dtype)
    assert cfg.embedding_size > MAX_GAUSSIANS
    assert route(cfg, "cuda", 64, 64, grad=grad) == Route("table", P2, X2)


@pytest.mark.parametrize("over", [
    {"mlp": (40, 40, 40)},                 # not a multiple of 16
    {"mlp": (1040, 1040, 1040)},           # wider than 1,024
    {"mlp": (64,) * 9},                    # more than 8 hidden layers
    {"k": 7},                              # the window's tables overflow shared memory
    {"embedding_size": (MAX_GRID + 1) ** 3, "k": 3},   # a grid past the int16 table
])
def test_route_full_gives_way_to_table(over):
    cfg = DPDistConfig(fused_gather="full", dtype="bfloat16", **over)
    assert not fused_forward_fits(cfg.grid_size, cfg.k, cfg.mlp)
    assert resolve_mode(cfg, "cuda") == "table"
    for device in ("cuda", "cpu"):
        r = route(cfg, device, 64, 64)
        assert r.mode == "table" and "fused_forward" not in r.gather
    # Clouds of two sizes are no error off the "full" path.
    assert route(cfg, "cuda", 64, 100).mode == "table"


def test_decoder_unfit_names_the_limit():
    assert decoder_unfit((1024, 1024, 1024)) is None
    assert "multiples of 16" in decoder_unfit((40, 40, 40))
    assert "up to 1024" in decoder_unfit((1040,))
    assert "1 to 8 hidden layers" in decoder_unfit((64,) * 9)
    assert "1 to 8 hidden layers" in decoder_unfit(())


@pytest.mark.parametrize("embedding_size,n,fused_gather,want", [
    # g = 11: the encode kernel takes at most 1,024 Gaussians.
    (1331, 300, "auto", Route("table", P2, ("table_gather",) * 2)),
    (1331, 64, "auto", Route("table", P2, X2)),
    # g = 15: the volume no longer fits a block's shared memory.
    (3375, 300, "auto", Route("table", P2, P2)),
    (3375, 64, "table", Route("table", P2, P2)),
    (3375, 300, "on", Route("on", P2, P2)),
    (3375, 64, "full", Route("full", P2, ("fused_forward",) * 2)),
])
def test_route_takes_the_plain_op_where_a_kernel_does_not_fit(embedding_size, n, fused_gather,
                                                              want):
    dtype = "bfloat16" if fused_gather == "full" else "float32"
    cfg = DPDistConfig(embedding_size=embedding_size, fused_gather=fused_gather, dtype=dtype)
    assert route(cfg, "cuda", n, n) == want
    assert route(cfg, "cpu", n, n) == want or fused_gather == "auto"


def test_wrappers_called_directly_still_raise():
    """The route's limits do not loosen the wrappers: beyond them they raise
    as before, on the CPU where their checks run there."""
    with pytest.raises(ValueError, match="multiples of 16"):
        pack_decoder([{"w": torch.zeros(2503, 40), "b": torch.zeros(40)},
                      {"w": torch.zeros(40, 3), "b": torch.zeros(3)}])
    with pytest.raises(ValueError, match="at most 1024"):
        threedmfv_kernel(torch.zeros(1, 4, 3), 1331)


# Fault 5: the limits that depend on N or B. Row 9 addresses the 2B
# volumes and the 2B * N query rows with 32-bit offsets
# (csrc/fused_forward.cu): at G * C = 10,240 the volumes bind up to
# 2B = 209,714 clouds; at N = 20,000 the rows bind first.
FULL_BF16 = DPDistConfig(fused_gather="full", dtype="bfloat16")
F2 = ("fused_forward",) * 2


@pytest.mark.parametrize("n,largest", [(64, 104_857), (20_000, 53_687)])
def test_route_full_gives_way_past_row_9_batch_limit(n, largest):
    g, C = FULL_BF16.grid_size, FULL_BF16.fv_channels
    assert fused_forward_batch_fits(2 * largest, n, g, C)
    assert not fused_forward_batch_fits(2 * (largest + 1), n, g, C)
    fits = route(FULL_BF16, "cuda", n, n, batch=largest)
    assert (fits.mode, fits.gather) == ("full", F2)
    over = route(FULL_BF16, "cuda", n, n, batch=largest + 1)
    assert over.mode == "table" and "fused_forward" not in over.gather
    # A symbolic batch (an export's) is bounded by the export instead.
    assert route(FULL_BF16, "cuda", n, n).mode == "full"


@pytest.mark.parametrize("fused_gather", ["auto", "table"])
@pytest.mark.parametrize("grad", [False, True])
def test_route_keeps_row_6_for_two_million_queries(fused_gather, grad):
    """128^3 = 2,097,152 queries a cloud (distance_field(resolution=128))
    take row 6, now that it strides past the grid's 65,535 y-blocks, and its
    adjoint (row 3) no longer bounds N: no direction gives way."""
    cfg = DPDistConfig(fused_gather=fused_gather)
    r = route(cfg, "cuda", 1024, 128 ** 3, grad=grad)
    assert r == Route("table", ("threedmfv",) * 2, ("table_gather", "table_gather"))
    assert route(cfg, "cuda", 64, 128 ** 3, grad=grad).gather == ("table_gather",
                                                                   "table_gather_x")


# The persistent gathers (rows 2, 6 and 10, csrc/row_groups.cuh:plan_rows)
# take a volume wherever their smallest layout fits a block: one volume
# buffer and a run's 128 row descriptions of 20 B, each rounded up to 128
# bytes, and two mbarriers; tests/test_torch_kernels_gpu.py holds
# gather_smem to the C entry and the C entry to this limit on the card.
@pytest.mark.parametrize("g,C,want", [
    (8, 20, 43536),     # the committed config: 40,960 B of volume
    (8, 7, 16912),
    (2, 1, 2704),       # fault 5's window: a 32-byte volume in 128
    (14, 20, 222096),
])
def test_gather_smem(g, C, want):
    """The smallest layout's bytes, whatever the window."""
    assert gather_smem(g, 1, C) == gather_smem(g, 5, C) == want


def test_table_gather_fits_where_the_smallest_layout_fits():
    """At g = 8, 112 channels fit (231,952 B) and 113 do not (234,000 B);
    the old mirror, the volume and the window's offset tables, took 113 at
    k = 5 (232,424 B), where the plan finds no layout."""
    assert gather_smem(8, 5, 112) == 231952 <= MAX_SMEM < gather_smem(8, 5, 113) == 234000
    assert table_gather_fits(8, 5, 112) and not table_gather_fits(8, 5, 113)
    assert 4 * (8 ** 3 * 113 + 2 * 5 ** 3) <= MAX_SMEM
    # g = 14 at C = 20 is the largest grid of the reference's channel count.
    assert table_gather_fits(14, 5, 20) and not table_gather_fits(15, 5, 20)


# Row 3's adjoint (csrc/table_gather.cu) stages grad runs of k^2 * C
# elements in shared memory: its limits from shapes, which route reads for
# a gradient (tests/test_torch_kernels_gpu.py holds bwd_bf16_smem to the C
# entry's plan on the card).
@pytest.mark.parametrize("k,C,runs,want", [
    (5, 20, 8, 36176),    # the main path: 8 runs a stage of 1,056-byte slots
    (5, 7, 8, 15696),
    (7, 20, 8, 66896),
    (1, 1, 8, 4432),
    (5, 20, 1, 6384),
])
def test_bwd_bf16_smem(k, C, runs, want):
    """The bf16 ring's bytes: 4 stages of `runs` slots of the run's
    16-byte-aligned span and 12 elements past it, each with its 8-byte
    (vy, vz, lead) pair, 8 barriers, 4 headers and 4 vox chunks of 512 B;
    every such layout fits a block."""
    assert bwd_bf16_smem(k, C, runs) == want <= MAX_SMEM


def test_bwd_bf16_fits_while_one_run_a_stage_fits():
    """The bf16 adjoint takes a window while one run a stage fits shared
    memory (its C entry then takes fewer runs a stage), whatever g, and not
    one channel more."""
    C = next(c for c in range(1, 10 ** 5) if bwd_bf16_smem(33, c, 1) > MAX_SMEM)
    assert bwd_bf16_smem(33, C - 1, 8) > MAX_SMEM >= bwd_bf16_smem(33, C - 1, 1)
    for g in (16, 255):
        assert table_gather_bwd_fits(g, 33, C - 1, torch.bfloat16)
        assert not table_gather_bwd_fits(g, 33, C, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_table_gather_bwd_fits(dtype):
    """The committed config fits; so do g = 1 and 255; g = 256 (digits of
    a byte), an even k, k past 2g + 1 and a run of the ring past shared
    memory do not. The float32 kernel's run is twice the bytes."""
    cfg = DPDistConfig()
    assert table_gather_bwd_fits(cfg.grid_size, cfg.k, cfg.fv_channels, dtype)
    assert table_gather_bwd_fits(1, 3, 20, dtype) and table_gather_bwd_fits(255, 5, 20, dtype)
    for g, k, C in ((256, 5, 20), (8, 4, 20), (8, 19, 20), (16, 33, 2000)):
        assert not table_gather_bwd_fits(g, k, C, dtype)
    # k^2 C = 16,200: past the float32 ring's 4 runs of 64 KB, within bf16's.
    assert table_gather_bwd_fits(16, 9, 200, torch.bfloat16)
    assert not table_gather_bwd_fits(16, 9, 200, torch.float32)
    assert bwd_f32_smem(16, 9, 200) > MAX_SMEM >= bwd_bf16_smem(9, 200, 1)


@pytest.mark.parametrize("fused_gather", ["auto", "table", "mfv", "on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_gives_way_where_the_adjoint_does_not_fit(monkeypatch, fused_gather, dtype):
    """Under grad=True every gather kernel runs row 3 in the config's dtype
    behind it: where that adjoint does not take the config, the gathers
    give way to the plain op ("mfv" first to the table path); forwards
    without a gradient keep their kernels. No config of the reference's
    channel counts (20, 7) meets this before the gathers' own limits, so
    the adjoint's is patched to fail for the config's dtype only."""
    cfg = DPDistConfig(fused_gather=fused_gather, dtype=dtype)
    unfit = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    monkeypatch.setattr(model_dpdist, "table_gather_bwd_fits",
                        lambda g, k, C, dt: dt != unfit)
    grad = route(cfg, "cuda", 64, 64, grad=True)
    assert grad.gather == P2 and grad.mode != "mfv"
    assert route(cfg, "cuda", 64, 64).gather != P2
    monkeypatch.setattr(model_dpdist, "table_gather_bwd_fits", lambda g, k, C, dt: dt == unfit)
    assert route(cfg, "cuda", 64, 64, grad=True).gather != P2


def test_forward_hands_route_its_batch(monkeypatch):
    """forward_dpdist and apply_direction pass the batch of their clouds to
    route, so row 9's batch limit is held before any launch."""
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("batch"))
        return route(*args, **kw)

    monkeypatch.setattr(model_dpdist, "route", spy)
    cfg = DPDistConfig(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
    params, state = init_dpdist(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    a, b = (torch.as_tensor(c[:, :16]) for c in _clouds(5))
    with torch.no_grad():
        model_dpdist.forward_dpdist(params, state, cfg, a, b)
        model_dpdist.apply_direction(params, cfg, a, b, state=state)
    assert seen == [3, 3]


def _clouds(seed, B=3, n=64):
    r = np.random.default_rng(seed)
    return (r.uniform(-0.9, 0.9, (B, n, 3)).astype(np.float32),
            r.uniform(-1.1, 1.1, (B, n, 3)).astype(np.float32))


@pytest.fixture(scope="module", params=NETS)
def net(request):
    return request.param, jax_load(request.param)


@pytest.mark.parametrize("fused_gather", ["auto", "mfv", "on"])
def test_committed_decoder_at_1000_gaussians_matches_jax(net, fused_gather):
    """The committed nets' decoder takes 3 + k^3 * 20 inputs whatever the
    grid, so it serves at embedding_size=1000 too. On the CPU, "auto" runs
    the plain composition and "mfv" the route the card takes at this size
    (the table path, whose wrappers run their plain versions here); both
    against JAX's dpdist_distance."""
    path, (cfg, params, state) = net
    pcA, pcB = _clouds(1000)
    want = jax_distance(params, state, cfg.replace(embedding_size=1000), jnp.asarray(pcA),
                        jnp.asarray(pcB), per_example=True)
    model = load_frozen_distance(path, device="cpu", embedding_size=1000,
                                 fused_gather=fused_gather)
    assert route(model.cfg, "cuda", 64, 64).mode == ("on" if fused_gather == "on" else "table")
    with torch.no_grad():
        got = model(torch.as_tensor(pcA), torch.as_tensor(pcB))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_unfit_full_decoder_loads_and_serves_through_table(tmp_path, monkeypatch):
    """A bf16 "full" net whose decoder the fused kernel does not take loads
    without packing and serves what "table" serves; the committed net under
    "full" still packs."""
    cfg = DPDistConfig(mlp=(40, 40, 40))
    params, _ = init_dpdist(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "ckpt_40")
    save_checkpoint(path, {"params": params_to_numpy(params), "state": {"decoder": {}}},
                    metadata={"model_config": cfg.to_json()})

    def refuse(_layers):
        raise AssertionError("pack_decoder called for a decoder the route does not serve")

    monkeypatch.setattr(serving, "pack_decoder", refuse)
    model = load_frozen_distance(path, device="cpu", dtype="bfloat16", fused_gather="full")
    table = load_frozen_distance(path, device="cpu", dtype="bfloat16", fused_gather="table")
    assert model.packed is None and "packed" not in model.params()
    tA, tB = (torch.as_tensor(a) for a in _clouds(40))
    with torch.no_grad():
        got, want = model(tA, tB), table(tA, tB)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    monkeypatch.undo()
    full = load_frozen_distance(NETS[0], device="cpu", dtype="bfloat16", fused_gather="full")
    assert full.packed is not None
