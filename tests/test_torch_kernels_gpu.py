"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
nothing of JAX, so they also run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from dpdist_tpu_torch.kernels.chamfer import nn_min_sqdist, nn_min_sqdist_plain
from dpdist_tpu_torch.kernels.fused_forward import fused_forward, fused_forward_plain, pack_decoder
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused, gather_patches_fused_plain
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_plain
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd,
    table_gather_bwd_plain,
    table_gather_plain,
    table_gather_x,
    table_gather_x_plain,
)
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_kernel
from dpdist_tpu_torch.ops.threedmfv import threedmfv_plain

# Kernel vs plain version: both form squared distances per dimension and
# differ only in summation order and in the device's exp.
TOL_X = 2e-5
# Adjoint kernel vs autograd of the plain gather, relative to the largest
# |dfv|: the sums run in another order where queries share a voxel, and
# their rounding grows with their size (cell 0 collects every off-grid
# query, more of them at larger N). On the H100 the error read 2.7e-7 of
# the largest entry at B = 256, N = 64 (7.63e-6 of 28.6) and at N = 200
# (1.14e-5 of 42.6).
REL_BWD = 1e-6
# NN-min kernel vs plain: nvcc contracts the per-dimension sum to FMA, so
# the last bits may differ; within TOL_NN_ABS + TOL_NN_REL * |d|.
TOL_NN_ABS, TOL_NN_REL = 1e-6, 1e-5
# Fused forward kernel vs plain, on pre-activation outputs: both sum exact
# bf16 products in float32, in other orders (the tensor cores' float32
# accumulation does not round to nearest at each add), and a hidden
# activation at a bf16 rounding edge may round the other way. On the H100,
# against float64 sums, the plain version strayed by up to 8.7e-3 and the
# kernel by up to 9.8e-3 on a committed net (chip_smoke.py prints both).
TOL_FF = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _edge_inputs(B, M, N, g, seed=0):
    """Clouds with coordinates on cell edges; queries partly off-grid."""
    r = np.random.default_rng(seed)
    edges = (-1.0 + (2.0 / g) * np.arange(g + 1)).astype(np.float32)
    pts = r.uniform(-0.95, 0.95, (B, M, 3)).astype(np.float32)
    pick = r.random(pts.shape) < 0.1
    pts[pick] = r.choice(edges[1:-1], pick.sum())
    q = r.uniform(-1.2, 1.2, (B, N, 3)).astype(np.float32)
    pick = r.random(q.shape) < 0.15
    q[pick] = r.choice(edges, pick.sum())
    return pts, q


@pytest.mark.gpu
@pytest.mark.parametrize("B,M,N,G,g,k,sigma", [
    (512, 64, 64, 512, 8, 5, 0.125),   # the main path: 2B = 512 clouds
    (2, 12, 16, 64, 4, 3, 0.25),       # the JAX kernel test's config
    (3, 61, 200, 512, 8, 5, 0.125),    # ragged M, N above one TPU query tile
])
def test_mfv_x_kernel_matches_plain(cuda, B, M, N, G, g, k, sigma):
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(B, M, N, g))
    before = mfv_x.launches
    x, vox = mfv_x(pts, q, G, sigma, g, k)
    torch.cuda.synchronize()
    assert mfv_x.launches == before + 1
    ref, ref_vox = mfv_x_plain(pts, q, G, sigma, g, k)
    assert x.shape == ref.shape and vox.dtype == torch.int32
    assert torch.equal(vox, ref_vox)
    assert float((x - ref).abs().max()) <= TOL_X


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [
    (256, 64, 8, 5, 20),   # the main path
    (2, 16, 4, 3, 20),     # the JAX kernel test's small config
    (3, 200, 8, 5, 20),    # N not a multiple of the block's 32 rows
])
def test_table_gather_x_kernel_matches_plain(cuda, B, N, g, k, C):
    r = np.random.default_rng(1)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=2)[1], device=cuda)
    before = table_gather_x.launches
    x, vox = table_gather_x(fv, q, g, k)
    torch.cuda.synchronize()
    assert table_gather_x.launches == before + 1
    ref, ref_vox = table_gather_x_plain(fv, q, g, k)
    assert torch.equal(vox, ref_vox)
    assert torch.equal(x, ref)      # a copy plus q - centre: exact


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k", [(256, 64, 8, 5), (2, 16, 4, 3), (3, 200, 8, 5)])
def test_table_gather_bwd_kernel_matches_plain(cuda, B, N, g, k):
    """Gradient on every row, off-grid ones included (they scatter into
    cell 0's neighbourhood); the grad is the strided patch part of x's
    gradient; two runs agree bit for bit (no atomics)."""
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=3)[1], device=cuda)
    _, vox = table_gather_x_plain(torch.zeros(B, g ** 3, 20, device=cuda), q, g, k)
    r = np.random.default_rng(4)
    gx = torch.as_tensor(r.normal(size=(B, N, 3 + k ** 3 * 20)).astype(np.float32), device=cuda)
    grad = gx[..., 3:]
    before = table_gather_bwd.launches
    dfv = table_gather_bwd(vox, grad, g, k)
    dfv2 = table_gather_bwd(vox, grad, g, k)
    torch.cuda.synchronize()
    assert table_gather_bwd.launches == before + 2
    assert torch.equal(dfv, dfv2)
    ref = table_gather_bwd_plain(vox, grad, g, k)
    assert float((dfv - ref).abs().max()) <= REL_BWD * float(ref.abs().max())


@pytest.mark.gpu
def test_mfv_x_backward_matches_plain_composition(cuda):
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(64, 64, 64, 8, seed=5))
    co = torch.as_tensor(np.random.default_rng(6).normal(
        size=(64, 64, 2503)).astype(np.float32), device=cuda)
    grads = []
    for fn in (mfv_x, mfv_x_plain):
        p, qq = pts.clone().requires_grad_(), q.clone().requires_grad_()
        x = fn(p, qq, 512, 0.125, 8, 5)[0]
        grads.append(torch.autograd.grad((x * co).sum(), (p, qq)))
    (dp, dq), (dp_ref, dq_ref) = grads
    assert torch.equal(dq, dq_ref)
    # Relative to the largest entry: the encode's backward runs on fv
    # values that differ by the kernel's 2e-5.
    assert float((dp - dp_ref).abs().max()) <= 1e-3 * float(dp_ref.abs().max())


@pytest.mark.gpu
def test_frozen_loss_launch_counts(cuda):
    """loss_fn(pcA, pcB) differentiated in pcA: two forward launches (one
    per direction) and one adjoint launch (only surface(A) needs dfv)."""
    from dpdist_tpu_torch.configs import DPDistConfig
    from dpdist_tpu_torch.losses import make_frozen_dpdist_loss
    from dpdist_tpu_torch.models import init_dpdist

    cfg = DPDistConfig(num_point=16, embedding_size=64, k=3, mlp=(32, 32, 32))
    params = init_dpdist(cfg, torch.Generator().manual_seed(0), cuda)
    pcA, pcB = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(4, 16, 16, 4, seed=7))
    pcA.requires_grad_(True)
    loss_fn = make_frozen_dpdist_loss(params, cfg)
    counts = (table_gather_x.launches, table_gather_bwd.launches, mfv_x.launches)
    (dA,) = torch.autograd.grad(loss_fn(pcA, pcB), pcA)
    torch.cuda.synchronize()
    got = (table_gather_x.launches - counts[0], table_gather_bwd.launches - counts[1],
           mfv_x.launches - counts[2])
    assert got == (2, 1, 0)
    assert bool(torch.isfinite(dA).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,G,sigma", [
    (4, 256, 512, 0.125),     # the np = 256 path
    (3, 1000, 512, 0.125),    # a ragged last tile
    (2, 130, 64, 0.25),       # a small grid
    (2, 1, 512, 0.125),       # one point
])
def test_threedmfv_kernel_matches_plain(cuda, B, N, G, sigma):
    """With coordinates on cell edges and a few points far outside the grid."""
    pts = _edge_inputs(B, N, 1, 8, seed=8)[0]
    pts[:, : max(1, N // 50)] = np.float32(4.5)
    pts = torch.as_tensor(pts, device=cuda)
    before = threedmfv_kernel.launches
    fv = threedmfv_kernel(pts, G, sigma)
    torch.cuda.synchronize()
    assert threedmfv_kernel.launches == before + 1
    ref = threedmfv_plain(pts, G, sigma)
    assert fv.shape == ref.shape and bool(torch.isfinite(fv).all())
    assert float((fv - ref).abs().max()) <= TOL_X


@pytest.mark.gpu
def test_threedmfv_kernel_backward_replays_the_plain_encode(cuda):
    pts = torch.as_tensor(_edge_inputs(4, 256, 1, 8, seed=9)[0], device=cuda)
    co = torch.as_tensor(np.random.default_rng(10).normal(size=(4, 512, 20)).astype(np.float32),
                         device=cuda)
    grads = []
    for fn in (threedmfv_kernel, threedmfv_plain):
        p = pts.clone().requires_grad_()
        grads.append(torch.autograd.grad((fn(p, 512, 0.125) * co).sum(), p)[0])
    # The replay is the plain encode's own backward: equal.
    assert torch.equal(grads[0], grads[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [(256, 256, 8, 5, 20), (2, 16, 4, 3, 7), (3, 200, 8, 5, 20)])
def test_table_gather_kernel_matches_plain(cuda, B, N, g, k, C):
    """Exact, off-grid queries (vox 0) included."""
    r = np.random.default_rng(11)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=12)[1], device=cuda)
    vox = table_gather_x_plain(torch.zeros(B, g ** 3, C, device=cuda), q, g, k)[1]
    before = table_gather.launches
    out = table_gather(fv, vox, g, k)
    torch.cuda.synchronize()
    assert table_gather.launches == before + 1
    assert torch.equal(out, table_gather_plain(fv, vox, g, k))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M", [(1, 10000, 10000), (2, 1000, 4099), (3, 37, 5), (256, 64, 64)])
def test_nn_min_sqdist_kernel_matches_plain(cuda, B, N, M):
    r = np.random.default_rng(N + M)
    a, p = (torch.as_tensor(r.uniform(-1, 1, (B, n, 3)).astype(np.float32), device=cuda)
            for n in (N, M))
    before = nn_min_sqdist.launches
    d = nn_min_sqdist(a, p)
    torch.cuda.synchronize()
    assert nn_min_sqdist.launches == before + 1
    ref = nn_min_sqdist_plain(a, p)
    assert bool(((d - ref).abs() <= TOL_NN_ABS + TOL_NN_REL * ref.abs()).all())


@pytest.mark.gpu
def test_served_forward_on_large_clouds(cuda):
    """M = N = 5,083 points, where the fused kernel's shared memory used to
    run out: the forward takes the table path, rows 7 and 6, twice each."""
    from dpdist_tpu_torch.serving import load_frozen_distance

    model = load_frozen_distance("results/ckpt_best", device=cuda)
    r = np.random.default_rng(13)
    pcA, pcB = (torch.as_tensor(r.uniform(-0.9, 0.9, (1, 5083, 3)).astype(np.float32),
                                device=cuda) for _ in range(2))
    counts = (threedmfv_kernel.launches, table_gather.launches, mfv_x.launches,
              table_gather_x.launches)
    with torch.no_grad():
        d = model(pcA, pcB)
    torch.cuda.synchronize()
    got = (threedmfv_kernel.launches - counts[0], table_gather.launches - counts[1],
           mfv_x.launches - counts[2], table_gather_x.launches - counts[3])
    assert got == (2, 2, 0, 0)
    assert d.shape == (1,) and bool(torch.isfinite(d).all())


def _decoder_layers(r, in_dim, widths, device):
    """Random decoder layers {"w": (in, out), "b": (out,)} at xavier scale."""
    layers, d = [], in_dim
    for w in widths:
        lim = np.sqrt(6.0 / (d + w))
        layers.append({"w": torch.as_tensor(r.uniform(-lim, lim, (d, w)).astype(np.float32),
                                            device=device),
                       "b": torch.as_tensor(r.normal(0, 0.1, w).astype(np.float32),
                                            device=device)})
        d = w
    return layers


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,widths", [
    (512, 64, 8, 5, (1024, 1024, 1024, 3)),   # the main path: 2B = 512 clouds, np = 64
    (4, 256, 8, 5, (1024, 1024, 1024, 3)),    # np = 256
    (2, 16, 4, 3, (32, 32, 32, 3)),           # the JAX kernel test's small config
    (3, 50, 8, 5, (48, 96, 1)),               # ragged N, other widths and depth
])
def test_fused_forward_kernel_matches_plain(cuda, B, N, g, k, widths):
    """Off-grid queries (vox 0, cell 0's row) included; no NaN or Inf."""
    r = np.random.default_rng(14)
    fv = torch.as_tensor(r.normal(0, 0.3, (B, g ** 3, 20)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=15)[1], device=cuda)
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    vox, _, delta = voxel_assign(q, g)
    packed = pack_decoder(_decoder_layers(r, 3 + k ** 3 * 20, widths, cuda))
    before = fused_forward.launches
    with torch.no_grad():
        y = fused_forward(fv, vox, delta, packed, g, k)
        torch.cuda.synchronize()
        assert fused_forward.launches == before + 1
        ref = fused_forward_plain(fv, vox, delta, packed, g, k)
    assert y.shape == ref.shape == (B, N, widths[-1]) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= TOL_FF


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,g,k,C", [(256, 64, 8, 5, 20), (2, 16, 4, 3, 7), (3, 200, 8, 5, 20)])
def test_gather_fused_kernel_matches_plain(cuda, B, N, g, k, C):
    """Exact, with zero rows for off-grid queries; the backward (the
    adjoint kernel on the masked gradient) against autograd through the
    plain version."""
    from dpdist_tpu_torch.ops.voxel import voxel_assign

    r = np.random.default_rng(16)
    fv = torch.as_tensor(r.normal(size=(B, g ** 3, C)).astype(np.float32), device=cuda)
    q = torch.as_tensor(_edge_inputs(B, 1, N, g, seed=17)[1], device=cuda)
    vox, mask, _ = voxel_assign(q, g)
    assert float(mask.min()) == 0.0
    before = gather_patches_fused.launches
    with torch.no_grad():
        out = gather_patches_fused(fv, vox, mask, g, k)
        torch.cuda.synchronize()
    assert gather_patches_fused.launches == before + 1
    assert torch.equal(out, gather_patches_fused_plain(fv, vox, mask, g, k))
    grad = torch.as_tensor(r.normal(size=out.shape).astype(np.float32), device=cuda)
    dfvs = []
    for fn in (gather_patches_fused, gather_patches_fused_plain):
        f = fv.clone().requires_grad_()
        dfvs.append(torch.autograd.grad(fn(f, vox, mask, g, k), f, grad)[0])
    assert float((dfvs[0] - dfvs[1]).abs().max()) <= REL_BWD * float(dfvs[1].abs().max())


@pytest.mark.gpu
def test_bf16_outputs_are_the_float32_kernels_rounded(cuda):
    """Rows 1, 2 and 6 with a bfloat16 output: the float32 kernel's values
    rounded once (to nearest even), so equal to them rounded."""
    pts, q = (torch.as_tensor(a, device=cuda) for a in _edge_inputs(64, 64, 64, 8, seed=18))
    r = np.random.default_rng(19)
    fv = torch.as_tensor(r.normal(size=(64, 512, 20)).astype(np.float32), device=cuda)
    bf = torch.bfloat16
    with torch.no_grad():
        pairs = [(mfv_x(pts, q, 512, 0.125, 8, 5, dtype=bf)[0], mfv_x(pts, q, 512, 0.125, 8, 5)[0]),
                 (table_gather_x(fv, q, 8, 5, dtype=bf)[0], table_gather_x(fv, q, 8, 5)[0])]
        vox = table_gather_x(fv, q, 8, 5)[1]
        pairs.append((table_gather(fv, vox, 8, 5, dtype=bf), table_gather(fv, vox, 8, 5)))
    for got, f32 in pairs:
        assert got.dtype == bf and torch.equal(got, f32.to(bf))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,np_,want", [
    ("full", 64, {"fused_forward": 1}),
    ("full", 256, {"fused_forward": 1, "threedmfv": 2}),
    ("auto", 64, {"mfv_x": 1}),
    ("auto", 256, {"threedmfv": 2, "table_gather": 2}),
])
def test_served_bf16_launch_counts(cuda, mode, np_, want):
    """bf16 serving from a committed net: the kernels each path launches
    per request, finite distances in [0, 2], and a bf16 input gradient
    refused."""
    from dpdist_tpu_torch.serving import load_frozen_distance

    wrappers = {"fused_forward": fused_forward, "threedmfv": threedmfv_kernel, "mfv_x": mfv_x,
                "table_gather": table_gather, "table_gather_x": table_gather_x,
                "gather_patches_fused": gather_patches_fused}
    model = load_frozen_distance("results/ckpt_best", device=cuda, dtype="bfloat16",
                                 fused_gather=mode)
    r = np.random.default_rng(20)
    pcA, pcB = (torch.as_tensor(r.uniform(-0.9, 0.9, (8, np_, 3)).astype(np.float32),
                                device=cuda) for _ in range(2))
    before = {k: w.launches for k, w in wrappers.items()}
    with torch.no_grad():
        d = model(pcA, pcB)
    torch.cuda.synchronize()
    got = {k: w.launches - before[k] for k, w in wrappers.items()}
    assert got == {k: want.get(k, 0) for k in wrappers}
    assert d.shape == (8,) and bool(torch.isfinite(d).all())
    assert float(d.min()) >= 0.0 and float(d.max()) <= 2.0
    with pytest.raises(NotImplementedError, match="bf16 gradient"):
        model(pcA.clone().requires_grad_(), pcB)
