"""DPDist model: init, forward and learned distance (port of init_dpdist,
apply_dpdist, resolve_for_grad, _output_activation and dpdist_distance
from dpdist_tpu/models/dpdist.py).

Forward semantics (the canonical config: 3DmFV encoder, k > 0,
conv_version 1, BN off, float32):
  1. Encode each cloud into a (B, V, 20) Fisher-vector volume.
  2. For each query point of the other cloud: its voxel, the k^3 patch
     around that voxel and its offset to the cell centre, giving the
     decoder input x = [delta, patch], (B, N, 3 + k^3*20).
  3. The MLP decoder, relu6(x)/3 on the output, and outside-grid query
     points zeroed by the membership mask.
pred_AB scores the points of B against the surface encoded from A.

`cfg.fused_gather` picks how steps 1-2 run, and `route` says which
kernels that takes for given cloud sizes, along the reference's dispatch
(dpdist_tpu/models/dpdist.py:400-432, :243-266, and
dpdist_tpu/ops/threedmfv.py:111-113):
  "off"   the plain composition: threedmfv -> extract_patches ->
          voxel_assign -> gather -> concat, per direction, on every
          device (the reference's _fused_gather_mode has no case for
          "off" and resolves it as "auto" on its accelerator);
  "table" per cloud, the 3DmFV encode: the streaming kernel
          (kernels/threedmfv.py) for clouds of >= 128 points, the plain
          encode below; per direction, the decoder input: the
          table-gather kernel table_gather_x for <= 128 queries, else
          voxel_assign + the patch-only gather table_gather + a concat of
          delta (kernels/table_gather.py); backwards run the adjoint kernel
          and the encode's replay;
  "mfv"   the fused encode + gather kernel (kernels/mfv_gather.py) when
          both clouds hold <= 128 points, once over the 2B stack (encode
          [A; B], query [B; A]) for clouds of one size; "table" otherwise;
  "full"  the reference's bf16 serving kernel; in float32 it runs "table",
          as the reference resolves it;
  "auto"  "mfv" on CUDA tensors, "off" on the CPU. Computations that are
          differentiated resolve "auto" with `resolve_for_grad` instead.
Configs this port does not cover yet raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x
from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_x
from dpdist_tpu_torch.nn.layers import mlp_apply, mlp_init
from dpdist_tpu_torch.ops.threedmfv import KERNEL_MIN_POINTS, threedmfv
from dpdist_tpu_torch.ops.voxel import extract_patches, gather_patches, voxel_assign

# Clouds up to this size take the fused mfv kernel, and queries up to this
# size the table_gather_x kernel: one TPU query tile
# (dpdist_tpu/models/dpdist.py:400, :258).
MAX_TILE_POINTS = 128


def check_ported(cfg: DPDistConfig) -> None:
    """Raise NotImplementedError naming the first part of `cfg` that this
    port does not cover yet."""
    missing = []
    if cfg.encoder != "3dmfv":
        missing.append(f"encoder={cfg.encoder!r} (the pointnet encoder)")
    if cfg.dims != 3:
        missing.append(f"dims={cfg.dims}")
    if cfg.k <= 0:
        missing.append(f"k={cfg.k} (the global embedding)")
    if not cfg.full_fv:
        missing.append("full_fv=False (the 7-channel encode)")
    if cfg.conv_version != 1:
        missing.append(f"conv_version={cfg.conv_version}")
    if cfg.use_bn:
        missing.append("use_bn=True (BatchNorm)")
    if cfg.dtype != "float32":
        missing.append(f"dtype={cfg.dtype!r}")
    if cfg.fused_gather == "on":
        missing.append(f"fused_gather={cfg.fused_gather!r}")
    elif cfg.fused_gather not in ("auto", "mfv", "table", "full", "off"):
        raise ValueError(f"unknown fused_gather={cfg.fused_gather!r}")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


@dataclasses.dataclass(frozen=True)
class Route:
    """The kernels one bidirectional forward runs: `encode` per cloud
    (pcA, pcB), `gather` per direction (AB: B's points against surface(A);
    BA), each a kernel's counter name ("mfv_gather_x", "threedmfv",
    "table_gather_x", "table_gather") or "plain". Under "mfv" the fused
    kernel does both steps."""

    mode: str
    encode: tuple
    gather: tuple


def route(cfg: DPDistConfig, device_type: str, n_a: int, n_b: int, grad: bool = False) -> Route:
    """The kernels apply_dpdist runs for clouds of n_a and n_b points on a
    `device_type` device; grad=True for a computation that will be
    differentiated (it resolves "auto" as `resolve_for_grad` does).

    The reference's conditions: "mfv" only when both clouds hold <= 128
    points, else the table branch for both directions; there, each cloud's
    encode takes the kernel at >= 128 points, and each direction's gather
    takes table_gather_x at <= 128 queries, else table_gather."""
    check_ported(cfg)
    if grad:
        cfg = resolve_for_grad(cfg, device_type)
    mode = cfg.fused_gather
    if mode == "auto":
        mode = "mfv" if device_type == "cuda" else "off"
    elif mode == "full":
        # The fused serving kernel is bf16 only, and check_ported refuses
        # bf16; in float32 the reference runs "table"
        # (dpdist_tpu/models/dpdist.py:293-297).
        mode = "table"
    if mode == "mfv" and max(n_a, n_b) <= MAX_TILE_POINTS:
        return Route("mfv", ("mfv_gather_x",) * 2, ("mfv_gather_x",) * 2)
    if mode == "off":
        return Route("off", ("plain",) * 2, ("plain",) * 2)
    encode = tuple("threedmfv" if n >= KERNEL_MIN_POINTS else "plain" for n in (n_a, n_b))
    # AB queries B's points, BA queries A's.
    gather = tuple("table_gather_x" if n <= MAX_TILE_POINTS else "table_gather"
                   for n in (n_b, n_a))
    return Route("table", encode, gather)


def resolve_for_grad(cfg: DPDistConfig, device) -> DPDistConfig:
    """Resolve fused_gather="auto" for a computation that will be
    differentiated (training, the frozen loss): "table" on CUDA, as the
    reference resolves it on its accelerator; unchanged on the CPU, where
    "auto" already takes the plain composition. Explicit settings stay.

    Why "table" and not "mfv" there: the mfv kernel serves both directions
    in one opaque call, so a loss that reads one direction still pays for
    two, and its backward must replay the 3DmFV encode, which the kernel
    never saves (dpdist_tpu/models/dpdist.py:315-326).
    """
    if cfg.fused_gather != "auto" or torch.device(device).type != "cuda":
        return cfg
    return dataclasses.replace(cfg, fused_gather="table")


def init_dpdist(cfg: DPDistConfig, generator=None, device="cuda") -> dict:
    """Decoder parameters {"decoder": {"layers": [{"w", "b"}, ...]}} for
    the canonical MLP decoder (port of init_dpdist, conv_version 1, BN off):
    TF xavier-uniform with the reference's conv fans on the first layer,
    zero biases, and +0.45 on the output bias when output_act is "relu"
    (the head then starts mid-range, out of relu6's dead zone)."""
    check_ported(cfg)
    dev = resolve_device(device)
    in_dim = cfg.patch_dim + cfg.dims
    widths = tuple(cfg.mlp) + (cfg.output_channels,)
    # The reference's first layer was a [1, E+D] conv over one channel.
    dec = mlp_init(in_dim, widths, conv_fan_first=(in_dim, in_dim * widths[0]),
                   generator=generator)
    if cfg.output_act == "relu":
        dec["layers"][-1]["b"] = dec["layers"][-1]["b"] + 0.45
    layers = [{key: t.to(dev) for key, t in lp.items()} for lp in dec["layers"]]
    return {"decoder": {"layers": layers}}


def _output_activation(x: torch.Tensor, output_act: str) -> torch.Tensor:
    if output_act == "tanh":
        return torch.tanh(x)
    if output_act == "relu":
        # relu6(x)/3 -> range [0, 2]
        return torch.clamp(x, 0.0, 6.0) / 3.0
    # (-1, 1) centered variant
    return torch.clamp(x + 3.0, 0.0, 6.0) / 3.0 - 1.0


def _head(params, cfg: DPDistConfig, x, mask):
    """Decoder, output activation and the membership mask."""
    return _output_activation(mlp_apply(params["decoder"], x), cfg.output_act) * mask[..., None]


def _decoder_input(cfg: DPDistConfig, encode: str, gather: str, points_enc, queries, vox,
                   delta):
    """x = [delta, patch] of `queries` against the surface of `points_enc`,
    by the kernels `route` names (vox and delta: voxel_assign(queries))."""
    args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
    if gather == "mfv_gather_x":
        return mfv_x(points_enc, queries, *args)[0]
    impl = "kernel" if encode == "threedmfv" else "plain"
    fv = threedmfv(points_enc, cfg.embedding_size, cfg.sigma, impl=impl)
    if gather == "table_gather_x":
        return table_gather_x(fv, queries, cfg.grid_size, cfg.k)[0]
    if gather == "table_gather":
        patches = table_gather(fv, vox, cfg.grid_size, cfg.k)
    else:
        patches = gather_patches(extract_patches(fv, cfg.grid_size, cfg.k), vox)
    return torch.cat([delta, patches], dim=-1)


def _prep(points):
    return points.to(torch.float32).contiguous()


def _direction(params, cfg, encode, gather, points_enc, queries):
    vox, mask, delta = voxel_assign(queries, cfg.grid_size)
    x = _decoder_input(cfg, encode, gather, points_enc, queries, vox, delta)
    return _head(params, cfg, x, mask)


def apply_direction(params, cfg: DPDistConfig, points_enc, queries):
    """One direction: the (B, N, output_channels) prediction for the points
    of `queries` against the surface encoded from `points_enc`, masked
    outside the grid, by the kernels `route` names for it. apply_dpdist is
    two of these (or one mfv call); a loss that reads one direction calls
    this alone, since eager PyTorch does not drop an unused direction the
    way XLA does."""
    points_enc, queries = _prep(points_enc), _prep(queries)
    r = route(cfg, queries.device.type, points_enc.shape[1], queries.shape[1])
    return _direction(params, cfg, r.encode[0], r.gather[0], points_enc, queries)


def apply_dpdist(params, cfg: DPDistConfig, pcA, pcB, *, noise=None, train: bool = False):
    """Bidirectional forward: (pred_AB, pred_BA), each (B, N, output_channels).

    `params` is the port's decoder state (init_dpdist or
    train.params_from_jax). `noise`, if given, is added to the encoder's
    copy of pcA only; the queries stay exact (the reference's pcA_noise).
    `train` selects nothing with BN off, the only decoder this port has.
    """
    del train  # BN off: training and inference forwards are the same
    pcA, pcB = _prep(pcA), _prep(pcB)
    pcA_enc = pcA if noise is None else _prep(pcA + noise)
    r = route(cfg, pcA.device.type, pcA.shape[1], pcB.shape[1])
    if r.mode == "mfv" and pcA.shape == pcB.shape:
        # Both directions in one kernel call: encode [A; B], query [B; A].
        args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
        x2 = mfv_x(torch.cat([pcA_enc, pcB]), torch.cat([pcB, pcA]), *args)[0]
        _, maskAB, _ = voxel_assign(pcB, cfg.grid_size)
        _, maskBA, _ = voxel_assign(pcA, cfg.grid_size)
        pred = _head(params, cfg, x2, torch.cat([maskAB, maskBA]))
        pred_AB, pred_BA = torch.chunk(pred, 2, dim=0)
        return pred_AB, pred_BA
    # BN off: each decoder row is independent, so the directions decode
    # separately.
    return (_direction(params, cfg, r.encode[0], r.gather[0], pcA_enc, pcB),  # B vs surface(A)
            _direction(params, cfg, r.encode[1], r.gather[1], pcB, pcA))      # A vs surface(B)


def dpdist_distance(params, cfg: DPDistConfig, pcA, pcB, *,
                    per_example: bool = False):
    """(mean(pred_AB[..., 0]) + mean(pred_BA[..., 0])) / 2, over the batch
    or, with per_example=True, per pair as a (B,) tensor. Differentiable
    in pcA and pcB; detach the parameters at the call site for a frozen
    loss (losses/dpdist_loss.py)."""
    pred_AB, pred_BA = apply_dpdist(params, cfg, pcA, pcB)
    if per_example:
        return (torch.mean(pred_AB[..., 0], dim=-1) + torch.mean(pred_BA[..., 0], dim=-1)) / 2.0
    return (torch.mean(pred_AB[..., 0]) + torch.mean(pred_BA[..., 0])) / 2.0
