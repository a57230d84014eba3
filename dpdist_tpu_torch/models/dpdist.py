"""DPDist model: init, forward and learned distance (port of init_dpdist,
apply_dpdist, resolve_for_grad, _output_activation and dpdist_distance
from dpdist_tpu/models/dpdist.py).

Forward semantics (the canonical config: 3DmFV encoder, k > 0,
conv_version 1, BN off, float32 or bfloat16):
  1. Encode each cloud into a (B, V, 20) Fisher-vector volume.
  2. For each query point of the other cloud: its voxel, the k^3 patch
     around that voxel and its offset to the cell centre, giving the
     decoder input x = [delta, patch], (B, N, 3 + k^3*20).
  3. The MLP decoder, relu6(x)/3 on the output, and outside-grid query
     points zeroed by the membership mask.
pred_AB scores the points of B against the surface encoded from A. With
dtype="bfloat16" the volume is taken in bfloat16 before the gather and the
decoder input is bfloat16 (the gather kernels write it so), the decoder
runs in bfloat16 with float32 accumulation, and its output returns to
float32 before the activation (dpdist_tpu/models/dpdist.py:421-484). Its
gradients pass the same rounding points backwards, as the VJPs of the
reference's casts do: the bf16 adjoint of the gather (summed in float32,
rounded once) gives dfv in bfloat16, returned to the float32 volume
exactly; the bf16 decoder's gradients return through the casts to the
float32 parameters (cuBLAS bf16 products, summed in float32).
fused_gather="full" has no gradient outside training: under autograd it
raises, as the reference's jax.grad through its fused kernel does.

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
  "on"    per cloud the encode as "table"; per direction voxel_assign + the
          per-query gather with the mask (kernels/gather_fused.py) + a
          concat of delta; its backward is the adjoint kernel on the masked
          gradient;
  "full"  in bfloat16, outside training: per cloud the encode as
          "table", then the fused gather + whole-decoder kernel
          (kernels/fused_forward.py) once over the 2B stack (volumes
          [A; B], queries [B; A]), for clouds of one size, forward only
          (under autograd it raises); in training and in float32 "table",
          as the reference resolves it;
  "auto"  "mfv" on CUDA tensors, "off" on the CPU. Computations that are
          differentiated resolve "auto" with `resolve_for_grad` instead.
`route` also holds each kernel to its limits (grid, window, decoder widths,
shared memory; the kernel modules' *_fits functions), from shapes before
any launch: "mfv" and "full" give way to "table" where their fused kernel
does not take the config (at embedding_size=1000, say, or a hidden width
that is not a multiple of 16), and an encode or a gather kernel that does
not take it gives way to the plain op for that step. The reference has no
such limits, and the fallbacks compute the same function.
Configs this port does not cover yet raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.fused_forward import fused_forward, fused_forward_fits, pack_decoder
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_fits
from dpdist_tpu_torch.kernels.table_gather import table_gather, table_gather_fits, table_gather_x
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_fits
from dpdist_tpu_torch.nn.layers import mlp_apply, mlp_init
from dpdist_tpu_torch.ops.threedmfv import KERNEL_MIN_POINTS, threedmfv
from dpdist_tpu_torch.ops.voxel import extract_patches, gather_patches, voxel_assign

# Clouds up to this size take the fused mfv kernel, and queries up to this
# size the table_gather_x kernel: one TPU query tile
# (dpdist_tpu/models/dpdist.py:400, :258).
MAX_TILE_POINTS = 128
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FULL_GRAD = ('fused_gather="full" in bfloat16 has no bf16 gradient outside training: the '
             "reference refuses one (jax.grad through its fused gather + decoder kernel, "
             "which defines no VJP, fails in Pallas' autodiff); differentiate with "
             '"table" or "auto", or pass train=True, which runs "table"')


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
    if cfg.dtype not in DTYPES:
        missing.append(f"dtype={cfg.dtype!r}")
    if cfg.fused_gather not in ("auto", "mfv", "table", "on", "full", "off"):
        raise ValueError(f"unknown fused_gather={cfg.fused_gather!r}")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


@dataclasses.dataclass(frozen=True)
class Route:
    """The kernels one bidirectional forward runs: `encode` per cloud
    (pcA, pcB), `gather` per direction (AB: B's points against surface(A);
    BA), each a kernel's counter name ("mfv_gather_x", "threedmfv",
    "table_gather_x", "table_gather", "gather_patches_fused",
    "fused_forward") or "plain". Under "mfv" the fused kernel does both
    steps; under "full" one fused_forward call serves both directions."""

    mode: str
    encode: tuple
    gather: tuple


def resolve_mode(cfg: DPDistConfig, device_type: str, train: bool = False) -> str:
    """The path a forward of `cfg` takes before the cloud sizes count:
    "auto" is "mfv" on CUDA and "off" on the CPU; "full" is "table" in
    float32, in training (train=True) and for a decoder or grid the fused
    kernel does not take; "mfv" is "table" for a grid or window the fused
    kernel does not take. The others stay."""
    mode = cfg.fused_gather
    if mode == "auto":
        mode = "mfv" if device_type == "cuda" else "off"
    g, k = cfg.grid_size, cfg.k
    if mode == "full" and (cfg.dtype != "bfloat16" or train
                           or not fused_forward_fits(g, k, cfg.mlp)):
        # The fused serving kernel is bf16 and eval only
        # (dpdist_tpu/models/dpdist.py:293-297, :375).
        mode = "table"
    elif mode == "mfv" and not mfv_x_fits(g, k):
        mode = "table"
    return mode


def route(cfg: DPDistConfig, device_type: str, n_a: int, n_b: int, grad: bool = False,
          train: bool = False) -> Route:
    """The kernels apply_dpdist runs for clouds of n_a and n_b points on a
    `device_type` device; grad=True for a computation that will be
    differentiated (it resolves "auto" as `resolve_for_grad` does, and
    raises for bf16 "full" outside training, which has no gradient),
    train=True for a training forward.

    The reference's conditions: "full" only in bfloat16 outside training
    and autograd, for clouds of one size (its 2B concatenation), else
    "table"; "mfv" only when both clouds hold <= 128 points, else the table
    branch for both directions; there, and under "on" and "full", each
    cloud's encode takes the kernel at >= 128 points, and under "table"
    each direction's gather takes table_gather_x at <= 128 queries, else
    table_gather.

    The kernels' limits (each kernel module's *_fits, from shapes alone):
    the fused kernels give way to "table" (`resolve_mode`), and an encode or
    a gather kernel that does not take the config gives way to the plain op
    for that step ("plain"), which computes the same function. The same
    routes on either device, apart from "auto"."""
    check_ported(cfg)
    if grad:
        _check_full_grad(cfg, train)
        cfg = resolve_for_grad(cfg, device_type)
    mode = resolve_mode(cfg, device_type, train)
    if mode == "mfv" and max(n_a, n_b) <= MAX_TILE_POINTS:
        return Route("mfv", ("mfv_gather_x",) * 2, ("mfv_gather_x",) * 2)
    if mode == "off":
        return Route("off", ("plain",) * 2, ("plain",) * 2)
    encode_fits = threedmfv_fits(cfg.embedding_size)
    encode = tuple("threedmfv" if n >= KERNEL_MIN_POINTS and encode_fits else "plain"
                   for n in (n_a, n_b))
    if mode == "full":
        if n_a != n_b:
            raise ValueError(f'fused_gather="full" serves both directions in one call over '
                             f"the 2B stack, which needs clouds of one size; got {n_a} and "
                             f"{n_b} points")
        return Route("full", encode, ("fused_forward",) * 2)
    gather_fits = table_gather_fits(cfg.grid_size, cfg.k, cfg.fv_channels)
    if mode == "on":
        return Route("on", encode, ("gather_patches_fused" if gather_fits else "plain",) * 2)
    # AB queries B's points, BA queries A's.
    gather = tuple(("table_gather_x" if n <= MAX_TILE_POINTS else "table_gather")
                   if gather_fits else "plain" for n in (n_b, n_a))
    return Route("table", encode, gather)


def resolve_for_grad(cfg: DPDistConfig, device) -> DPDistConfig:
    """Resolve fused_gather="auto" for a computation that will be
    differentiated (training, the frozen loss): "table" on CUDA, as the
    reference resolves it on its accelerator, in float32 and in bfloat16;
    unchanged on the CPU, where "auto" already takes the plain composition.
    Explicit settings stay.

    Why "table" and not "mfv" there: the mfv kernel serves both directions
    in one opaque call, so a loss that reads one direction still pays for
    two, and its backward must replay the 3DmFV encode, which the kernel
    never saves (dpdist_tpu/models/dpdist.py:315-326).
    """
    if cfg.fused_gather != "auto" or torch.device(device).type != "cuda":
        return cfg
    return dataclasses.replace(cfg, fused_gather="table")


def _check_full_grad(cfg: DPDistConfig, train: bool) -> None:
    """Raise NotImplementedError for bf16 "full" outside training, which
    the reference resolves to its fused kernel whatever the widths
    (dpdist_tpu/models/dpdist.py:293-297), and which has no gradient."""
    if cfg.fused_gather == "full" and cfg.dtype == "bfloat16" and not train:
        raise NotImplementedError(FULL_GRAD)


def _check_grad(cfg: DPDistConfig, params, train: bool, *inputs) -> None:
    """check_ported, and under autograd (an input or a parameter that
    needs a gradient) _check_full_grad."""
    check_ported(cfg)
    if not torch.is_grad_enabled():
        return
    leaves = [t for lp in params["decoder"]["layers"] for t in lp.values()]
    if any(t is not None and t.requires_grad for t in list(inputs) + leaves):
        _check_full_grad(cfg, train)


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


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip's function and gradient: min(max(x, lo), hi), whose
    gradient at x == lo or x == hi is half the incoming one, as JAX splits
    a tie of max or min (torch.clamp passes all of it). A bfloat16 decoder
    output lands exactly on 0 often enough for this to show. The bounds
    are filled on x's device (new_tensor would copy them from the host and
    wait for the stream)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _output_activation(x: torch.Tensor, output_act: str) -> torch.Tensor:
    if output_act == "tanh":
        return torch.tanh(x)
    if output_act == "relu":
        # relu6(x)/3 -> range [0, 2]
        return _clip(x, 0.0, 6.0) / 3.0
    # (-1, 1) centered variant
    return _clip(x + 3.0, 0.0, 6.0) / 3.0 - 1.0


def _head(params, cfg: DPDistConfig, x, mask):
    """Decoder (in cfg.dtype, back to float32), output activation and the
    membership mask."""
    y = mlp_apply(params["decoder"], x, DTYPES[cfg.dtype]).to(torch.float32)
    return _output_activation(y, cfg.output_act) * mask[..., None]


def _fused_head(params, cfg: DPDistConfig, fv, queries):
    """The "full" route's decoder: fused_forward over the bfloat16 volumes
    `fv` and their `queries`, then the output activation and the mask.
    Takes the packed decoder from params["packed"] where the caller holds
    one (serving.FrozenDistance), else packs it for this call."""
    vox, mask, delta = voxel_assign(queries, cfg.grid_size)
    packed = params.get("packed") or pack_decoder(params["decoder"]["layers"])
    y = fused_forward(fv.to(torch.bfloat16), vox, delta, packed, cfg.grid_size, cfg.k)
    return _output_activation(y, cfg.output_act) * mask[..., None]


def _encode(cfg: DPDistConfig, encode: str, points):
    impl = "kernel" if encode == "threedmfv" else "plain"
    return threedmfv(points, cfg.embedding_size, cfg.sigma, impl=impl)


def _decoder_input(cfg: DPDistConfig, encode: str, gather: str, points_enc, queries, vox, mask,
                   delta):
    """x = [delta, patch] of `queries` against the surface of `points_enc`,
    by the kernels `route` names (vox, mask and delta: voxel_assign(queries)).
    For a bf16 config every gather takes the volume in bfloat16, as the
    reference casts fv before its gather: the table-gather kernels and the
    plain composition write x in bfloat16, the per-query gather writes the
    rounded values in float32 (as the reference's kernel does) and leaves
    x's rounding to the decoder."""
    dtype = DTYPES[cfg.dtype]
    args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
    if gather == "mfv_gather_x":
        return mfv_x(points_enc, queries, *args, dtype=dtype)[0]
    fv = _encode(cfg, encode, points_enc)
    if gather == "table_gather_x":
        return table_gather_x(fv, queries, cfg.grid_size, cfg.k, dtype=dtype)[0]
    if gather == "table_gather":
        patches = table_gather(fv, vox, cfg.grid_size, cfg.k, dtype=dtype)
        delta = delta.to(dtype)
    elif gather == "gather_patches_fused":
        patches = gather_patches_fused(fv, vox, mask, cfg.grid_size, cfg.k, dtype=dtype)
    else:
        patches = gather_patches(extract_patches(fv.to(dtype), cfg.grid_size, cfg.k), vox)
        delta = delta.to(dtype)
    return torch.cat([delta, patches], dim=-1)


def _prep(points):
    return points.to(torch.float32).contiguous()


def _direction(params, cfg, encode, gather, points_enc, queries):
    if gather == "fused_forward":
        return _fused_head(params, cfg, _encode(cfg, encode, points_enc), queries)
    vox, mask, delta = voxel_assign(queries, cfg.grid_size)
    x = _decoder_input(cfg, encode, gather, points_enc, queries, vox, mask, delta)
    return _head(params, cfg, x, mask)


def apply_direction(params, cfg: DPDistConfig, points_enc, queries, *, train: bool = False):
    """One direction: the (B, N, output_channels) prediction for the points
    of `queries` against the surface encoded from `points_enc`, masked
    outside the grid, by the kernels `route` names for it. apply_dpdist is
    two of these (or one mfv call); a loss that reads one direction calls
    this alone, since eager PyTorch does not drop an unused direction the
    way XLA does. `train` as in apply_dpdist."""
    points_enc, queries = _prep(points_enc), _prep(queries)
    _check_grad(cfg, params, train, points_enc, queries)
    r = route(cfg, queries.device.type, points_enc.shape[1], queries.shape[1], train=train)
    return _direction(params, cfg, r.encode[0], r.gather[0], points_enc, queries)


def apply_dpdist(params, cfg: DPDistConfig, pcA, pcB, *, noise=None, train: bool = False):
    """Bidirectional forward: (pred_AB, pred_BA), each (B, N, output_channels).

    `params` is the port's decoder state (init_dpdist or
    train.params_from_jax). `noise`, if given, is added to the encoder's
    copy of pcA only; the queries stay exact (the reference's pcA_noise).
    `train=True` keeps a bf16 fused_gather="full" config off the eval-only
    fused kernel (it runs "table"); with BN off, the only decoder this port
    has, it changes nothing else. Under autograd, bf16 "full" with
    train=False raises (the reference refuses its gradient).
    """
    pcA, pcB = _prep(pcA), _prep(pcB)
    _check_grad(cfg, params, train, pcA, pcB, noise)
    pcA_enc = pcA if noise is None else _prep(pcA + noise)
    r = route(cfg, pcA.device.type, pcA.shape[1], pcB.shape[1], train=train)
    if r.mode == "full":
        # Both directions in one kernel call: volumes [A; B], queries [B; A].
        fv2 = torch.cat([_encode(cfg, r.encode[0], pcA_enc), _encode(cfg, r.encode[1], pcB)])
        pred = _fused_head(params, cfg, fv2, torch.cat([pcB, pcA]))
        pred_AB, pred_BA = torch.chunk(pred, 2, dim=0)
        return pred_AB, pred_BA
    if r.mode == "mfv" and pcA.shape == pcB.shape:
        # Both directions in one kernel call: encode [A; B], query [B; A].
        args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
        x2 = mfv_x(torch.cat([pcA_enc, pcB]), torch.cat([pcB, pcA]), *args,
                   dtype=DTYPES[cfg.dtype])[0]
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
