"""DPDist model: init, embedding, forward and learned distance (port of
init_dpdist, dpdist_embed, apply_dpdist, resolve_for_grad,
_output_activation and dpdist_distance from dpdist_tpu/models/dpdist.py).

Forward semantics (the canonical config: 3DmFV encoder, k > 0,
conv_version 1, BN off, float32, bfloat16 or float16):
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
dtype="float16" takes the same rounding points as bfloat16 on every path
but "full" (the fused serving kernel is bf16 only, so "full" in float16
is "table", as the reference resolves it): the volume in float16 before
the gather, a float16 decoder input and decoder with float32 accumulation
(cuBLAS fp16 products), and the two-byte adjoint in float16. A value past
65,504 rounds to inf in both packages, and a frozen loss's upstream
gradient of 1/(2 B N) a prediction (3.05e-5 at B = 256, N = 64) lies below
float16's smallest normal, so the decoder's backward runs in subnormals,
as JAX's does (neither package scales the loss).

The rest of the model family, as the reference builds it:
  full_fv=False   the 7-channel encode (means only; 5 channels in 2-D).
  use_bn=True     BatchNorm after every decoder layer (and after pointnet
                  layers 2-4): one 2B batch [xAB; xBA] through the decoder,
                  so the batch statistics of a training forward cover both
                  directions (dpdist_tpu/models/dpdist.py:470-475).
  conv_version=3  the 3-D CNN decoder over each query's k^3 patch: conv0 1^3
                  -> two residual pairs of 3^3 convs -> conv3 1^3 -> fc over
                  [16 k^3 features, delta] -> out (:194-210).
  k=0             the global embedding: the flattened (B, C*G) 3DmFV, tiled
                  per query beside the raw query coordinates; no mask.
  encoder="pointnet"  a shared MLP (widths 128, 128, 512,
                  pointnet_embedding) and a max over points: a global
                  embedding as k=0 (k must be 0), run once per cloud, each
                  run with its own batch statistics in training; the
                  state keeps the second run's (pcB's).
  dims=2          2-D clouds: the 3DmFV and the voxel grid in 2-D, k^2
                  SAME-padded patches.
BN state is passed in and returned explicitly (forward_dpdist), as
models/aue.py does; configs without BN have the state {"decoder": {}}
(and {"pointnet": {}} with the pointnet encoder), and their callers may
pass state=None. A bf16 decoder casts its whole tree (BN scale and offset,
conv weights) to bfloat16 while the BN state stays float32, as the
reference does.

`cfg.fused_gather` picks how steps 1-2 run, and `route` says which
kernels that takes for given cloud sizes, along the reference's dispatch
(dpdist_tpu/models/dpdist.py:283-331, :400-432, :243-266, and
dpdist_tpu/ops/threedmfv.py:103-113):
  "off"   the plain composition: threedmfv -> extract_patches ->
          voxel_assign -> gather -> concat, per direction, on every
          device (the reference's _fused_gather_mode has no case for
          "off" and resolves it as "auto" on its accelerator). Configs
          that run no gather kernel (k <= 0, dims != 3, the pointnet
          encoder) take this path whatever fused_gather says, as the
          reference's; their 3DmFV encode then follows threedmfv's own
          dispatch (the streaming kernel for a 3-D full_fv cloud of
          >= 128 points on the card), unless fused_gather is "off";
  "table" per cloud, the 3DmFV encode: the streaming kernel
          (kernels/threedmfv.py) for full_fv clouds of >= 128 points, the
          plain encode otherwise; per direction, the decoder input: the
          table-gather kernel table_gather_x for <= 128 queries, else
          voxel_assign + the patch-only gather table_gather + a concat of
          delta (kernels/table_gather.py); backwards run the adjoint kernel
          and the encode's replay;
  "mfv"   the fused encode + gather kernel (kernels/mfv_gather.py) when
          both clouds hold <= 128 points, once over the 2B stack (encode
          [A; B], query [B; A]) for clouds of one size; "table" otherwise,
          and "table" for full_fv=False, whose encode the kernel does not
          compute;
  "on"    per cloud the encode as "table"; per direction voxel_assign + the
          per-query gather with the mask (kernels/gather_fused.py) + a
          concat of delta; its backward is the adjoint kernel on the masked
          gradient;
  "full"  in bfloat16 (not float16), outside training, for the
          conv_version=1 decoder without BN: per cloud the encode as "table", then the fused
          gather + whole-decoder kernel (kernels/fused_forward.py) once
          over the 2B stack (volumes [A; B], queries [B; A]), for clouds
          of one size, forward only (under autograd it raises); in
          training, in float32 and float16 and for the other decoders
          "table", as the reference resolves it;
  "auto"  "mfv" (full_fv) or "table" on CUDA tensors, "off" on the CPU.
          Computations that are differentiated resolve "auto" with
          `resolve_for_grad` instead.
`route` also holds each kernel to its limits (grid, window, decoder widths,
shared memory; the kernel modules' *_fits functions), from shapes before
any launch: "mfv" and "full" give way to "table" where their fused kernel
does not take the config (at embedding_size=1000, say, or a hidden width
that is not a multiple of 16), and an encode or a gather kernel that does
not take it gives way to the plain op for that step. The reference has no
such limits, and the fallbacks compute the same function.
Configs with a dtype other than float32, bfloat16 or float16 raise
NotImplementedError: the reference's API computes no other.

Under a profiler session each step of a forward opens its span
(train.profiling.span), with what the route chose as its detail:
"dpdist.encode" around each cloud's encode that runs apart (detail
"plain", "threedmfv" or "pointnet"), "dpdist.gather" around a direction's
voxel assignment and gather, or the one mfv_x call over both directions
(the gather's counter name, or "plain"), and "dpdist.decode" around the
decoder and its activation (the route's mode), or the "full" route's
fused gather and decoder ("fused_forward").
"""

from __future__ import annotations

import dataclasses

import torch

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.kernels.fused_forward import (
    fused_forward,
    fused_forward_batch_fits,
    fused_forward_fits,
    pack_decoder,
)
from dpdist_tpu_torch.kernels.gather_fused import gather_patches_fused
from dpdist_tpu_torch.kernels.mfv_gather import mfv_x, mfv_x_fits
from dpdist_tpu_torch.kernels.ops import dispatch, route_device
from dpdist_tpu_torch.kernels.table_gather import (
    table_gather,
    table_gather_bwd_fits,
    table_gather_fits,
    table_gather_x,
)
from dpdist_tpu_torch.kernels.threedmfv import threedmfv_fits
from dpdist_tpu_torch.nn.layers import params_to_device
from dpdist_tpu_torch.nn.layers import (
    batchnorm_apply,
    batchnorm_init,
    conv3d_apply,
    conv3d_init,
    dense_apply,
    dense_init,
    mlp_apply,
    mlp_apply_bn,
    mlp_bn_state,
    mlp_init,
)
from dpdist_tpu_torch.ops.threedmfv import KERNEL_MIN_POINTS, kernel_computes, threedmfv
from dpdist_tpu_torch.ops.voxel import (
    extract_patches,
    extract_patches_2d,
    gather_patches,
    voxel_assign,
)
from dpdist_tpu_torch.train.profiling import span

# Clouds up to this size take the fused mfv kernel, and queries up to this
# size the table_gather_x kernel: one TPU query tile
# (dpdist_tpu/models/dpdist.py:400, :258).
MAX_TILE_POINTS = 128
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
MODES = ("auto", "mfv", "table", "on", "full", "off")
POINTNET_WIDTHS = (128, 128, 512)   # then cfg.pointnet_embedding
CONV3_CHANNELS = 64                 # the conv_version=3 decoder's trunk
CONV3_OUT = 16                      # its last conv's channels per cell
FULL_GRAD = ('fused_gather="full" in bfloat16 has no bf16 gradient outside training: the '
             "reference refuses one (jax.grad through its fused gather + decoder kernel, "
             "which defines no VJP, fails in Pallas' autodiff); differentiate with "
             '"table" or "auto", or pass train=True, which runs "table"')


def check_ported(cfg: DPDistConfig) -> None:
    """Raise NotImplementedError for a dtype other than float32, bfloat16
    and float16, the dtypes the reference computes, and ValueError for an
    unknown fused_gather."""
    if cfg.fused_gather not in MODES:
        raise ValueError(f"unknown fused_gather={cfg.fused_gather!r}")
    if cfg.dtype not in DTYPES:
        raise NotImplementedError(f"dtype={cfg.dtype!r} is not computed: the port, as the "
                                  "reference, takes float32, bfloat16 and float16")


def gathers(cfg: DPDistConfig) -> bool:
    """Whether cfg's forward gathers patches from a 3-D FV volume, the
    configs the gather kernels serve: the 3DmFV encoder, k > 0, dims 3
    (dpdist_tpu/models/dpdist.py:287-288)."""
    return cfg.k > 0 and cfg.dims == 3 and cfg.encoder == "3dmfv"


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
    "off" for a config that gathers no patches from a 3-D volume; "auto" is
    "mfv" (full_fv) or "table" on CUDA and "off" on the CPU; "full" is
    "table" in float32 and float16, in training (train=True), for a decoder other than
    conv_version=1 without BN, and for a decoder or grid the fused kernel
    does not take; "mfv" is "table" for full_fv=False and for a grid or
    window the fused kernel does not take. The others stay."""
    mode = cfg.fused_gather
    if not gathers(cfg):
        return "off"
    if mode == "auto":
        mode = ("mfv" if cfg.full_fv else "table") if device_type == "cuda" else "off"
    g, k = cfg.grid_size, cfg.k
    if mode == "full" and (cfg.dtype != "bfloat16" or train or cfg.conv_version != 1
                           or cfg.use_bn or not fused_forward_fits(g, k, cfg.mlp)):
        # The fused serving kernel is bf16, eval only and the canonical
        # decoder (dpdist_tpu/models/dpdist.py:293-297, :375).
        mode = "table"
    elif mode == "mfv" and (not cfg.full_fv or not mfv_x_fits(g, k)):
        mode = "table"
    return mode


def _encode_route(cfg: DPDistConfig, n: int) -> str:
    """The encode of a cloud of n points: the streaming kernel for an
    encode it computes and takes, at >= 128 points, else the plain one."""
    ok = (cfg.encoder == "3dmfv" and kernel_computes(cfg.dims, cfg.full_fv)
          and threedmfv_fits(cfg.embedding_size))
    return "threedmfv" if ok and n >= KERNEL_MIN_POINTS else "plain"


def route(cfg: DPDistConfig, device_type: str, n_a: int, n_b: int, grad: bool = False,
          train: bool = False, batch=None) -> Route:
    """The kernels apply_dpdist runs for clouds of n_a and n_b points on a
    `device_type` device; grad=True for a computation that will be
    differentiated (it resolves "auto" as `resolve_for_grad` does, and
    raises for bf16 "full" outside training, which has no gradient),
    train=True for a training forward.

    The reference's conditions: no gather kernel for k <= 0, dims != 3 or
    the pointnet encoder, whose 3DmFV encode follows threedmfv's dispatch
    (unless fused_gather is "off", which is plain on every device); "full"
    only in bfloat16 outside training and autograd, for the conv_version=1
    decoder without BN and clouds of one size (its 2B concatenation), else
    "table"; "mfv" only for full_fv and when both clouds hold <= 128
    points, else the table branch for both directions; there, and under
    "on" and "full", each cloud's encode takes the kernel at >= 128 points
    for a full_fv encode, and under "table" each direction's gather takes
    table_gather_x at <= 128 queries, else table_gather.

    The kernels' limits (each kernel module's *_fits, from shapes alone):
    the fused kernels give way to "table" (`resolve_mode`), and an encode or
    a gather kernel that does not take the config gives way to the plain op
    for that step ("plain"), which computes the same function; under
    grad=True so does a gather whose adjoint (row 3, in the config's dtype)
    does not take it, "mfv" giving way first. `batch`, the
    pairs of the call where it is known (an int), is held to the limits
    that depend on it: "full" gives way to "table" where the fused forward
    does not take the 2B stack (fused_forward_batch_fits); None (a symbolic
    batch of an export, which bounds its batch instead) checks none. The
    same routes on either device, apart from "auto"."""
    check_ported(cfg)
    if grad:
        _check_full_grad(cfg, train)
        cfg = resolve_for_grad(cfg, device_type)
    mode = resolve_mode(cfg, device_type, train)
    if mode == "off":
        on_card = device_type == "cuda" and cfg.fused_gather != "off"
        encode = tuple(_encode_route(cfg, n) if on_card else "plain" for n in (n_a, n_b))
        return Route("off", encode, ("plain",) * 2)
    # A gradient runs row 3's adjoint in the forward's dtype behind every
    # gather kernel.
    adjoint_fits = not grad or table_gather_bwd_fits(cfg.grid_size, cfg.k, cfg.fv_channels,
                                                     DTYPES[cfg.dtype])
    if mode == "mfv" and max(n_a, n_b) <= MAX_TILE_POINTS and adjoint_fits:
        return Route("mfv", ("mfv_gather_x",) * 2, ("mfv_gather_x",) * 2)
    encode = tuple(_encode_route(cfg, n) for n in (n_a, n_b))
    if mode == "full":
        if n_a != n_b:
            raise ValueError(f'fused_gather="full" serves both directions in one call over '
                             f"the 2B stack, which needs clouds of one size; got {n_a} and "
                             f"{n_b} points")
        if batch is None or fused_forward_batch_fits(2 * batch, n_a, cfg.grid_size,
                                                     cfg.fv_channels):
            return Route("full", encode, ("fused_forward",) * 2)
        mode = "table"
    gather_fits = table_gather_fits(cfg.grid_size, cfg.k, cfg.fv_channels) and adjoint_fits
    if mode == "on":
        return Route("on", encode, ("gather_patches_fused" if gather_fits else "plain",) * 2)
    # AB queries B's points, BA queries A's.
    gather = tuple(("table_gather_x" if n <= MAX_TILE_POINTS else "table_gather")
                   if gather_fits else "plain" for n in (n_b, n_a))
    return Route("table", encode, gather)


def resolve_for_grad(cfg: DPDistConfig, device) -> DPDistConfig:
    """Resolve fused_gather="auto" for a computation that will be
    differentiated (training, the frozen loss): "table" on CUDA, as the
    reference resolves it on its accelerator, in every dtype;
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
    if (cfg.fused_gather == "full" and cfg.dtype == "bfloat16" and not train
            and gathers(cfg) and cfg.conv_version == 1 and not cfg.use_bn):
        raise NotImplementedError(FULL_GRAD)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _check_grad(cfg: DPDistConfig, params, train: bool, *inputs) -> None:
    """check_ported, and under autograd (an input or a parameter that
    needs a gradient) _check_full_grad."""
    check_ported(cfg)
    if not torch.is_grad_enabled():
        return
    leaves = _leaves({k: v for k, v in params.items() if k != "packed"})
    if any(t is not None and t.requires_grad for t in list(inputs) + leaves):
        _check_full_grad(cfg, train)


def _state(cfg: DPDistConfig, state):
    """The state a forward reads: `state`, or {} where a config has none to
    read (BN off)."""
    if state is not None:
        return state
    if cfg.use_bn:
        raise ValueError("use_bn=True needs its BN state: pass state= (init_dpdist's, "
                         "load_dpdist_checkpoint's or a trainer's)")
    return {}


def init_dpdist(cfg: DPDistConfig, generator=None, device="cuda"):
    """(params, state) for the DPDist model (port of init_dpdist), on
    `device`, drawn from `generator` on the CPU.

    TF xavier-uniform with the reference's fans, zero biases, and +0.45 on
    the output bias when output_act is "relu" (the head then starts
    mid-range, out of relu6's dead zone). params["decoder"]: the MLP
    {"layers": [{"w", "b"}, ...]} (and "bn": [{"scale", "offset"}, ...]
    with use_bn; its first layer's fans those of the reference's [1, E+D]
    conv over one channel, or (in, width) for k=0), or for conv_version=3
    with k > 0 the CNN {"conv0", "res1a", "res1b", "res2a", "res2b",
    "conv3", "fc", "out"}. params["pointnet"] with the pointnet encoder:
    {"layers"} (and "bn" for layers 2-4 with use_bn; its first layer's fans
    those of a [1, D] conv). state: {"decoder": {} or {"bn": [{"mean",
    "var"}, ...]}} and, with the pointnet encoder, {"pointnet": ...}
    alike. The draws differ from JAX's for the same seed."""
    check_ported(cfg)
    dev = resolve_device(device)
    params, state = {}, {}
    if cfg.encoder == "pointnet":
        layers, bn_p, bn_s, d = [], [], [], cfg.dims
        for i, w in enumerate(POINTNET_WIDTHS + (cfg.pointnet_embedding,)):
            layers.append(dense_init(d, w, conv_fan=(d, d * w) if i == 0 else None,
                                     generator=generator))
            if cfg.use_bn and i > 0:   # the reference has bn=False on conv1
                bp, bs = batchnorm_init(w)
                bn_p.append(bp)
                bn_s.append(bs)
            d = w
        params["pointnet"], state["pointnet"] = {"layers": layers}, {}
        if cfg.use_bn:
            params["pointnet"]["bn"], state["pointnet"]["bn"] = bn_p, bn_s
    if cfg.conv_version == 3 and cfg.k > 0:
        C, W = cfg.fv_channels, CONV3_CHANNELS
        dec = {"conv0": conv3d_init(C, W, (1, 1, 1), generator)}
        for name in ("res1a", "res1b", "res2a", "res2b"):
            dec[name] = conv3d_init(W, W, (3, 3, 3), generator)
        dec["conv3"] = conv3d_init(W, CONV3_OUT, (1, 1, 1), generator)
        dec["fc"] = dense_init(CONV3_OUT * cfg.k ** 3 + cfg.dims, cfg.mlp[2], generator=generator)
        dec["out"] = dense_init(cfg.mlp[2], cfg.output_channels, generator=generator)
        head, dec_state = dec["out"], {}
    else:
        in_dim = cfg.patch_dim + cfg.dims
        widths = tuple(cfg.mlp) + (cfg.output_channels,)
        # The reference's first layer was a [1, E+D] conv over one channel.
        fan = (in_dim, in_dim * widths[0]) if cfg.k > 0 else (in_dim, widths[0])
        dec = mlp_init(in_dim, widths, conv_fan_first=fan, use_bn=cfg.use_bn,
                       generator=generator)
        head, dec_state = dec["layers"][-1], (mlp_bn_state(dec) if cfg.use_bn else {})
    if cfg.output_act == "relu":
        head["b"] = head["b"] + 0.45
    params["decoder"], state["decoder"] = dec, dec_state
    return params_to_device(params, dev), params_to_device(state, dev)


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


def _activate(y, cfg: DPDistConfig, mask):
    """The output activation on the float32 decoder output, then the
    membership mask (None for a global embedding, which masks nothing)."""
    pred = _output_activation(y, cfg.output_act)
    return pred if mask is None else pred * mask[..., None]


def _conv3d_decode(dec, cfg: DPDistConfig, x):
    """The conv_version=3 decoder on x = [delta, patch]: each query's patch
    as a (k, k, k, C) volume (extract_patches' offset-major, channel-last
    order) through the CNN, its 16 k^3 features beside delta through fc and
    out (dpdist_tpu/models/dpdist.py:194-210)."""
    TB, N, _ = x.shape
    k, C = cfg.k, cfg.fv_channels
    delta, emb = x[..., :cfg.dims], x[..., cfg.dims:]
    h = torch.relu(conv3d_apply(dec["conv0"], emb.reshape(TB * N, k, k, k, C)))
    for a, b in (("res1a", "res1b"), ("res2a", "res2b")):
        h = h + torch.relu(conv3d_apply(dec[b], torch.relu(conv3d_apply(dec[a], h))))
    h = torch.relu(conv3d_apply(dec["conv3"], h))
    feat = torch.cat([h.reshape(TB, N, -1), delta], dim=-1)
    return dense_apply(dec["out"], torch.relu(dense_apply(dec["fc"], feat)))


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def _decode(params, state, cfg: DPDistConfig, x, *, train: bool = False, bn_momentum=0.9):
    """(the decoder's float32 pre-activation output, its new state). In
    bfloat16 or float16 the whole decoder tree and x are cast to that dtype
    (the BN state stays float32), as the reference's _decode."""
    dtype = DTYPES[cfg.dtype]
    conv = cfg.conv_version == 3 and cfg.k > 0
    if not (conv or cfg.use_bn):
        return mlp_apply(params["decoder"], x, dtype).to(torch.float32), {}
    dec = params["decoder"] if dtype == torch.float32 else _cast_tree(params["decoder"], dtype)
    if conv:
        return _conv3d_decode(dec, cfg, x.to(dtype)).to(torch.float32), {}
    y, new = mlp_apply_bn(dec, state["decoder"], x.to(dtype), train=train, bn_momentum=bn_momentum)
    return y.to(torch.float32), new


def _fused_head(params, cfg: DPDistConfig, fv, queries):
    """The "full" route's decoder: fused_forward over the bfloat16 volumes
    `fv` and their `queries`, then the output activation and the mask.
    Takes the packed decoder from params["packed"] where the caller holds
    one (serving.FrozenDistance), else packs it for this call."""
    vox, mask, delta = voxel_assign(queries, cfg.grid_size)
    packed = params.get("packed") or pack_decoder(params["decoder"]["layers"])
    y = dispatch(fused_forward)(fv.to(torch.bfloat16), vox, delta, packed, cfg.grid_size, cfg.k)
    return _activate(y, cfg, mask)


def _fv(cfg: DPDistConfig, encode: str, points):
    """The 3DmFV of `points` by `encode` ("threedmfv": the kernel, "plain",
    or "auto": threedmfv's dispatch), flattened for k=0."""
    impl = {"threedmfv": "kernel", "plain": "plain"}.get(encode, encode)
    return threedmfv(points, cfg.embedding_size, cfg.sigma, impl=impl, flatten=cfg.k == 0,
                     full_fv=cfg.full_fv)


def _encode(cfg: DPDistConfig, encode: str, points):
    """_fv inside the cloud's "dpdist.encode" span (detail: `encode`)."""
    with span("dpdist.encode", encode):
        return _fv(cfg, encode, points)


def _pointnet_encode(params, state, points, *, train: bool, bn_momentum):
    """(B, N, D) -> ((B, E) max over points, new state): dense, BN on layers
    2-4 with use_bn, ReLU (dpdist_tpu/models/dpdist.py:127-143). torch.amax
    splits the gradient of tied maxima evenly, as jnp.max does."""
    x, new_bn = points, []
    use_bn = "bn" in params
    for i, lp in enumerate(params["layers"]):
        x = dense_apply(lp, x)
        if use_bn and i > 0:
            x, s = batchnorm_apply(params["bn"][i - 1], state["bn"][i - 1], x, train=train,
                                   momentum=bn_momentum)
            new_bn.append(s)
        x = torch.relu(x)
    return torch.amax(x, dim=1), ({"bn": new_bn} if use_bn else {})


def dpdist_embed(params, state, cfg: DPDistConfig, points, *, train: bool = False,
                 bn_momentum=0.9, encode: str = "auto"):
    """Encode a cloud into its queryable representation (port of
    dpdist_embed): (table, new_state) with table the (B, V, k^D*C) patch
    table (k > 0; in cfg.dtype), or the (B, C*G) flattened 3DmFV (k == 0;
    in cfg.dtype) or the (B, E) pointnet embedding (float32), a global
    embedding. new_state is {"pointnet": ...} for the pointnet encoder, else
    {}. `encode` picks the 3DmFV encode ("auto": threedmfv's dispatch,
    "threedmfv": the kernel, "plain")."""
    state = _state(cfg, state)
    if cfg.encoder == "pointnet":
        with span("dpdist.encode", "pointnet"):
            emb, ns = _pointnet_encode(params["pointnet"], state.get("pointnet", {}), points,
                                       train=train, bn_momentum=bn_momentum)
        return emb, {"pointnet": ns}
    with span("dpdist.encode", encode):
        fv = _fv(cfg, encode, points).to(DTYPES[cfg.dtype])
        if cfg.k == 0:
            return fv, {}
        patches = extract_patches_2d if cfg.dims == 2 else extract_patches
        return patches(fv, cfg.grid_size, cfg.k), {}


def _decoder_inputs(cfg: DPDistConfig, queries, table):
    """(x, mask) of one direction from dpdist_embed's table: [delta, the
    query's patch] and the membership mask for k > 0; for a global
    embedding [the raw query coordinates, the embedding] and mask None
    (the reference's mask of ones, :224-227). x follows the table's dtype."""
    if cfg.k > 0:
        if table.dim() != 3:
            raise ValueError("the pointnet encoder gives one global embedding: it needs k=0 "
                             f"(got k={cfg.k})")
        vox, mask, delta = voxel_assign(queries, cfg.grid_size)
        return torch.cat([delta.to(table.dtype), gather_patches(table, vox)], dim=-1), mask
    B, N, _ = queries.shape
    emb = table[:, None, :].expand(B, N, table.shape[-1])
    return torch.cat([queries.to(table.dtype), emb], dim=-1), None


def _decoder_input(cfg: DPDistConfig, gather: str, fv, points_enc, queries, vox, mask, delta):
    """x = [delta, patch] of `queries` against the surface of `points_enc`
    (its volume `fv`, None for "mfv_gather_x", which encodes), by the gather
    `route` names (vox, mask and delta: voxel_assign(queries)).
    For a bf16 or fp16 config every gather takes the volume in that dtype,
    as the reference casts fv before its gather: the table-gather kernels
    and the plain composition write x in it, the per-query gather writes
    the rounded values in float32 (as the reference's kernel does) and
    leaves x's rounding to the decoder."""
    dtype = DTYPES[cfg.dtype]
    args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
    if gather == "mfv_gather_x":
        return dispatch(mfv_x)(points_enc, queries, *args, dtype=dtype)[0]
    if gather == "table_gather_x":
        return dispatch(table_gather_x)(fv, queries, cfg.grid_size, cfg.k, dtype=dtype)[0]
    if gather == "table_gather":
        patches = dispatch(table_gather)(fv, vox, cfg.grid_size, cfg.k, dtype=dtype)
        delta = delta.to(dtype)
    elif gather == "gather_patches_fused":
        patches = dispatch(gather_patches_fused)(fv, vox, mask, cfg.grid_size, cfg.k, dtype=dtype)
    else:
        patches = gather_patches(extract_patches(fv.to(dtype), cfg.grid_size, cfg.k), vox)
        delta = delta.to(dtype)
    return torch.cat([delta, patches], dim=-1)


def _prep(points):
    return points.to(torch.float32).contiguous()


def _halves(x):
    """The two halves of a 2B stack along the batch, torch.chunk's, as
    views of one (2, B, ...) view: both of the batch's symbolic size when
    an export traces them (chunk and slices leave guards on it)."""
    pair = x.unflatten(0, (2, -1))
    return pair[0], pair[1]


def _batch(points):
    """The batch of `points` for `route`: an int, or None where it is
    symbolic (an export's)."""
    b = points.shape[0]
    return b if isinstance(b, int) else None


def _direction_input(params, state, cfg, encode, gather, points_enc, queries, train,
                     bn_momentum):
    """(x, mask, encoder state) of one direction by the kernels `route`
    names, in its "dpdist.encode" and "dpdist.gather" spans; configs without
    a gather kernel take dpdist_embed's table."""
    if not gathers(cfg):
        table, enc_state = dpdist_embed(params, state, cfg, points_enc, train=train,
                                        bn_momentum=bn_momentum, encode=encode)
        with span("dpdist.gather", "plain"):
            return (*_decoder_inputs(cfg, queries, table), enc_state)
    fv = None if gather == "mfv_gather_x" else _encode(cfg, encode, points_enc)
    with span("dpdist.gather", gather):
        vox, mask, delta = voxel_assign(queries, cfg.grid_size)
        return _decoder_input(cfg, gather, fv, points_enc, queries, vox, mask, delta), mask, {}


def _predict(params, state, cfg: DPDistConfig, mode: str, x, mask, **kw):
    """The activated, masked prediction of one direction's decoder input x,
    in its "dpdist.decode" span (detail: the route's mode)."""
    with span("dpdist.decode", mode):
        return _activate(_decode(params, state, cfg, x, **kw)[0], cfg, mask)


def apply_direction(params, cfg: DPDistConfig, points_enc, queries, *, state=None,
                    train: bool = False, bn_momentum=0.9):
    """One direction: the (B, N, output_channels) prediction for the points
    of `queries` against the surface encoded from `points_enc`, masked
    outside the grid, by the kernels `route` names for it. apply_dpdist is
    two of these (or one mfv call); a loss that reads one direction calls
    this alone, since eager PyTorch does not drop an unused direction the
    way XLA does. `state` and `train` as in forward_dpdist; a training
    forward of a BN config raises, since its batch statistics cover both
    directions (use forward_dpdist)."""
    if train and cfg.use_bn:
        raise ValueError("with use_bn a training forward decodes both directions as one "
                         "batch (its statistics cover 2B rows): use forward_dpdist")
    points_enc, queries = _prep(points_enc), _prep(queries)
    _check_grad(cfg, params, train, points_enc, queries)
    state = _state(cfg, state)
    r = route(cfg, route_device(queries), points_enc.shape[1], queries.shape[1], train=train,
              batch=_batch(queries))
    if r.gather[0] == "fused_forward":
        fv = _encode(cfg, r.encode[0], points_enc)
        with span("dpdist.decode", "fused_forward"):
            return _fused_head(params, cfg, fv, queries)
    x, mask, _ = _direction_input(params, state, cfg, r.encode[0], r.gather[0], points_enc,
                                  queries, train, bn_momentum)
    return _predict(params, state, cfg, r.mode, x, mask, train=train, bn_momentum=bn_momentum)


def forward_dpdist(params, state, cfg: DPDistConfig, pcA, pcB, *, noise=None,
                   train: bool = False, bn_momentum=0.9):
    """Bidirectional forward, the reference's apply_dpdist: (pred_AB,
    pred_BA, new_state), the predictions (B, N, output_channels).

    `params` and `state` come from init_dpdist or load_dpdist_checkpoint
    (state may be None for a config without BN). `noise`, if given, is
    added to the encoder's copy of pcA only; the queries stay exact (the
    reference's pcA_noise). train=True normalises with batch statistics
    (BN over the 2B batch [xAB; xBA], and per cloud in the pointnet
    encoder), returns their EMA with decay `bn_momentum` as the new state
    (the encoder's from pcB's run), and keeps a bf16 fused_gather="full"
    config off the eval-only fused kernel (it runs "table"); else the state
    is returned as it is. Under autograd, bf16 "full" with train=False
    raises (the reference refuses its gradient)."""
    pcA, pcB = _prep(pcA), _prep(pcB)
    _check_grad(cfg, params, train, pcA, pcB, noise)
    state = _state(cfg, state)
    pcA_enc = pcA if noise is None else _prep(pcA + noise)
    r = route(cfg, route_device(pcA), pcA.shape[1], pcB.shape[1], train=train, batch=_batch(pcA))
    kw = dict(train=train, bn_momentum=bn_momentum)
    if r.mode == "full":
        # Both directions in one kernel call: volumes [A; B], queries [B; A].
        fv2 = torch.cat([_encode(cfg, r.encode[0], pcA_enc), _encode(cfg, r.encode[1], pcB)])
        with span("dpdist.decode", "fused_forward"):
            pred = _fused_head(params, cfg, fv2, torch.cat([pcB, pcA]))
        return (*_halves(pred), {"decoder": {}})
    if r.mode == "mfv" and pcA.shape == pcB.shape:
        # Both directions in one kernel call: encode [A; B], query [B; A];
        # its 2B output is also the BN decoder's batch.
        args = (cfg.embedding_size, cfg.sigma, cfg.grid_size, cfg.k)
        with span("dpdist.gather", "mfv_gather_x"):
            x2 = dispatch(mfv_x)(torch.cat([pcA_enc, pcB]), torch.cat([pcB, pcA]), *args,
                                 dtype=DTYPES[cfg.dtype])[0]
            _, maskAB, _ = voxel_assign(pcB, cfg.grid_size)
            _, maskBA, _ = voxel_assign(pcA, cfg.grid_size)
        with span("dpdist.decode", "mfv"):
            y, dec_state = _decode(params, state, cfg, x2, **kw)
            pred = _activate(y, cfg, torch.cat([maskAB, maskBA]))
        return (*_halves(pred), {"decoder": dec_state})
    xAB, maskAB, _ = _direction_input(params, state, cfg, r.encode[0], r.gather[0], pcA_enc,
                                      pcB, **kw)                  # B's points vs surface(A)
    xBA, maskBA, enc_state = _direction_input(params, state, cfg, r.encode[1], r.gather[1],
                                              pcB, pcA, **kw)     # A's points vs surface(B)
    if cfg.use_bn:
        # One 2B batch through the decoder: the reference's
        # tf.concat([net, netB], 0) batch statistics.
        with span("dpdist.decode", r.mode):
            y, dec_state = _decode(params, state, cfg, torch.cat([xAB, xBA]), **kw)
            yAB, yBA = _halves(y)
            predAB, predBA = _activate(yAB, cfg, maskAB), _activate(yBA, cfg, maskBA)
    else:
        # BN off: each decoder row is independent, so the directions
        # decode separately.
        predAB = _predict(params, state, cfg, r.mode, xAB, maskAB, **kw)
        predBA = _predict(params, state, cfg, r.mode, xBA, maskBA, **kw)
        dec_state = {}
    new_state = dict(enc_state) if cfg.encoder == "pointnet" else {}
    new_state["decoder"] = dec_state
    return predAB, predBA, new_state


def apply_dpdist(params, cfg: DPDistConfig, pcA, pcB, *, state=None, noise=None,
                 train: bool = False, bn_momentum=0.9):
    """(pred_AB, pred_BA) of forward_dpdist, each (B, N, output_channels);
    state=None for a config without BN."""
    return forward_dpdist(params, state, cfg, pcA, pcB, noise=noise, train=train,
                          bn_momentum=bn_momentum)[:2]


def dpdist_distance(params, cfg: DPDistConfig, pcA, pcB, *, state=None,
                    per_example: bool = False):
    """(mean(pred_AB[..., 0]) + mean(pred_BA[..., 0])) / 2 in eval mode,
    over the batch or, with per_example=True, per pair as a (B,) tensor.
    Differentiable in pcA and pcB; detach the parameters at the call site
    for a frozen loss (losses/dpdist_loss.py)."""
    pred_AB, pred_BA = apply_dpdist(params, cfg, pcA, pcB, state=state)
    if per_example:
        return (torch.mean(pred_AB[..., 0], dim=-1) + torch.mean(pred_BA[..., 0], dim=-1)) / 2.0
    return (torch.mean(pred_AB[..., 0]) + torch.mean(pred_BA[..., 0])) / 2.0
