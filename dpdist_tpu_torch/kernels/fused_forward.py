"""Fused patch gather + the whole decoder in bfloat16: the eval-only
serving forward for fused_gather="full".

Port of dpdist_tpu/kernels/fused_forward_pallas.py (`fused_forward`, TPU
kernel `_kernel`). The CUDA kernel is dpdist_tpu_torch/csrc/fused_forward.cu;
its header says what bounds it on an H100 and how the design meets that.

    packed = pack_decoder(layers)
        The conv_version = 1 decoder ({"w": (in, out), "b": (out,)} per
        layer, the last one linear) rounded to bfloat16 once, in the
        kernel's layout. A model holds the pack; nothing packs per call.
    y = fused_forward(fv, vox, delta, packed, grid_size, k)
        (B, V, C) bfloat16 volume + (B, N) int32 voxel ids + (B, N, 3)
        float32 delta -> (B, N, out) float32 pre-activation decoder output
        (the caller applies the output activation and the mask; off-grid
        queries carry vox 0 and compute cell 0's row).

Numerics, as the reference's kernel: x = [bf16(delta), patch] with W1 split
as emb @ W1[3:] + delta @ W1[:3]; every weight and bias rounded to
bfloat16; every product accumulated in float32 and the bias added in
float32; ReLU on the hidden layers, whose output rounds to bfloat16 before
each next product; the last layer linear and float32.

There is no backward, as the reference defines no VJP: differentiating
through fused_forward raises. On CPU tensors it runs `fused_forward_plain`,
float32 matmuls on the bfloat16-rounded operands (a product of two bfloat16
values is exact in float32, so it differs from the kernel only in
summation order), which is also the kernel's oracle on the card. On CUDA
tensors it launches the kernel or raises; it never falls back.
`fused_forward.launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from dpdist_tpu_torch.ops.voxel import extract_patches, gather_patches

# The kernel's limits (csrc/fused_forward.cu): hidden widths are multiples
# of 16 up to 1024, at most 8 hidden layers, and the first layer's K is
# padded to a multiple of 16.
MAX_WIDTH, MAX_HIDDEN, K_ALIGN = 1024, 8, 16


@dataclasses.dataclass(frozen=True)
class PackedDecoder:
    """The decoder in the kernel's layout, every value rounded to bfloat16.

    w: the hidden layers' weights, bfloat16, row-major (K, width): w[0] is
       [W1[3:]; W1[:3]; zero rows up to a multiple of 16], so that it meets
       the A operand [patch, delta, 0 ...]; w[i] is layer i's (in, out).
    b: the hidden layers' biases, float32 holding bfloat16-rounded values.
    w_out: the linear head, transposed to (out, width), float32 holding
       bfloat16-rounded values; b_out its bias, likewise.
    in_dim: the decoder input's width, 3 + k^3*C.
    """

    w: tuple
    b: tuple
    w_out: torch.Tensor
    b_out: torch.Tensor
    in_dim: int


def _bf16_values(t):
    return t.detach().to(torch.bfloat16).to(torch.float32).contiguous()


def pack_decoder(layers) -> PackedDecoder:
    """Round the decoder layers to bfloat16 in the kernel's layout (see
    PackedDecoder), on the layers' device."""
    if len(layers) < 2 or len(layers) - 1 > MAX_HIDDEN:
        raise ValueError(f"the fused forward takes 1 to {MAX_HIDDEN} hidden layers and a "
                         f"linear head, got {len(layers)} layers")
    w1 = layers[0]["w"].detach()
    in_dim, width = w1.shape
    k1 = -(-in_dim // K_ALIGN) * K_ALIGN
    w0 = torch.zeros((k1, width), dtype=torch.bfloat16, device=w1.device)
    w0[:in_dim - 3] = w1[3:]
    w0[in_dim - 3:in_dim] = w1[:3]
    ws = [w0] + [lp["w"].detach().to(torch.bfloat16).contiguous() for lp in layers[1:-1]]
    for w in ws:
        if w.shape[1] % K_ALIGN or w.shape[1] > MAX_WIDTH:
            raise ValueError(f"hidden widths must be multiples of {K_ALIGN} up to {MAX_WIDTH}, "
                             f"got {w.shape[1]}")
    return PackedDecoder(w=tuple(ws), b=tuple(_bf16_values(lp["b"]) for lp in layers[:-1]),
                         w_out=_bf16_values(layers[-1]["w"].t()),
                         b_out=_bf16_values(layers[-1]["b"]), in_dim=in_dim)


def fused_forward_plain(fv, vox, delta, packed: PackedDecoder, grid_size: int, k: int):
    """Plain PyTorch version: the gather and float32 matmuls on the
    bfloat16-rounded operands, with the reference kernel's rounding points."""
    emb = gather_patches(extract_patches(fv.to(torch.float32), grid_size, k), vox)
    x = torch.cat([emb, delta.to(torch.bfloat16).to(torch.float32)], dim=-1)
    h = torch.relu(x @ packed.w[0][:packed.in_dim].to(torch.float32) + packed.b[0])
    for w, b in zip(packed.w[1:], packed.b[1:]):
        h = torch.relu(h.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32) + b)
    return h.to(torch.bfloat16).to(torch.float32) @ packed.w_out.t() + packed.b_out


def _check(fv, vox, delta, packed, grid_size, k):
    if not isinstance(fv, torch.Tensor) or fv.dtype != torch.bfloat16 or fv.dim() != 3:
        raise TypeError("fv must be a (B, V, C) bfloat16 tensor")
    if not isinstance(vox, torch.Tensor) or vox.dtype != torch.int32 or vox.dim() != 2:
        raise TypeError("vox must be a (B, N) int32 tensor")
    if not isinstance(delta, torch.Tensor) or delta.dtype != torch.float32:
        raise TypeError("delta must be a (B, N, 3) float32 tensor")
    if not isinstance(packed, PackedDecoder):
        raise TypeError("packed must come from pack_decoder")
    B, V, C = fv.shape
    if delta.shape != (*vox.shape, 3) or vox.shape[0] != B or vox.shape[1] < 1:
        raise ValueError(f"fv {tuple(fv.shape)}, vox {tuple(vox.shape)} and delta "
                         f"{tuple(delta.shape)} do not match")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd and positive, got {k}")
    if V != grid_size ** 3:
        raise ValueError(f"fv has {V} cells, expected grid_size^3 = {grid_size ** 3}")
    if 3 + k ** 3 * C != packed.in_dim:
        raise ValueError(f"the decoder takes {packed.in_dim} inputs, the patches give "
                         f"{3 + k ** 3 * C}")
    if not (fv.is_contiguous() and vox.is_contiguous() and delta.is_contiguous()):
        raise ValueError("fv, vox and delta must be contiguous")
    devices = {fv.device, vox.device, delta.device, packed.w_out.device}
    if len(devices) != 1:
        raise ValueError(f"fv, vox, delta and the packed decoder lie on {devices}")
    if fv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_forward runs on cpu or cuda tensors, got {fv.device}")
    if torch.is_grad_enabled() and (fv.requires_grad or delta.requires_grad):
        raise RuntimeError("fused_forward has no backward (the reference defines no VJP): "
                           "run it under torch.no_grad() on inputs that need no gradient")


def fused_forward(fv, vox, delta, packed: PackedDecoder, grid_size: int, k: int):
    """(B, V, C) bfloat16 volume, (B, N) int32 voxel ids in [0, V) and
    (B, N, 3) float32 delta -> (B, N, out) float32 pre-activation decoder
    output; see the module docstring."""
    _check(fv, vox, delta, packed, grid_size, k)
    dev = fv.device
    if dev.type == "cpu":
        return fused_forward_plain(fv, vox, delta, packed, grid_size, k)

    from dpdist_tpu_torch.kernels import build

    lib = build.library()
    B, V, C = fv.shape
    N = vox.shape[1]
    n_hidden = len(packed.w)
    widths = (ctypes.c_int * n_hidden)(*(w.shape[1] for w in packed.w))
    smem = lib.dpdist_fused_forward_smem(grid_size, k, C, widths, n_hidden)
    if smem > build.MAX_SMEM:
        raise ValueError(f"the fused forward needs {smem} B of shared memory, more than the "
                         f"{build.MAX_SMEM} B a block has")
    out = packed.b_out.shape[0]
    y = torch.empty((B, N, out), dtype=torch.float32, device=dev)
    w_ptrs = (ctypes.c_void_p * n_hidden)(*(w.data_ptr() for w in packed.w))
    b_ptrs = (ctypes.c_void_p * n_hidden)(*(b.data_ptr() for b in packed.b))
    err = lib.dpdist_fused_forward(
        fv.data_ptr(), vox.data_ptr(), delta.data_ptr(), y.data_ptr(), w_ptrs, b_ptrs, widths,
        n_hidden, packed.w[0].shape[0], packed.w_out.data_ptr(), packed.b_out.data_ptr(), out,
        B, N, grid_size, k, C, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, "fused_forward")
    fused_forward.launches += 1
    return y


fused_forward.launches = 0
