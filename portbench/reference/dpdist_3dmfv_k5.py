"""Plain reference of the DPDist distance at dpdist_3dmfv_k5: the frozen
net's per-pair distance and its frozen loss, in plain PyTorch.

It follows the DPDist forward as the paper and dahliau/DPDist define it,
with nothing of the program under test (no kernel, no module of
dpdist_tpu_torch, no weights the program prepared):

  1. each cloud's 3DmFV: a uniform-weight isotropic GMM of G = g^3
     Gaussians (sigma) centred on the grid; per point the softmax
     responsibilities over -||x - mu||^2 / (2 sigma^2), and per Gaussian
     the mean and max of the weight term and the mean, max and min of the
     mean and variance terms (20 channels), each group power-normalised
     (signed square root) and L2-normalised over the Gaussians;
  2. each query of the other cloud: its cell (cells strict below and
     inclusive above, flat index iy g^2 + ix g + iz), its offset to the
     cell's centre, and the k^3 x 20 patch of the volume around the cell
     with zero padding (offset-major, then channel); a query off the grid
     takes cell 0 and is masked;
  3. [offset, patch] through the MLP (ReLU between layers), relu6(y)/3 on
     output channel 0, times the mask;
  4. the distance of a pair: the mean of its two directions' means.

The frozen loss is the batch's mean distance plus penalty * (mean(relu(|A|
- 1)) + mean(relu(|B| - 1))), the program's barrier against leaving the
grid.

`Arith` fixes the precision of the products: "float32" (TF32 off, as the
configuration states) or "tf32", the control: on the card cuBLAS and
cuDNN in TF32; elsewhere each operand rounded to TF32's 10-bit mantissa
before a float32 product, which is what the tensor cores compute.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even); the gradient
    passes as it is."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x.detach())


class Arith:
    """The products of a reference run in float32 or in TF32; a context
    that sets the card's TF32 flags and restores them."""

    def __init__(self, kind: str, device):
        if kind not in ("float32", "tf32"):
            raise ValueError(f"precision must be 'float32' or 'tf32', got {kind!r}")
        self.kind = kind
        self.device = torch.device(device)
        self.emulate = kind == "tf32" and self.device.type != "cuda"

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.kind == "tf32" and not self.emulate
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved

    def _ops(self, *xs):
        return [tf32_round(x) for x in xs] if self.emulate else list(xs)

    def linear(self, x, w, b):
        x, w = self._ops(x, w)
        return torch.matmul(x, w) + b

    def conv3d(self, x, w, b, padding):
        x, w = self._ops(x, w)
        return F.conv3d(x, w, b, padding=padding)


def centres(g: int, device) -> torch.Tensor:
    """(g,) cell and Gaussian centre coordinates along one axis: -1 + (i + 1/2) 2/g."""
    return torch.tensor((np.arange(g) * (2.0 / g) - 1.0 + 1.0 / g).astype(np.float32),
                        device=device)


def encode(points: torch.Tensor, gaussians: int, sigma: float) -> torch.Tensor:
    """(B, N, 3) -> (B, G, 20) normalised 3DmFV, float32."""
    B, N, _ = points.shape
    g = round(gaussians ** (1 / 3))
    c = centres(g, points.device)
    iy, ix, iz = torch.meshgrid(c, c, c, indexing="ij")               # flat v = iy g^2 + ix g + iz
    mu = torch.stack([ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)], -1)   # (G, 3)
    w = 1.0 / gaussians
    diff = (points[:, :, None, :] - mu) / sigma                       # (B, N, G, 3)
    q = torch.softmax(-0.5 * (diff * diff).sum(-1), dim=-1)           # (B, N, G)
    pi = (q - w) / (math.sqrt(w) * N)
    m = q[..., None] * diff
    s = q[..., None] * (diff * diff - 1.0)
    groups = [
        torch.stack([pi.mean(1), pi.amax(1)], -1),
        torch.cat([m.mean(1), m.amax(1), m.amin(1)], -1) / math.sqrt(w),
        torch.cat([s.mean(1), s.amax(1), s.amin(1)], -1) / math.sqrt(2 * w),
    ]
    out = []
    for x in groups:
        x = torch.sign(x) * torch.clamp(x.abs(), min=1e-12).sqrt()
        x = x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True), min=1e-12))
        out.append(x)
    return torch.cat(out, -1)


def cells(points: torch.Tensor, g: int):
    """(digits (B, N, 3) = (iy, ix, iz), mask (B, N), delta (B, N, 3)) of
    each query; off the grid: cell 0, mask 0."""
    u = (points + 1.0) / (2.0 / g)
    idx = torch.ceil(u).to(torch.int64) - 1
    inside = ((u > 0) & (idx <= g - 1)).all(-1)
    idx = torch.where(inside[..., None], idx.clamp(0, g - 1), torch.zeros_like(idx))
    delta = points - centres(g, points.device)[idx]
    return idx[..., [1, 0, 2]], inside.to(points.dtype), delta


def patches(fv: torch.Tensor, digits: torch.Tensor, g: int, k: int) -> torch.Tensor:
    """(B, N, k^3 C): the zero-padded k^3 window of fv around each query's cell."""
    B, _, C = fv.shape
    h = k // 2
    vol = F.pad(fv.reshape(B, g, g, g, C), (0, 0, h, h, h, h, h, h))
    r = torch.arange(k, device=fv.device)
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)   # (k^3, 3)
    at = digits[:, :, None, :] + off                                   # (B, N, k^3, 3)
    b = torch.arange(B, device=fv.device)[:, None, None]
    return vol[b, at[..., 0], at[..., 1], at[..., 2]].reshape(B, digits.shape[1], -1)


class Net:
    """The frozen net: config and the checkpoint's arrays ({"decoder/layers/i/w": ...})."""

    def __init__(self, cfg: dict, arrays: dict, device):
        if not (cfg["encoder"] == "3dmfv" and cfg["dims"] == 3 and cfg["full_fv"] and cfg["k"] > 0
                and cfg["conv_version"] == 1 and not cfg["use_bn"] and cfg["output_act"] == "relu"):
            raise ValueError("this reference covers the 3DmFV k > 0 MLP decoder without BN only")
        self.cfg = cfg
        n = len(cfg["mlp"]) + 1
        self.layers = [tuple(torch.as_tensor(arrays[f"decoder/layers/{i}/{p}"], device=device)
                             for p in ("w", "b")) for i in range(n)]

    def predict(self, arith: Arith, surface: torch.Tensor, queries: torch.Tensor):
        """(B, N): the activated, masked channel 0 for the queries against
        the surface encoded from `surface`."""
        cfg = self.cfg
        g = round(cfg["embedding_size"] ** (1 / 3))
        fv = encode(surface, cfg["embedding_size"], cfg["sigma"])
        digits, mask, delta = cells(queries, g)
        x = torch.cat([delta, patches(fv, digits, g, cfg["k"])], -1)
        for i, (w, b) in enumerate(self.layers):
            x = arith.linear(x, w, b)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        y = x[..., 0]
        y = torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_full((), 6.0)) / 3.0
        return y * mask

    def distances(self, arith: Arith, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B,) the per-pair distance of (template a, source b)."""
        return (self.predict(arith, a, b).mean(-1) + self.predict(arith, b, a).mean(-1)) / 2

    def frozen_loss(self, arith: Arith, a, b, penalty: float = 1.0) -> torch.Tensor:
        loss = self.distances(arith, a, b).mean()
        if penalty > 0:
            loss = loss + penalty * (torch.relu(a.abs() - 1).mean() + torch.relu(b.abs() - 1).mean())
        return loss
