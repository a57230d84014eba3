"""Operations and bytes from shapes, and the H100's published peaks.

The arithmetic of the kernels' bounds is the one `chip_smoke.py` uses for
PERF.md's kernel table (rows 1, 2, 3, 6 and 7), copied here so that the
yardstick cannot move with the program. Each input byte is counted once
and each output byte once, whatever a kernel reads again; where the work
depends on the data (which cells a query's window reaches, which windows
lie inside the grid), the count is of what the given inputs need.

Model FLOPs count the GEMMs and convolutions only (2 operations a
multiply-add); encodes, activations, BN and the optimizer's elementwise
passes are left out, which is under 1 % of each step's FLOPs.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores (TF32 off)

F32 = 4                          # bytes of a float32 or an int32
ROW1_OPS_PER_PAIR = 40           # row 1's encode: float32 operations a (point, Gaussian) pair
ENCODE_OPS_PER_PAIR = 50         # row 7's encode: the same, with its exp and 20 pools


def bound_s(bytes_moved: float, flops: float, peak: float = F32_FLOP_PER_S):
    """(seconds, "bytes" or "operations"): the least time the card could
    take for this work."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mlp_row_flops(in_dim: int, widths) -> int:
    """FLOPs of one row through a dense chain: 2 * sum(in * out)."""
    total, d = 0, in_dim
    for w in widths:
        total += 2 * d * w
        d = w
    return total


def decoder_row_flops(cfg: dict) -> int:
    """One DPDist decoder row: [delta, k^3 x C patch] through the MLP to
    the output channels (9,326,592 at the canonical config)."""
    return mlp_row_flops(cfg["dims"] + patch_dim(cfg), list(cfg["mlp"]) + [cfg["output_channels"]])


def fv_channels(cfg: dict) -> int:
    d = cfg["dims"]
    return 2 + 6 * d if cfg["full_fv"] else 1 + 2 * d


def patch_dim(cfg: dict) -> int:
    return fv_channels(cfg) * cfg["k"] ** cfg["dims"]


def serve_call_flops(cfg: dict, pairs: int, points: int) -> int:
    """A frozen-distance call: both directions, 2 * pairs * points rows."""
    return 2 * pairs * points * decoder_row_flops(cfg)


def grad_call_flops(cfg: dict, pairs: int, points: int) -> int:
    """A frozen-loss value and source gradient: the forward's GEMMs and the
    decoder's input-gradient GEMMs (as many again; the frozen weights get
    no gradient)."""
    return 2 * serve_call_flops(cfg, pairs, points)


def aue_step_flops(aue: dict, dpdist: dict, batch: int) -> int:
    """One "ours" AUE training step at `batch` clouds: the inception block's
    four convolutions and the two dense layers, forward, their weight
    gradients and the input gradients that reach a parameter (none into
    the encoded volume), and the frozen DPDist loss (forward and input
    gradient) on the reconstruction."""
    cells, c, nf = aue["n_gaussians"], fv_channels(dpdist), aue["inception_filters"]
    n = aue["num_point"]

    def conv(window, cin, cout):
        return 2 * batch * cells * window * cin * cout

    convs_in = conv(1, c, nf) + conv(1, c, nf)                     # conv1, conv4 on the volume
    convs_mid = conv(27, nf, nf // 2) + conv(125, nf, nf // 2)     # conv2, conv3 on conv1's output
    dense = 2 * batch * (cells * 3 * nf * aue["decoder_width"] + aue["decoder_width"] * n * 3)
    forward = convs_in + convs_mid + dense
    backward = forward + convs_mid + dense
    return forward + backward + grad_call_flops(dpdist, batch, n)


# --- the kernels' work per launch (PERF.md's kernel table, chip_smoke.py) ---

def row1_work(clouds: int, n: int, gaussians: int, width: int):
    """mfv_gather_x over the 2B stack: points and queries in, two grid
    tables, [delta, patch] rows and vox out; (bytes, flops)."""
    nbytes = F32 * (clouds * n * 6 + 2 * gaussians * 3 + clouds * n * (3 + width) + clouds * n)
    return nbytes, ROW1_OPS_PER_PAIR * clouds * n * gaussians


def row2_work(clouds: int, n: int, cells: int, channels: int, width: int, reached: int):
    """table_gather_x: the reached cells of the volume, queries and cell
    centres in, [delta, patch] rows and vox out; q - centre the only
    arithmetic."""
    nbytes = F32 * (reached * channels + clouds * n * 3 + cells * 3 + clouds * n * (3 + width)
                    + clouds * n)
    return nbytes, 3 * clouds * n


def row3_work(clouds: int, n: int, cells: int, channels: int, inside: int):
    """table_gather_bwd: the gradient entries of in-grid (query, offset)
    windows and vox in, dfv out; one add per such entry."""
    adds = inside * channels
    return F32 * (adds + clouds * n + clouds * cells * channels), adds


def row6_work(clouds: int, n: int, channels: int, width: int, reached: int):
    """table_gather (patch rows only): the reached cells and vox in, the
    rows out; no arithmetic."""
    return F32 * (reached * channels + clouds * n + clouds * n * width), 0


def row7_work(clouds: int, n: int, gaussians: int, channels: int):
    """The streaming 3DmFV encode: points and centres in, volumes out;
    about 50 operations a (point, Gaussian) pair."""
    return (F32 * (clouds * n * 3 + gaussians * 3 + clouds * gaussians * channels),
            ENCODE_OPS_PER_PAIR * clouds * n * gaussians)


def grid_of(cells: int) -> int:
    g = round(cells ** (1 / 3))
    if g ** 3 != cells:
        raise ValueError(f"{cells} cells is not a cube")
    return g


def windows(points, grid: int, k: int):
    """(reached, inside) of the queries `points` (numpy, (B, N, 3)): the
    (cloud, cell) pairs some query's k^3 window reaches, and the (query,
    offset) windows inside the grid. A query off the grid takes cell 0, as
    the kernels do."""
    B = points.shape[0]
    step = 2.0 / grid
    u = (points.astype(np.float32) + np.float32(1.0)) / np.float32(step)
    idx = np.ceil(u).astype(np.int64) - 1
    on_grid = np.all((u > 0) & (idx <= grid - 1), axis=-1)
    idx = np.where(on_grid[..., None], np.clip(idx, 0, grid - 1), 0)
    # (iy, ix, iz): the digits of the flat cell index iy*g^2 + ix*g + iz.
    digits = np.stack([idx[..., 1], idx[..., 0], idx[..., 2]], -1)
    r = np.arange(k) - k // 2
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    nb = digits[:, :, None, :] + offs                                  # (B, N, k^3, 3)
    ok = np.all((nb >= 0) & (nb < grid), axis=-1)
    flat = (nb[..., 0] * grid + nb[..., 1]) * grid + nb[..., 2]
    cells = grid ** 3
    keyed = np.where(ok, flat + cells * np.arange(B)[:, None, None], -1)
    reached = len(np.unique(keyed[ok]))
    return reached, int(ok.sum())


def mfu_pct(flops: float, seconds: float, peak: float = F32_FLOP_PER_S) -> float:
    return 100.0 * flops / seconds / peak
