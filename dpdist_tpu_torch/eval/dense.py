"""Dense point-to-surface evaluation (port of dpdist_tpu/eval/dense.py).

Every query point is scored independently against one encoded surface, so
10^5-10^6 queries (a distance field for level-set surface extraction, or
the generator's dense evaluation densities) run as one batch of queries
against one small embedding.

    d = dense_point_to_surface(params, cfg, cloud, queries)      # (B, N)
    f = distance_field(params, cfg, cloud, resolution=64)         # (B, 64, 64, 64)

Two paths, as the reference's:
  - the decoder on [delta, patch] rows (_decode_queries), each step by the
    kernel `route` names for the config under fused_gather="table": the
    cloud's encode by the streaming kernel for a full_fv cloud of >= 128
    points, and for the configs the gather kernels serve (3DmFV, k > 0,
    3-D) the rows by the patch-only gather kernel table_gather
    (kernels/table_gather.py) at more than 128 queries; the other configs
    take dpdist_embed's table. fused_gather="off" keeps the plain
    composition on every device.
  - pretransformed (_decode_queries_pretransformed), for conv_version 1
    without BN: the first layer's embedding half folded into the V-row
    patch table, relu([delta, emb] @ W1 + b) = relu(delta @ W1d +
    onehot @ (table @ W1e) + b), so each query gathers an mlp[0]-wide row
    instead of a k^3*C-wide one. "auto" takes it when the queries number at
    least 4 V. The table product is a plain matmul, as the reference
    computes it outside any kernel.
Both run the decoder in float32 on an input rounded to cfg.dtype, as the
reference's dense path does (it never casts the decoder).

With a mesh whose 'points' axis holds P > 1 processes (parallel.make_mesh)
the N queries shard over it, as the reference's shard_map does: every
process encodes the cloud (replicated work), decodes its contiguous N / P
queries on either path, and an all_gather along the axis returns the whole
(B, N) to every process. N must divide by P.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dpdist_tpu_torch.configs import DPDistConfig
from dpdist_tpu_torch.models.dpdist import (
    _activate,
    _decode,
    _direction_input,
    _output_activation,
    _prep,
    _state,
    check_ported,
    dpdist_embed,
    route,
)
from dpdist_tpu_torch.nn.layers import dense_apply
from dpdist_tpu_torch.ops.voxel import gather_patches, voxel_assign


def _decode_queries(params, state, cfg: DPDistConfig, cloud, queries, encode: str,
                    gather: str):
    """One-directional decode: (B, N) distances of `queries` to the surface
    of `cloud` (channel 0, masked outside the grid for k > 0), the encode
    and the gather by the kernels `route` names."""
    x, mask, _ = _direction_input(params, state, cfg, encode, gather, cloud, queries,
                                  train=False, bn_momentum=None)
    y, _ = _decode(params, state, cfg.replace(dtype="float32"), x.to(torch.float32))
    return _activate(y, cfg, mask)[..., 0]


def _decode_queries_pretransformed(params, cfg: DPDistConfig, queries, table_w1, w1_delta, b1):
    """The MLP decoder with its first layer's embedding half folded into the
    table: (B, N) distances, as _decode_queries."""
    vox, mask, delta = voxel_assign(queries, cfg.grid_size)
    h = torch.relu(gather_patches(table_w1, vox) + delta @ w1_delta + b1)
    layers = params["decoder"]["layers"]
    for lp in layers[1:-1]:
        h = torch.relu(dense_apply(lp, h))
    y = dense_apply(layers[-1], h)
    return _output_activation(y, cfg.output_act)[..., 0] * mask


def dense_point_to_surface(params, cfg: DPDistConfig, cloud, queries, *, state=None,
                           mesh=None, pretransform: str = "auto"):
    """(B, N) float32 learned distances of (B, N, D) query points to the
    surface of the (B, M, D) `cloud` (channel 0, zero outside the grid for
    k > 0).

    state: the BN state (None for a config without BN); the net runs in
    eval mode. mesh: a parallel.Mesh; its 'points' axis shards the queries
    (N must divide by it, else ValueError). pretransform: "auto" | "on" |
    "off", fold the first decoder layer into the patch table (conv_version
    1 without BN, k > 0 only; "auto" at N >= 4 embedding_size).
    """
    if pretransform not in ("auto", "on", "off"):
        raise ValueError(f"pretransform must be 'auto', 'on' or 'off', got {pretransform!r}")
    npoints = 1 if mesh is None else mesh.shape["points"]
    if queries.shape[1] % npoints:
        raise ValueError(f"query axis {queries.shape[1]} not divisible by points={npoints}")
    check_ported(cfg)
    state = _state(cfg, state)
    cloud, queries = _prep(cloud), _prep(queries)
    can_pre = cfg.k > 0 and cfg.conv_version != 3 and not cfg.use_bn
    use_pre = can_pre and (pretransform == "on" or (
        pretransform == "auto" and queries.shape[1] >= 4 * cfg.embedding_size))
    if npoints > 1:
        n = queries.shape[1] // npoints
        i = mesh.index("points")
        queries = queries[:, i * n:(i + 1) * n].contiguous()
    # AB: the queries against the surface of the cloud (this process's
    # queries on a mesh, as the reference routes inside its shard_map).
    r = route(cfg if cfg.fused_gather == "off" else cfg.replace(fused_gather="table"),
              cloud.device.type, cloud.shape[1], queries.shape[1])
    if not use_pre:
        d = _decode_queries(params, state, cfg, cloud, queries, r.encode[0], r.gather[0])
    else:
        table, _ = dpdist_embed(params, state, cfg, cloud, encode=r.encode[0])
        first = params["decoder"]["layers"][0]
        table_w1 = torch.matmul(table.to(torch.float32), first["w"][cfg.dims:])
        d = _decode_queries_pretransformed(params, cfg, queries, table_w1,
                                           first["w"][:cfg.dims], first["b"])
    if npoints == 1:
        return d
    parts = [torch.empty_like(d) for _ in range(npoints)]
    dist.all_gather(parts, d.contiguous(), group=mesh.group("points"))
    return torch.cat(parts, dim=1)


def distance_field(params, cfg: DPDistConfig, cloud, *, state=None, resolution: int = 64,
                   extent: float = 1.0, mesh=None):
    """The learned distance on a dense regular grid: (B, R, R, R) for R =
    resolution points per axis over [-extent, extent], the implicit field
    for level-set / marching-cubes extraction from a trained DPDist. The
    queries are ordered (x, y, z) with z fastest (meshgrid "ij"); a mesh's
    'points' axis shards them (dense_point_to_surface)."""
    r = np.linspace(-extent, extent, resolution).astype(np.float32)
    X, Y, Z = np.meshgrid(r, r, r, indexing="ij")
    q = torch.as_tensor(np.stack([X, Y, Z], -1).reshape(1, -1, 3), device=cloud.device)
    B = cloud.shape[0]
    d = dense_point_to_surface(params, cfg, cloud, q.expand(B, -1, 3), state=state, mesh=mesh)
    return d.reshape(B, resolution, resolution, resolution)
