"""The device mesh (port of dpdist_tpu/parallel/mesh.py).

A mesh of data x points processes, one device each: the 'data' axis
shards the batch of a train step (the reference's replacement of the
original's in-graph GPU towers) and the 'points' axis the query points of
dense evaluation (each query is independent given the embedding, so no
communication but the final gather). Process r sits at
(r // points, r % points), the reference's row-major reshape of its
device list.

Deviation: one process per device, so data * points must equal the
process group's size (the reference takes the first data * points of
jax.devices()). A 1 x 1 mesh needs no process group and makes no
collective: every path on it is the single-device path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dpdist_tpu_torch import resolve_device
from dpdist_tpu_torch.parallel.distributed import world_size

AXES = ("data", "points")


class Mesh:
    """shape: {"data": d, "points": p}; device: this process's device;
    device_mesh: the torch DeviceMesh of dims AXES (None when the world is
    one process, where each axis' group is the default one)."""

    def __init__(self, shape: dict, device: torch.device, device_mesh=None):
        self.shape = dict(shape)
        self.device = device
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of this process's line along `axis` (None: the
        default group)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This process's coordinate along `axis`."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints and logs: on a mesh of
        one process always, else rank 0 alone (deviation: the reference's
        one process wrote for all its devices)."""
        return self.device_mesh is None or dist.get_rank() == 0

    def barrier(self):
        """Wait for every process of a mesh of more than one (after rank 0
        wrote a checkpoint, before any process reads it)."""
        if self.device_mesh is not None:
            dist.barrier()

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def _this_device(device) -> torch.device:
    """`device` with the current card's index where it names CUDA without
    one; raises without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(data: int = 1, points: int = 1, *, device="cuda") -> Mesh:
    """The data x points mesh over the process group (one process per
    device); raises ValueError unless data * points is the group's size
    (1 when no group is up)."""
    n, world = data * points, world_size()
    if data < 1 or points < 1 or n != world:
        raise ValueError(f"mesh {data}x{points} needs data * points equal to the world size "
                         f"{world} (one process per device)")
    dev = _this_device(device)
    device_mesh = None
    if world > 1:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(dev.type, (data, points), mesh_dim_names=AXES)
    return Mesh({"data": data, "points": points}, dev, device_mesh)


def default_mesh(*, device="cuda") -> Mesh:
    """Every process on the data axis."""
    return make_mesh(data=world_size(), device=device)


def local_mesh(device: torch.device) -> Mesh:
    """The 1 x 1 mesh of a single-device path (a trainer's mesh=None): no
    group, no collective, whatever the world."""
    return Mesh({"data": 1, "points": 1}, device)
