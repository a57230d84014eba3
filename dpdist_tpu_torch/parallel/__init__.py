"""Parallelism over torch.distributed (port of dpdist_tpu/parallel): the
mesh, synchronous data-parallel train steps, and process initialisation."""

from dpdist_tpu_torch.parallel.distributed import initialize_distributed, process_shard
from dpdist_tpu_torch.parallel.mesh import Mesh, default_mesh, local_mesh, make_mesh
from dpdist_tpu_torch.parallel.shard import build_sharded_train_step, replicate, shard_batch

__all__ = [
    "Mesh",
    "build_sharded_train_step",
    "default_mesh",
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
    "process_shard",
    "replicate",
    "shard_batch",
]
