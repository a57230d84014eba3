"""Multi-process initialisation (port of dpdist_tpu/parallel/distributed.py).

One process per device: torchrun (or any launcher that sets its
environment) starts them, and `initialize_distributed` joins them into one
`torch.distributed` process group. Afterwards the same mesh and the same
sharded steps run in every process; per-process data loading can take its
share of the input files with `process_shard`.

Deviation: torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK, LOCAL_RANK) takes the place of the reference's JAX_COORDINATOR,
JAX_NUM_PROCESSES and JAX_PROCESS_ID.

    torchrun --nproc_per_node 4 -m dpdist_tpu_torch.cli.train_dpdist ...
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda") -> bool:
    """Join the process group if the arguments or the environment ask for it.

    coordinator: "host:port" or an init_method URL ("tcp://...",
    "file://..."); without it MASTER_ADDR and MASTER_PORT are read, and
    WORLD_SIZE and RANK stand in for num_processes and process_id. Without
    a coordinator in either, nothing starts and the call returns False.

    device: the device each process trains on. On CUDA the process takes
    the card LOCAL_RANK names (else process_id's) and the group runs on
    NCCL; on the CPU on gloo. Returns True once the group is up.
    """
    if coordinator is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    return True


def process_shard(items, *, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """items[i::P] for process i of P: the group's rank and size when a
    group is up, else process 0 of 1."""
    up = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if up else 0)
    pc = process_count if process_count is not None else (dist.get_world_size() if up else 1)
    return list(items)[pi::pc]


def world_size() -> int:
    """The process group's size, 1 when no group is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

