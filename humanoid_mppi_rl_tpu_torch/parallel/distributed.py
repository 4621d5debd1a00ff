"""Multi-process wiring over torch.distributed (parallel/distributed.py
counterpart): one process per device, the K axis of a replan sharded over
the processes by parallel/mesh, and episodes of a collection split between
them by `episode_shard` (no collective).

`maybe_initialize` is a no-op unless a launcher set one of:
  HUMANOID_MPPI_COORDINATOR   "host:port" (or an init URL) of process 0,
                              with HUMANOID_MPPI_NUM_PROCESSES (the world
                              size) and HUMANOID_MPPI_PROCESS_ID (the rank)
  HUMANOID_MPPI_AUTO_DISTRIBUTED=1
                              take torchrun's MASTER_ADDR, MASTER_PORT,
                              WORLD_SIZE and RANK (init_method "env://")
The backend is NCCL on CUDA and gloo on the CPU. Nothing tells a process
of a cluster otherwise: the address, world size and rank come from these
variables or from the caller's own init_process_group.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    """This process's device index on its host: torchrun's LOCAL_RANK, else
    the rank modulo the visible devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if _initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def maybe_initialize(device="cuda") -> bool:
    """Initialize the default process group from the environment (above);
    else do nothing. `device` picks the backend: NCCL for "cuda" (each
    rank on cuda:LOCAL_RANK), gloo for "cpu". Returns True when the run
    has more than one process after this call."""
    if _initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("HUMANOID_MPPI_COORDINATOR")
    if coord:
        kw = dict(init_method=coord if "://" in coord else f"tcp://{coord}",
                  world_size=int(os.environ["HUMANOID_MPPI_NUM_PROCESSES"]),
                  rank=int(os.environ["HUMANOID_MPPI_PROCESS_ID"]))
    elif os.environ.get("HUMANOID_MPPI_AUTO_DISTRIBUTED") == "1":
        kw = dict(init_method="env://", world_size=int(os.environ["WORLD_SIZE"]),
                  rank=int(os.environ["RANK"]))
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **kw)
    return dist.get_world_size() > 1


def process_info() -> dict:
    """Rank and topology for logs and episode sharding: one device per
    process, so the global device count is the world size."""
    n = dist.get_world_size() if _initialized() else 1
    return {
        "process_id": dist.get_rank() if _initialized() else 0,
        "num_processes": n,
        "local_devices": max(torch.cuda.device_count(), 1),
        "global_devices": n,
    }


def episode_shard(n_episodes: int, shard_index: Optional[int] = None,
                  num_shards: Optional[int] = None) -> range:
    """The episodes this process owns (the reference's run.sh loop split
    between processes): every num_shards-th from shard_index, which default
    to the rank and world size."""
    info = process_info()
    idx = info["process_id"] if shard_index is None else shard_index
    n = info["num_processes"] if num_shards is None else num_shards
    return range(idx, n_episodes, n)
