"""Process groups: one rank is one process on one card (counterpart of
``tfswa_tpu/parallel/distributed.py``).

  - :func:`initialize_distributed`: one call before any collective.  The
    ranks come from the three flags of the training CLI (a coordinator,
    the number of processes and this process's id), or from a launcher's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (``torchrun``).  With
    neither it is a no-op that returns False, so the same script runs on
    one card unchanged; a second call is a no-op too.
  - :func:`rank_device`: the rank's device, ``cuda:LOCAL_RANK`` unless the
    CPU is asked for.
  - :func:`process_info`: (rank, world size), the data-sharding coordinates.
  - :func:`make_global_batch`: this rank's slice of a global batch on its
    device.  No rank ever holds the global batch: each step takes its own
    slice (``data.pipeline.DataLoader(num_shards, shard_index)`` loads only
    that slice).

The backend is NCCL for the card and gloo for the CPU, unless the caller
names one (two ranks that share one card run gloo on CUDA tensors).
Nothing falls back from one backend or device to another.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group; returns True when the world has more than
    one rank.

    ``coordinator_address`` is ``host:port`` of rank 0 (a TCP store), or a
    URL the process group takes as its ``init_method`` (``file://...``
    for a file store); it needs ``num_processes`` and ``process_id``.
    Without it the launcher's environment (``env://``) is read when
    ``WORLD_SIZE`` or ``num_processes`` says more than one process.  The
    local rank is ``LOCAL_RANK``, else ``process_id`` modulo the cards
    this process sees."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and num_processes in (None, 1) and env_world <= 1:
        return False
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    else:
        init_method = "env://"
        world = num_processes if num_processes is not None else env_world
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    local = int(os.environ.get("LOCAL_RANK", rank % max(cards, 1)))
    if dev.type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return dist.get_world_size() > 1


def rank_device(device="cuda") -> torch.device:
    """``cuda`` -> this rank's card (``cuda:LOCAL_RANK``, the current device
    :func:`initialize_distributed` set); any other device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) outside a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_global_batch(local_batch, mesh):
    """This rank's slice of the global batch (a tensor, an array or a dict
    of them, ``global_batch / d`` rows in the order of the ``data`` axis)
    on the rank's device."""
    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        return t.to(mesh.device)

    if isinstance(local_batch, dict):
        return {k: put(v) for k, v in local_batch.items()}
    return put(local_batch)
