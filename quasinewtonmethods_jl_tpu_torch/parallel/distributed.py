"""Process-group initialization — the PyTorch port of
``quasinewtonmethods_jl_tpu/parallel/distributed.py``.

JAX runs one process per host and sees every local device; PyTorch runs
one process per device. A fleet script is the same on one card or many:

    from quasinewtonmethods_jl_tpu_torch.parallel import distributed as dist
    dist.initialize()                      # no-op without a cluster environment
    mesh = make_mesh({"data": dist.host_count()})
    res = optimize_batched_sharded(obj, x0s, mesh)   # global in, global out

Started by ``torchrun`` (which sets MASTER_ADDR, WORLD_SIZE, RANK and
LOCAL_RANK), `initialize` joins the default process group over NCCL and
makes ``cuda:{LOCAL_RANK}`` the process's card. The backend is NCCL unless
the caller names another (the CPU tests name gloo); nothing switches it
silently.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_distributed", "host_count", "process_index"]

_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group if a cluster is configured; a no-op
    otherwise, and when a group is already initialized.

    ``coordinator_address``: ``host:port`` (TCP) or a ``scheme://`` init
    method (``file:///path`` for a FileStore), with ``num_processes`` and
    ``process_id``; without it, torchrun's environment. ``backend``:
    'nccl' by default, 'gloo' only when named."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None
    if not (explicit or all(os.environ.get(v) for v in _TORCHRUN_ENV)):
        return  # a single process: nothing to do
    backend = backend or "nccl"
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(local_device_index(rank))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)


def local_device_index(rank: Optional[int] = None) -> int:
    """This process's card: LOCAL_RANK where torchrun set it, else the rank,
    modulo the cards the host has (several ranks may share one card)."""
    if rank is None:
        rank = process_index()
    local = int(os.environ.get("LOCAL_RANK", rank))
    count = torch.cuda.device_count()
    return local % count if count else local


def is_distributed() -> bool:
    return host_count() > 1


def host_count() -> int:
    """The processes of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0
