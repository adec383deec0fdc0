"""Process-group initialization: the port of
``dpvo_tpu/parallel/multihost.py`` on ``torch.distributed``.

The JAX package runs one process per host over all its local devices and
joins hosts with ``jax.distributed``. The port runs one process per device
(torchrun's layout): every process joins one process group, and the
``(data, edge)`` mesh (``parallel/shard.make_mesh``) spans all of them,
across hosts or not. The same code runs on one host and on many, so the
JAX package's ``global_mesh`` is ``make_mesh`` here and has no name of its
own.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# torchrun's variables, read where the JAX package reads JAX_COORDINATOR_ADDRESS,
# JAX_NUM_PROCESSES and JAX_PROCESS_ID
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: str = "nccl", timeout_s: float = 600.0):
    """Join this process to the process group. No-op if it has joined.

    coordinator_address: ``host:port`` of rank 0's store (TCP), or an
    ``init_method`` URL such as ``file:///path``; num_processes: the world
    size; process_id: this process's rank. Each defaults to torchrun's
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``);
    what is neither given nor set raises, naming it. backend: ``nccl``
    raises where no CUDA device is available or this build of torch lacks
    NCCL (no fallback); ``gloo``, the CPU's, only when named. With NCCL
    the process takes the card ``LOCAL_RANK`` (else its rank) modulo the
    card count."""
    if dist.is_initialized():
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: backend nccl needs a CUDA device and none is "
                           "available; pass backend='gloo' to join a group on the CPU")
    missing = [k for k, v in (("MASTER_ADDR", coordinator_address),
                              ("MASTER_PORT", coordinator_address),
                              ("WORLD_SIZE", num_processes), ("RANK", process_id))
               if v is None and k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: no process group to join: pass the "
                           f"arguments or set {missing} (torchrun sets {list(ENV)})")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: backend nccl, but this torch has no NCCL")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def process_local_batch(global_batch: int, n_data: Optional[int] = None) -> int:
    """One data rank's share of a data-parallel batch: global_batch over
    n_data (the group's world size by default); it must divide evenly."""
    n = n_data if n_data is not None else (dist.get_world_size() if dist.is_initialized() else 1)
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n} data ranks")
    return global_batch // n
