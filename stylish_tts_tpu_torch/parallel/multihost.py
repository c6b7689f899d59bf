"""Process-group set-up for data-parallel training: one process per card.

The JAX package drives every local device from one process and reaches
other hosts through ``jax.distributed.initialize``; the port runs one
process per card (or per CPU worker under gloo), each with its rank in a
``torch.distributed`` process group.  ``initialize_distributed`` finds the
group the way ``jax.distributed.initialize`` finds its cluster: from the
arguments where all three are given, else from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# every collective of a run fails after this long instead of hanging
COLLECTIVE_TIMEOUT_S = 600.0


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           *, device: Optional[torch.device] = None,
                           timeout_s: float = COLLECTIVE_TIMEOUT_S
                           ) -> torch.device:
    """Join the process group (idempotent) and return this process's
    device: ``cuda:LOCAL_RANK`` (made current) for a CUDA ``device``, else
    ``device``.  ``coordinator`` is ``host:port`` of rank 0; NCCL serves
    CUDA, gloo the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        local_rank = int(os.environ.get(
            "LOCAL_RANK", 0 if process_id is None
            else process_id % max(torch.cuda.device_count(), 1)))
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    given = (coordinator, num_processes, process_id)
    if all(v is not None for v in given):
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif any(v is not None for v in given):
        raise ValueError("give --coordinator, --num-processes and "
                         "--process-id together, or none of them (torchrun's "
                         "environment)")
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    return device


def shutdown_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 writes logs, figures, statistics and checkpoints."""
    return process_index() == 0
