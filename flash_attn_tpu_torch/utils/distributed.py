"""Multi-process bring-up on a ``torch.distributed`` process group.

Port of flash_attn_tpu/utils/distributed.py: ``initialize`` joins the
process group of a multi-process job (one call a process) and returns
JAX's summary keys; with no coordinator and one process it does nothing.
The coordinator is ``host:port`` (``tcp://`` is put in front), as JAX's
``coordinator_address``; the process count and index come from the
arguments or from ``WORLD_SIZE`` and ``RANK``.  The backend is NCCL where
the process has a card, else gloo.  ``shutdown`` leaves the group; it runs
at exit.  No code of the port runs collectives
across processes yet: its meshes run every rank in one process.
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               timeout_s: float = 300.0) -> dict:
    """Join the process group; a no-op for a single process.  Returns
    {process_index, process_count, local_devices, global_devices}."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if dist.is_initialized() or num_processes == 1 or addr is None:
        return _summary()
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))
    atexit.register(shutdown)
    return _summary()


def shutdown():
    """Leave the process group, as JAX's client shuts down at exit: every
    process waits at a barrier, so none tears down while another still
    talks to its store or its group, then the group is destroyed."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _local_devices() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _summary() -> dict:
    local = _local_devices()
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": local,
                "global_devices": local}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_devices": local, "global_devices": sum(counts)}


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
