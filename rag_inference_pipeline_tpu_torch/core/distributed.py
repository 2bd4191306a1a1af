"""The process group of a multi-process deployment.

Port of `rag_inference_pipeline_tpu/core/distributed.py`. The reference
joins one `jax.distributed` group per host, after which its global mesh
spans every host's chips and XLA runs the cross-host all-gather of a
sharded search inside the compiled program. Here each process keeps a mesh
of its own devices, and the processes meet in a `torch.distributed` group:

- the group is **gloo over host tensors**. The front door broadcasts the
  request header and the host query block (`serve/spmd.py`, as the
  reference's `multihost_utils.broadcast_one_to_all` of host numpy), and
  the cross-process merge all-gathers each process's [B, k] scores and ids
  on the host. gloo runs two ranks on one card, where NCCL refuses to;
- settings (env): DIST_NUM_PROCESSES, DIST_PROCESS_ID, DIST_COORDINATOR
  (host:port of process 0, reached as `tcp://host:port`).
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# a worker waits in a broadcast for the next request for as long as the
# deployment is idle: the group's collective timeout must not end it
_GROUP_TIMEOUT = datetime.timedelta(days=30)


def init_distributed(settings) -> bool:
    """Join the gloo process group when DIST_NUM_PROCESSES > 1 (idempotent;
    a no-op for one process). Returns True when running multi-process."""
    if getattr(settings, "dist_num_processes", 1) <= 1:
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{settings.dist_coordinator}",
        world_size=settings.dist_num_processes,
        rank=settings.dist_process_id,
        timeout=_GROUP_TIMEOUT,
    )
    logger.info(
        "process group up: rank %d of %d (gloo at %s)",
        dist.get_rank(), dist.get_world_size(), settings.dist_coordinator,
    )
    return True


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def process_count() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def validate_mesh_for_hosts(dp: int, tp: int, local: Optional[int] = None) -> None:
    """tp must not straddle processes: a tp group split over the host link
    would put every layer's all-reduce on the slow path. dp crossing
    processes is the intended axis. `local` is the process's device count."""
    if local is None:
        local = torch.cuda.device_count() or 1
    if tp > local:
        raise ValueError(
            f"tp={tp} exceeds local device count {local}: tensor-parallel "
            "groups must stay inside one process's devices"
        )
    if local % tp:
        raise ValueError(
            f"local device count {local} not divisible by tp={tp}; tp "
            "groups would straddle processes"
        )
