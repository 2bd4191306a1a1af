"""SPMD serving: one HTTP front door, N processes in one process group.

Port of `rag_inference_pipeline_tpu/serve/spmd.py`. Every process joins
the gloo group of `core/distributed.py` and holds its own range of the
flat index's rows (`index/flat.py::load_part`: rows [rank * R, (rank + 1)
* R), on its own mesh). A search is a collective: every process must run
it, in the same order.

- process 0 runs the HTTP front door and owns request admission;
- processes 1..N-1 run `worker_loop()`: a blocking loop that receives the
  (header, queries) broadcasts and runs the same search;
- `SPMDIndexProxy` wraps the index on process 0: each `search()` first
  broadcasts a fixed-shape header [op, rows, k, dim] (int32), then the
  query block, so all processes enter the search together; a lock keeps
  two schedulers from interleaving their broadcasts.

A search (`spmd_search`): each process searches its rows (its local mesh's
sharded search when dp > 1), lifts its ids by its part's first row, and
all processes all-gather the [B, k] scores and ids over the group (host
tensors, the reference runs that gather inside its compiled program) and
merge them in rank order. The result equals one `sharded_topk_int8gs` over
a mesh of world x dp positions: ties go to the lower rank.

Workers never search on their own (no warm-up): only the front door's
broadcasts drive them, and its warm-up drives every process through the
same searches. `stop_workers` (OP_STOP) is idempotent; the serving entry
sends it when the front door fails, so workers exit instead of hanging.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core.distributed import is_multiprocess, process_count, process_index
from ..ops.topk import NEG_INF, _topk

logger = logging.getLogger(__name__)

OP_STOP = 0
OP_SEARCH = 1

_HDR_LEN = 4


def _broadcast(x: np.ndarray) -> np.ndarray:
    """Process 0's `x` on every process (same shape and dtype everywhere)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    dist.broadcast(t, src=0)
    return t.numpy()


def is_spmd() -> bool:
    return is_multiprocess()


def is_front_door() -> bool:
    return process_index() == 0


def spmd_search(index, queries: np.ndarray, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This process's part searched, ids lifted to global ids, the parts'
    [B, k] gathered from every process and merged in rank order. Returns
    (scores, ids) on the index's device."""
    s, i = index.search(queries, k)
    i = torch.where(i >= 0, i + getattr(index, "id_offset", 0), -1).to(torch.int32)
    s = torch.where(i >= 0, s, NEG_INF).float()
    s_h, i_h = s.cpu().contiguous(), i.cpu().contiguous()
    world = process_count()
    s_all = [torch.empty_like(s_h) for _ in range(world)]
    i_all = [torch.empty_like(i_h) for _ in range(world)]
    dist.all_gather(s_all, s_h)
    dist.all_gather(i_all, i_h)
    ms, sel = _topk(torch.cat(s_all, dim=1), min(k, world * s_h.shape[1]))
    ids = torch.gather(torch.cat(i_all, dim=1), 1, sel)
    return ms.to(index.device), ids.to(index.device)


class SPMDIndexProxy:
    """Front-door wrapper: broadcast (header, queries), then search.

    Exposes the index surface the serve layer touches (search, ntotal,
    dim, is_loaded, ...); everything else passes through to the wrapped
    part. `ntotal` is the whole artifact's row count."""

    def __init__(self, index: Any) -> None:
        self._inner = index
        self._lock = threading.Lock()
        self._stopped = False

    def __getattr__(self, name: str) -> Any:  # dim, kind, device, ...
        return getattr(self._inner, name)

    @property
    def ntotal(self) -> int:
        return self._inner.ntotal_global

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        q = queries.cpu().numpy() if isinstance(queries, torch.Tensor) else queries
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        with self._lock:
            if self._stopped:
                # the workers are gone: a broadcast now would block forever
                raise RuntimeError("index not ready: SPMD workers stopped")
            _broadcast(np.array([OP_SEARCH, q.shape[0], int(k), q.shape[1]], np.int32))
            _broadcast(q)
            return spmd_search(self._inner, q, k)

    def stop_workers(self) -> None:
        """Broadcast OP_STOP so the workers leave their loops. Idempotent:
        once they have left, a second broadcast would wait on departed
        peers (the serving entry's error path and the index component's
        unload both call this)."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            _broadcast(np.zeros(_HDR_LEN, np.int32))  # op 0 = stop

    def unload(self) -> None:
        self.stop_workers()
        unload = getattr(self._inner, "unload", None)
        if unload is not None:
            unload()


def worker_loop(index: Any) -> int:
    """The search loop of processes 1..N-1: run the front door's broadcast
    searches until OP_STOP arrives. Returns the number of searches run."""
    logger.info("SPMD worker %d/%d entering search loop", process_index(), process_count())
    searches = 0
    while True:
        op, rows, k, dim = (int(v) for v in _broadcast(np.zeros(_HDR_LEN, np.int32)))
        if op == OP_STOP:
            logger.info("SPMD worker %d stopping after %d searches", process_index(), searches)
            return searches
        q = _broadcast(np.zeros((rows, dim), np.float32))
        spmd_search(index, q, k)
        searches += 1
