"""Named thread pools for CPU-bound host work.

Port of `rag_inference_pipeline_tpu/utils/executors.py:1-49`: one
`ThreadPoolExecutor` per name, sized to the cores (at most 8);
`run_cpu_bound` runs a sync function in a named pool without blocking the
event loop; `shutdown_all` joins every pool. Nothing in the reference calls
it, and nothing in the port does: it is ported as it is, for host work
(tokenizing, doc-store fan-out) that a later caller moves off the loop's
default executor.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
from typing import Any, Callable, Optional

_lock = threading.Lock()
_pools: dict[str, concurrent.futures.ThreadPoolExecutor] = {}


def get_executor(
    name: str, max_workers: Optional[int] = None
) -> concurrent.futures.ThreadPoolExecutor:
    with _lock:
        pool = _pools.get(name)
        if pool is None:
            workers = max_workers or min(8, os.cpu_count() or 4)
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"ragtorch-{name}"
            )
            _pools[name] = pool
        return pool


async def run_cpu_bound(name: str, fn: Callable[..., Any], *args) -> Any:
    """`fn(*args)` in the named pool, awaited from the event loop."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(get_executor(name), fn, *args)


def shutdown_all(wait: bool = True) -> None:
    """Shut every pool down (and forget it)."""
    with _lock:
        pools = list(_pools.values())
        _pools.clear()
    for pool in pools:
        pool.shutdown(wait=wait)
