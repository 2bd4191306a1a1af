"""Opportunistic batch scheduler with an adaptive flush delay.

Port of `rag_inference_pipeline_tpu/engine/batcher.py`, with its metrics
(reference `:31`, `:136-140`): `BATCH_SIZE`, `QUEUE_DEPTH`, `BATCH_WAIT`
and `BATCH_FLUSH` by reason, labelled (run_id, node, name). `enqueue`
returns an awaited future; the pending batch
flushes when full or when its timer fires; the adaptive policy shortens
the delay as an EWMA of recent queue depths grows; a failed batch fails
every future in it, a per-item exception only its own; with
`flush_on_ready` a completing batch flushes the pending one at once
(reason "ready"). Unlike the reference (`batcher.py:287`), `stop()` also
cancels a pending timer task.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from ..telemetry.metrics import BATCH_FLUSH, BATCH_SIZE, BATCH_WAIT, QUEUE_DEPTH

logger = logging.getLogger(__name__)


class AdaptiveBatchPolicy:
    """EWMA over the last `window` queue depths; the delay falls linearly
    from max_delay (idle) to min_delay (queue >= batch_size)."""

    def __init__(
        self, batch_size: int, max_delay_s: float, min_delay_s: float = 0.005,
        window: int = 10,
    ) -> None:
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.min_delay_s = min(min_delay_s, max_delay_s)
        self._depths: deque[int] = deque(maxlen=window)

    def observe(self, depth: int) -> None:
        self._depths.append(depth)

    @property
    def ewma_depth(self) -> float:
        if not self._depths:
            return 0.0
        ewma = float(self._depths[0])
        for d in list(self._depths)[1:]:
            ewma = 0.7 * ewma + 0.3 * d
        return ewma

    def current_delay(self) -> float:
        load = min(1.0, self.ewma_depth / max(1, self.batch_size))
        return self.max_delay_s - load * (self.max_delay_s - self.min_delay_s)


class FixedBatchPolicy:
    def __init__(self, batch_size: int, delay_s: float) -> None:
        self.batch_size = batch_size
        self._delay = delay_s

    def observe(self, depth: int) -> None:  # noqa: ARG002
        pass

    def current_delay(self) -> float:
        return self._delay


@dataclass
class Batch:
    items: list = field(default_factory=list)
    futures: list = field(default_factory=list)
    created: float = field(default_factory=time.monotonic)


class BatchScheduler:
    """enqueue(item) -> awaited result; `process_fn` takes a list of items
    and returns one result (or exception) per item, in order. It may be
    sync (run in the loop's default executor) or async."""

    def __init__(
        self,
        process_fn: Callable,
        *,
        batch_size: int,
        timeout_s: float,
        name: str = "scheduler",
        adaptive: bool = True,
        min_delay_s: float = 0.005,
        flush_on_ready: bool = True,
        run_id: str = "dev",
        node: str = "0",
    ) -> None:
        self.process_fn = process_fn
        self.batch_size = batch_size
        self.name = name
        self.policy = (
            AdaptiveBatchPolicy(batch_size, timeout_s, min_delay_s)
            if adaptive else FixedBatchPolicy(batch_size, timeout_s)
        )
        self.flush_on_ready = flush_on_ready
        self._min_delay_s = min(min_delay_s, timeout_s)
        self._backstop_s = timeout_s
        self._inflight = 0
        self._batch = Batch()
        self._lock = asyncio.Lock()
        self._timer: Optional[asyncio.Task] = None
        self._tasks: set[asyncio.Task] = set()
        self._closed = False
        self.flushes = {r: 0 for r in ("full", "timeout", "ready", "shutdown")}
        labels = (run_id, node, name)
        self._m_size = BATCH_SIZE.labels(*labels)
        self._m_depth = QUEUE_DEPTH.labels(*labels)
        self._m_wait = BATCH_WAIT.labels(*labels)
        self._m_flush = {r: BATCH_FLUSH.labels(*labels, r) for r in self.flushes}

    async def enqueue(self, item: Any) -> Any:
        return (await self.enqueue_many([item]))[0]

    async def enqueue_many(self, items: Sequence[Any]) -> list:
        """Enqueue a request's items under one lock acquisition: full
        batches flush as they fill, the rest waits on the timer."""
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in items]
        async with self._lock:
            if self._closed:
                raise RuntimeError(f"scheduler {self.name} is stopped")
            for item, fut in zip(items, futs):
                if not self._batch.items:
                    self._batch.created = time.monotonic()
                self._batch.items.append(item)
                self._batch.futures.append(fut)
                if len(self._batch.items) >= self.batch_size:
                    self._flush_locked("full")
            depth = len(self._batch.items)
            self.policy.observe(depth)
            self._m_depth.set(depth)
            if self._batch.items and self._timer is None:
                self._timer = asyncio.create_task(self._timer_task())
        return list(await asyncio.gather(*futs))

    async def _timer_task(self) -> None:
        # with flush_on_ready and nothing in flight the timer only
        # coalesces a burst; with work in flight completions clock the
        # batches and the timer is a long backstop (the reference's policy)
        if self.flush_on_ready:
            delay = (
                self._min_delay_s if self._inflight == 0
                else max(self.policy.current_delay(), 10.0 * self._backstop_s)
            )
        else:
            delay = self.policy.current_delay()
        try:
            await asyncio.sleep(delay)
        except asyncio.CancelledError:
            return
        async with self._lock:
            self._timer = None
            if self._batch.items:
                self._flush_locked("timeout")

    def _flush_locked(self, reason: str) -> None:
        batch, self._batch = self._batch, Batch()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        wait_s = time.monotonic() - batch.created
        self.flushes[reason] += 1
        self._m_flush[reason].inc()
        self._m_size.observe(len(batch.items))
        self._m_wait.observe(wait_s)
        self._m_depth.set(0)
        logger.debug(
            'batch_flush {"name": "%s", "reason": "%s", "size": %d, "wait_ms": %.1f}',
            self.name, reason, len(batch.items), wait_s * 1e3,
        )
        task = asyncio.create_task(self._run_batch(batch))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run_batch(self, batch: Batch) -> None:
        self._inflight += 1
        try:
            items = list(batch.items)
            if inspect.iscoroutinefunction(self.process_fn):
                results = await self.process_fn(items)
            else:
                results = await asyncio.get_running_loop().run_in_executor(
                    None, self.process_fn, items
                )
            if results is None or len(results) != len(batch.items):
                raise RuntimeError(
                    f"{self.name}: process_fn returned "
                    f"{0 if results is None else len(results)} results for "
                    f"{len(batch.items)} items"
                )
            for fut, res in zip(batch.futures, results):
                if fut.done():
                    continue
                if isinstance(res, BaseException):
                    fut.set_exception(res)
                else:
                    fut.set_result(res)
        except Exception as exc:  # noqa: BLE001 — fail the whole batch
            logger.exception("%s: batch of %d failed", self.name, len(batch.items))
            for fut in batch.futures:
                if not fut.done():
                    fut.set_exception(exc)
        finally:
            self._inflight -= 1
            if self.flush_on_ready:
                async with self._lock:
                    if self._batch.items and not self._closed:
                        self._flush_locked("ready")

    async def stop(self) -> None:
        """Flush pending work (reason "shutdown"), cancel the timer and wait
        for the batches in flight."""
        async with self._lock:
            self._closed = True
            if self._batch.items:
                self._flush_locked("shutdown")
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
            self._tasks.clear()
