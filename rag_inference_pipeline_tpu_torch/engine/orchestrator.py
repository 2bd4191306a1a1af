"""Gateway orchestrator: query cache + batch scheduler + a three-stage
asyncio pipeline (retrieval -> generation -> postproc).

Port of `rag_inference_pipeline_tpu/engine/orchestrator.py` over local
stages: queries coalesce in a `BatchScheduler`; each flushed batch splits
into `gateway_pipeline_chunks` chunks that feed three long-lived asyncio
workers joined by queues, so chunk N+1's retrieval overlaps chunk N's
generation; a stage error fails every request of its chunk. With
`use_continuous_batching` the generation stage awaits the service's
`process_batch_async` (the decode engine) instead of running its batch
path in a thread. A node without local retrieval and generation stages
would need the RPC hop of the serving stack, which is not ported: the
constructor refuses it.
With a fused executor whose `is_loaded` is true, one fused step replaces
the pipeline and completions clock the batches (`flush_on_ready`); the
reference gates that on the executor existing (`orchestrator.py:102`).
"""

from __future__ import annotations

import asyncio
import logging
import re
from typing import Any, Optional

from ..core.config import Settings
from ..utils.cache import LRUCache
from .batcher import BatchScheduler

logger = logging.getLogger(__name__)

_WS = re.compile(r"\s+")


def normalize_query(q: str) -> str:
    return _WS.sub(" ", q.strip().lower())


def fuzzy_key(q: str) -> str:
    """Token-sort key (QUERY_CACHE_FUZZY)."""
    return " ".join(sorted(_WS.split(q.strip().lower())))


class PipelineChunk:
    __slots__ = ("items", "futures", "retrieval", "generation")

    def __init__(self, items: list[dict], futures: list[asyncio.Future]):
        self.items = items
        self.futures = futures
        self.retrieval: Optional[list[dict]] = None
        self.generation: Optional[list[dict]] = None

    def fail(self, exc: Exception) -> None:
        for f in self.futures:
            if not f.done():
                f.set_exception(exc)


class Orchestrator:
    def __init__(
        self,
        settings: Settings,
        *,
        retrieval_executor=None,
        generation_service=None,
        fused_executor=None,
    ) -> None:
        fused = fused_executor is not None and fused_executor.is_loaded
        if not fused and (retrieval_executor is None or generation_service is None):
            raise NotImplementedError(
                "the orchestrator needs local retrieval and generation stages: "
                "the RPC hop to other nodes is not ported yet (ROADMAP.md)"
            )
        self.settings = settings
        self.retrieval_executor = retrieval_executor
        self.generation_service = generation_service
        self.fused_executor = fused_executor
        self.query_cache = LRUCache(
            settings.query_cache_capacity, ttl_s=settings.query_cache_ttl_s
        )
        self.scheduler = BatchScheduler(
            self._process_batch,
            batch_size=settings.gateway_batch_size,
            timeout_s=settings.gateway_batch_timeout_ms / 1e3,
            adaptive=settings.adaptive_batching,
            min_delay_s=settings.adaptive_min_delay_ms / 1e3,
            # completion clocking fits a serial downstream (one fused step);
            # the staged pipeline wants overlapping batches in flight
            flush_on_ready=settings.batch_flush_on_ready and fused,
            name="gateway",
        )
        self._retrieval_q: asyncio.Queue = asyncio.Queue()
        self._generation_q: asyncio.Queue = asyncio.Queue()
        self._postproc_q: asyncio.Queue = asyncio.Queue()
        self._workers: list[asyncio.Task] = []

    @property
    def is_loaded(self) -> bool:
        return True

    async def start(self) -> None:
        if not self._workers:
            self._workers = [
                asyncio.create_task(self._retrieval_worker()),
                asyncio.create_task(self._generation_worker()),
                asyncio.create_task(self._postproc_worker()),
            ]

    async def stop(self) -> None:
        """Flush the scheduler, then a None sentinel through the queues."""
        await self.scheduler.stop()
        if self._workers:
            await self._retrieval_q.put(None)
            await asyncio.gather(*self._workers, return_exceptions=True)
            self._workers = []

    async def process_query(self, query: str, request_id: str, k=None) -> dict:
        key = (
            fuzzy_key(query) if self.settings.query_cache_fuzzy
            else normalize_query(query),
            k or self.settings.retrieval_k,  # k changes the answer
        )
        cached = self.query_cache.get(key)
        if cached is not None:
            return {**cached, "request_id": request_id}
        result = await self.scheduler.enqueue({"query": query, "k": k})
        self.query_cache.put(key, dict(result))
        return {**result, "request_id": request_id}

    async def _process_batch(self, items: list[dict]) -> list[Any]:
        loop = asyncio.get_running_loop()
        if self.fused_executor is not None and self.fused_executor.is_loaded:
            return await loop.run_in_executor(
                None, self.fused_executor.process_batch, items
            )
        n_chunks = max(1, min(self.settings.gateway_pipeline_chunks, len(items)))
        size = (len(items) + n_chunks - 1) // n_chunks
        futures: list[asyncio.Future] = []
        chunks = []
        for s in range(0, len(items), size):
            chunk_futs = [loop.create_future() for _ in items[s : s + size]]
            futures.extend(chunk_futs)
            chunks.append(PipelineChunk(items[s : s + size], chunk_futs))
        for c in chunks:
            await self._retrieval_q.put(c)
        # exceptions stay per item: the scheduler maps them back one by one
        return list(await asyncio.gather(*futures, return_exceptions=True))

    async def _retrieval_worker(self) -> None:
        while True:
            chunk = await self._retrieval_q.get()
            if chunk is None:
                await self._generation_q.put(None)
                return
            try:
                chunk.retrieval = await self._do_retrieval(chunk.items)
                await self._generation_q.put(chunk)
            except Exception as exc:  # noqa: BLE001 — fail this chunk only
                logger.exception("retrieval stage failed")
                chunk.fail(exc)

    async def _generation_worker(self) -> None:
        while True:
            chunk = await self._generation_q.get()
            if chunk is None:
                await self._postproc_q.put(None)
                return
            try:
                chunk.generation = await self._do_generation(
                    chunk.items, chunk.retrieval
                )
                await self._postproc_q.put(chunk)
            except Exception as exc:  # noqa: BLE001 — fail this chunk only
                logger.exception("generation stage failed")
                chunk.fail(exc)

    async def _postproc_worker(self) -> None:
        while True:
            chunk = await self._postproc_q.get()
            if chunk is None:
                return
            for fut, gen in zip(chunk.futures, chunk.generation):
                if not fut.done():
                    fut.set_result({
                        "generated_response": gen["generated_response"],
                        "sentiment": gen.get("sentiment", "neutral"),
                        "is_toxic": bool(gen.get("is_toxic", False)),
                    })

    async def _do_retrieval(self, items: list[dict]) -> list[dict]:
        payload = [{"query": it["query"], "k": it.get("k")} for it in items]
        return await asyncio.get_running_loop().run_in_executor(
            None, self.retrieval_executor.process_batch, payload
        )

    async def _do_generation(
        self, items: list[dict], retrieval: list[dict]
    ) -> list[dict]:
        payload = []
        for it, ret in zip(items, retrieval):
            entry: dict[str, Any] = {"query": it["query"]}
            if ret.get("documents") is not None:
                entry["documents"] = ret["documents"]
            else:
                entry["doc_ids"] = ret.get("ids", [])
            payload.append(entry)
        if self.settings.use_continuous_batching:
            return await self.generation_service.process_batch_async(payload)
        return await asyncio.get_running_loop().run_in_executor(
            None, self.generation_service.process_batch, payload
        )
