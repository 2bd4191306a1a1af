"""Service logic of the staged path: the retrieval executor and the
generation service.

Port of `rag_inference_pipeline_tpu/serve/services.py`:

- `RetrievalExecutor`: embed (a provided embedding, else the embedder) ->
  index search behind a search cache keyed by the SHA-256 of the embedding
  and k, with k bucketed up a ladder and batches cut and padded to the
  shape buckets -> doc fetch by payload mode (`full` documents, `id_only`
  ids and scores, or `compressed`: the documents as `compressed_docs`,
  base64 of zstd of their JSON) -> optional rerank.
- `GenerationService`: the documents handed over (unpacked, or fetched by
  id from this node's doc store) -> rerank -> LLM -> sentiment ->
  toxicity; a toxic answer is replaced by `TOXIC_PLACEHOLDER`.
  `process_batch` runs the LLM per bucketed batch; `process_batch_async`
  submits each request to the continuous-batching decode engine.

Telemetry, as the reference's: a stage timer (`_StageTimer`, reference
`:39-44`) observes `STAGE_DURATION` for `embed`, `search` and `fetch`
(service `retrieval`), and for `rerank`, `llm`, `sentiment` and `toxicity`
(service `generation`; engine mode times `llm` only); the sampled profiler
tracks the same stages and `prepare_docs` (reference `:95-100`,
`:263-289`), and observes a sampled stage a second time, as the
reference's does. Each stage ends where its result is on the host already
(`encode` and the classifiers return numpy, the search reads its scores
and ids with `.cpu()`, the LLM its tokens), so the host clock times the
device work; nothing synchronizes for the timers' sake.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import time
from typing import Any, Optional, Sequence

import numpy as np

from ..core.config import Settings
from ..core.enums import PayloadMode
from ..engine.fused_executor import TOXIC_PLACEHOLDER
from ..telemetry.metrics import STAGE_DURATION
from ..telemetry.profiling import SampledStageProfiler
from ..utils.cache import LRUCache
from ..utils.shapes import chunk_spans, pad_rows, pick_bucket
from .compression import pack_docs, unpack_docs


class _StageTimer:
    def __init__(self, settings: Settings, service: str) -> None:
        self._labels = (settings.run_id, str(settings.node_number), service)

    @contextlib.contextmanager
    def time(self, stage: str):
        t0 = time.monotonic()
        yield
        STAGE_DURATION.labels(*self._labels, stage).observe(time.monotonic() - t0)


class RetrievalExecutor:
    """Batch retrieval: embed -> ANN search -> doc fetch [-> rerank]."""

    def __init__(
        self, settings: Settings, *, index, embedder=None, doc_store=None,
        reranker=None,
    ) -> None:
        self.settings = settings
        self.index = index
        self.embedder = embedder
        self.doc_store = doc_store
        self.reranker = reranker
        self.search_cache = LRUCache(
            settings.search_cache_capacity, name="search",
            run_id=settings.run_id, node=str(settings.node_number),
        )
        self._timer = _StageTimer(settings, "retrieval")
        self.profiler = SampledStageProfiler(settings, "retrieval")
        self._buckets = tuple(sorted(settings.shape_buckets))
        self._k_ladder = tuple(sorted({settings.retrieval_k, 16, 32, 64, 128}))

    @property
    def is_loaded(self) -> bool:
        return True

    def ready(self, items: Sequence[dict]) -> Optional[str]:
        """The index must be loaded; the embedder only when an item has no
        embedding."""
        if self.index is None or not self.index.is_loaded:
            return "index not loaded"
        needs_embed = any(i.get("embedding") is None for i in items)
        if needs_embed and (self.embedder is None or not self.embedder.is_loaded):
            return "embedder not loaded and request has no embeddings"
        return None

    def process_batch(self, items: list[dict]) -> list[dict]:
        """items: [{query, embedding?, k?, rerank?}] -> result dicts."""
        why = self.ready(items)
        if why:
            raise RuntimeError(f"retrieval not ready: {why}")
        prof, timer = self.profiler.maybe_start(), self._timer
        with prof.track("embed"), timer.time("embed"):
            embs = self._get_embeddings(items)
        with prof.track("search"), timer.time("search"):
            ids, scores = self._search_with_cache(embs, items)
        with prof.track("fetch"), timer.time("fetch"):
            results = self._build_results(items, ids, scores)
        prof.finish()
        return results

    def _get_embeddings(self, items: Sequence[dict]) -> np.ndarray:
        need = [i for i, it in enumerate(items) if it.get("embedding") is None]
        dim = self.settings.index_dim
        out = np.zeros((len(items), dim), np.float32)
        for i, it in enumerate(items):
            if it.get("embedding") is not None:
                emb = np.asarray(it["embedding"], np.float32)
                if emb.shape != (dim,):
                    raise ValueError(f"item {i}: embedding dim {emb.shape} != ({dim},)")
                out[i] = emb
        if need:
            enc = self.embedder.encode([items[i].get("query", "") for i in need])
            if enc.shape[1] != dim:
                raise ValueError(f"embedder dim {enc.shape[1]} != index dim {dim}")
            out[need] = enc
        return out

    def _search_with_cache(
        self, embs: np.ndarray, items: Sequence[dict]
    ) -> tuple[list[list[int]], list[list[float]]]:
        k_default = self.settings.retrieval_k
        ids_out: list[Any] = [None] * len(items)
        scores_out: list[Any] = [None] * len(items)
        miss_rows, miss_keys = [], []
        for i, it in enumerate(items):
            key = (hashlib.sha256(embs[i].tobytes()).hexdigest(), it.get("k") or k_default)
            hit = self.search_cache.get(key)
            if hit is not None:
                ids_out[i], scores_out[i] = hit
            else:
                miss_rows.append(i)
                miss_keys.append(key)
        if miss_rows:
            k_max = max((items[i].get("k") or k_default) for i in miss_rows)
            # k up the ladder, never below k_max, never above ntotal
            k_eff = (
                pick_bucket(k_max, self._k_ladder)
                if k_max <= self._k_ladder[-1] else k_max
            )
            ntotal = getattr(self.index, "ntotal", 0) or k_eff
            k_eff = max(k_max, min(k_eff, ntotal))
            miss_embs = embs[miss_rows]
            s_parts, idx_parts = [], []
            for lo, hi in chunk_spans(len(miss_rows), self._buckets[-1]):
                qpad = pad_rows(miss_embs[lo:hi], pick_bucket(hi - lo, self._buckets))
                s_b, idx_b = self.index.search(qpad, k_eff)
                s_parts.append(s_b.cpu().numpy()[: hi - lo])
                idx_parts.append(idx_b.cpu().numpy()[: hi - lo])
            s = np.concatenate(s_parts)
            idx = np.concatenate(idx_parts)
            for j, i in enumerate(miss_rows):
                k = items[i].get("k") or k_default
                row_ids = [int(x) for x in idx[j, :k] if x >= 0]
                row_scores = [float(x) for x in s[j, : len(row_ids)]]
                ids_out[i], scores_out[i] = row_ids, row_scores
                self.search_cache.put(miss_keys[j], (row_ids, row_scores))
        return ids_out, scores_out

    def _build_results(
        self, items: Sequence[dict], ids: list[list[int]], scores: list[list[float]]
    ) -> list[dict]:
        mode = self.settings.documents_payload_mode
        results = []
        for i, it in enumerate(items):
            res: dict[str, Any] = {"ids": ids[i], "scores": scores[i]}
            results.append(res)
            if mode is PayloadMode.ID_ONLY:
                continue
            if self.doc_store is not None and self.doc_store.is_loaded:
                docs = self.doc_store.fetch_documents_batch(
                    ids[i], truncate_length=self.settings.truncate_length
                )
            else:  # stub docs, as the reference
                docs = [{"id": d, "title": f"doc_{d}", "content": ""} for d in ids[i]]
            for d, sc in zip(docs, scores[i]):
                d["score"] = sc
            if it.get("rerank") and self.reranker is not None:
                docs = self.reranker.rerank(it.get("query", ""), docs, top_n=len(docs))
            if mode is PayloadMode.COMPRESSED:
                res["compressed_docs"] = pack_docs(
                    docs, level=self.settings.compression_level
                )
            else:
                res["documents"] = docs
        return results


class GenerationService:
    """Batch generation: docs -> rerank -> LLM -> sentiment -> toxicity."""

    def __init__(
        self, settings: Settings, *, llm, reranker=None, sentiment=None,
        toxicity=None, doc_store=None,
    ) -> None:
        if settings.documents_payload_mode is PayloadMode.ID_ONLY and doc_store is None:
            raise ValueError(
                "documents_payload_mode=id_only requires a doc store on the "
                "generation node"
            )
        self.settings = settings
        self.llm = llm
        self.reranker = reranker
        self.sentiment = sentiment
        self.toxicity = toxicity
        self.doc_store = doc_store
        self._timer = _StageTimer(settings, "generation")
        self.profiler = SampledStageProfiler(settings, "generation")

    @property
    def is_loaded(self) -> bool:
        return True

    def process_batch(self, items: list[dict]) -> list[dict]:
        """items: [{query, documents? | doc_ids?}] -> [{generated_response,
        sentiment, is_toxic}]."""
        self._check_llm()
        prof, timer = self.profiler.maybe_start(), self._timer
        queries = [it.get("query", "") for it in items]
        with prof.track("prepare_docs"):
            docs_batch = [self._prepare_documents(it) for it in items]
        with prof.track("rerank"), timer.time("rerank"):
            docs_batch = self._rerank(queries, docs_batch)
        with prof.track("llm"), timer.time("llm"):
            texts = self.llm.generate_batch(queries, docs_batch)
        with prof.track("sentiment"), timer.time("sentiment"):
            sentiments = self._sentiments(texts)
        with prof.track("toxicity"), timer.time("toxicity"):
            tox = self._toxicity(texts)
        prof.finish()
        return self._response(texts, sentiments, tox)

    async def process_batch_async(self, items: list[dict]) -> list[dict]:
        """Engine mode: documents, rerank and the classifiers run as
        bucketed batches in executor threads; the LLM stage submits each
        request to the decode engine. Where the reference falls back to
        the batch path when the engine is not running, this raises, so
        that a failed engine cannot hide behind the batch path."""
        self._check_llm()
        if getattr(self.llm, "engine", None) is None:
            raise RuntimeError("generation not ready: the decode engine is not running")
        loop = asyncio.get_running_loop()
        queries = [it.get("query", "") for it in items]
        docs_batch = await loop.run_in_executor(None, self._documents, queries, items)
        with self._timer.time("llm"):
            texts = await self.llm.generate_batch_engine(queries, docs_batch)
        return await loop.run_in_executor(None, self._finish, texts)

    def _check_llm(self) -> None:
        if self.llm is None or not self.llm.is_loaded:
            raise RuntimeError("generation not ready: llm not loaded")

    def _documents(self, queries: list[str], items: list[dict]) -> list[list[dict]]:
        """Each item's documents, reranked (or cut) to `rerank_top_n`."""
        return self._rerank(queries, [self._prepare_documents(it) for it in items])

    def _rerank(self, queries: list[str], docs_batch: list[list[dict]]) -> list[list[dict]]:
        top_n = self.settings.rerank_top_n
        if self.reranker is not None and self.reranker.is_loaded:
            return self.reranker.rerank_batch(queries, docs_batch, top_n=top_n)
        return [d[:top_n] for d in docs_batch]

    def _sentiments(self, texts: list[str]) -> list[str]:
        if self.sentiment is not None and self.sentiment.is_loaded:
            return self.sentiment.analyze_batch(texts)
        return ["neutral"] * len(texts)

    def _toxicity(self, texts: list[str]) -> list[tuple[bool, float]]:
        if self.toxicity is not None and self.toxicity.is_loaded:
            return self.toxicity.check_batch(texts)
        return [(False, 0.0)] * len(texts)

    def _finish(self, texts: list[str]) -> list[dict]:
        """Sentiment and toxicity of the answers -> the response items."""
        return self._response(texts, self._sentiments(texts), self._toxicity(texts))

    @staticmethod
    def _response(texts, sentiments, tox) -> list[dict]:
        return [
            {
                "generated_response": TOXIC_PLACEHOLDER if is_toxic else text,
                "sentiment": sent,
                "is_toxic": is_toxic,
            }
            for text, sent, (is_toxic, _) in zip(texts, sentiments, tox)
        ]

    def _prepare_documents(self, item: dict) -> list[dict]:
        """Unpack, copy or fetch by id the documents handed over."""
        if item.get("compressed_docs"):
            return unpack_docs(item["compressed_docs"])
        if item.get("documents") is not None:
            return [dict(d) for d in item["documents"]]
        if item.get("doc_ids") is not None:
            if self.doc_store is None or not self.doc_store.is_loaded:
                raise RuntimeError("doc_ids handoff requires a loaded doc store")
            return self.doc_store.fetch_documents_batch(item["doc_ids"])
        return []
