"""Service logic of the staged path: the retrieval executor and the
generation service.

Port of `rag_inference_pipeline_tpu/serve/services.py` (without its
Prometheus stage timers and sampled profiler):

- `RetrievalExecutor`: embed (a provided embedding, else the embedder) ->
  index search behind a search cache keyed by the SHA-256 of the embedding
  and k, with k bucketed up a ladder and batches cut and padded to the
  shape buckets -> doc fetch by payload mode (`full` documents or
  `id_only`) -> optional rerank.
- `GenerationService`: the documents handed over (or fetched by id) ->
  rerank -> LLM -> sentiment -> toxicity; a toxic answer is replaced by
  `TOXIC_PLACEHOLDER`. `process_batch` runs the LLM per bucketed batch;
  `process_batch_async` submits each request to the continuous-batching
  decode engine.

The `compressed` payload mode is refused by name: zstandard is not
guaranteed on the GPU machine.
"""

from __future__ import annotations

import asyncio
import hashlib
from typing import Any, Optional, Sequence

import numpy as np

from ..core.config import Settings
from ..core.enums import PayloadMode
from ..engine.fused_executor import TOXIC_PLACEHOLDER
from ..utils.cache import LRUCache
from ..utils.shapes import chunk_spans, pad_rows, pick_bucket


def _refuse_compressed(settings: Settings) -> None:
    if settings.documents_payload_mode is PayloadMode.COMPRESSED:
        raise NotImplementedError(
            "DOCUMENTS_PAYLOAD_MODE='compressed' (zstd blobs) is not ported: "
            "use 'full' or 'id_only'"
        )


class RetrievalExecutor:
    """Batch retrieval: embed -> ANN search -> doc fetch [-> rerank]."""

    def __init__(
        self, settings: Settings, *, index, embedder=None, doc_store=None,
        reranker=None,
    ) -> None:
        _refuse_compressed(settings)
        self.settings = settings
        self.index = index
        self.embedder = embedder
        self.doc_store = doc_store
        self.reranker = reranker
        self.search_cache = LRUCache(settings.search_cache_capacity)
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
        embs = self._get_embeddings(items)
        ids, scores = self._search_with_cache(embs, items)
        return self._build_results(items, ids, scores)

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
        id_only = self.settings.documents_payload_mode is PayloadMode.ID_ONLY
        results = []
        for i, it in enumerate(items):
            res: dict[str, Any] = {"ids": ids[i], "scores": scores[i]}
            if not id_only:
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
                res["documents"] = docs
            results.append(res)
        return results


class GenerationService:
    """Batch generation: docs -> rerank -> LLM -> sentiment -> toxicity."""

    def __init__(
        self, settings: Settings, *, llm, reranker=None, sentiment=None,
        toxicity=None, doc_store=None,
    ) -> None:
        _refuse_compressed(settings)
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

    @property
    def is_loaded(self) -> bool:
        return True

    def process_batch(self, items: list[dict]) -> list[dict]:
        """items: [{query, documents? | doc_ids?}] -> [{generated_response,
        sentiment, is_toxic}]."""
        self._check_llm()
        queries = [it.get("query", "") for it in items]
        texts = self.llm.generate_batch(queries, self._documents(queries, items))
        return self._finish(texts)

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
        texts = await self.llm.generate_batch_engine(queries, docs_batch)
        return await loop.run_in_executor(None, self._finish, texts)

    def _check_llm(self) -> None:
        if self.llm is None or not self.llm.is_loaded:
            raise RuntimeError("generation not ready: llm not loaded")

    def _documents(self, queries: list[str], items: list[dict]) -> list[list[dict]]:
        """Each item's documents, reranked (or cut) to `rerank_top_n`."""
        docs_batch = [self._prepare_documents(it) for it in items]
        top_n = self.settings.rerank_top_n
        if self.reranker is not None and self.reranker.is_loaded:
            return self.reranker.rerank_batch(queries, docs_batch, top_n=top_n)
        return [d[:top_n] for d in docs_batch]

    def _finish(self, texts: list[str]) -> list[dict]:
        """Sentiment and toxicity of the answers -> the response items."""
        if self.sentiment is not None and self.sentiment.is_loaded:
            sentiments = self.sentiment.analyze_batch(texts)
        else:
            sentiments = ["neutral"] * len(texts)
        if self.toxicity is not None and self.toxicity.is_loaded:
            tox = self.toxicity.check_batch(texts)
        else:
            tox = [(False, 0.0)] * len(texts)
        return [
            {
                "generated_response": TOXIC_PLACEHOLDER if is_toxic else text,
                "sentiment": sent,
                "is_toxic": is_toxic,
            }
            for text, sent, (is_toxic, _) in zip(texts, sentiments, tox)
        ]

    def _prepare_documents(self, item: dict) -> list[dict]:
        if item.get("documents") is not None:
            return [dict(d) for d in item["documents"]]
        if item.get("doc_ids") is not None:
            if self.doc_store is None or not self.doc_store.is_loaded:
                raise RuntimeError("doc_ids handoff requires a loaded doc store")
            return self.doc_store.fetch_documents_batch(item["doc_ids"])
        return []
