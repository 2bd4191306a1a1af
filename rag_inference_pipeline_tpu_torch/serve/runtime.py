"""Serving entry point: `python -m rag_inference_pipeline_tpu_torch.serve.runtime`.

A stdlib `ThreadingHTTPServer` speaking HTTP/1.1 (keep-alive, so the RPC
pools of other nodes reuse their connections; an idle connection closes
after `KEEPALIVE_TIMEOUT_S`), built from `Settings` (environment
variables), over one of two paths:

- the fused path (USE_FUSED_PIPELINE=1, an int8 flat index at INDEX_PATH
  and DOC_TOKENS_PATH): one fused device step per request, serialized by a
  device lock; routes `/query`, `/clear_cache` and `/health`;
- the staged path (the default), built from the role profile
  (`core/profiles.py`) as the reference's `serve/factory.py` wires it: the
  profile's components, a `RetrievalExecutor` behind a `BatchScheduler`
  for the `retrieval` route, a `GenerationService` behind another for
  `generation`, and the `Orchestrator` for `gateway`, with whichever
  stages this node hosts (a node without the retrieval route hands its
  embedder to the orchestrator; the stages it lacks go over the RPC hop to
  `retrieval_url` and `generation_url`). One asyncio loop, on a thread of
  its own, runs the orchestrator's workers, the schedulers and, under
  `USE_CONTINUOUS_BATCHING`, the LLM's decode engine; handler threads hand
  it their work with `asyncio.run_coroutine_threadsafe`.

A deployment of TOTAL_NODES=3 runs this same entry point three times with
NODE_NUMBER 0, 1 and 2 (`tools/start_pipeline.py`): the gateway, the
retrieval node and the generation node.

Routes and wire shapes are the JAX package's (`serve/http.py`,
`serve/schemas.py`):

- `POST /query` `{"query", "request_id"?, "k"?}` ->
  `{request_id, generated_response, sentiment, is_toxic}`;
- `POST /retrieve` `{"items"?: [{"query"?, "embedding"?, "k"?}], "rerank"?,
  "k"?, "embeddings_b64"?, "response_format"?}` -> `{"results": [{"ids",
  "scores", "documents"? | "compressed_docs"?}]}`; `embeddings_b64` is
  base64 of little-endian f32 rows, one per item (or, without `items`, one
  per row); `response_format="b64"` (the `id_only` mode only) answers
  `{count, k, ids_b64, scores_b64}`: int32 ids padded with -1 and f32
  scores padded with 0, [count, k] each;
- `POST /generate` `{"items": [{"query", "documents"? | "doc_ids"? |
  "compressed_docs"?}]}` -> `{"results": [{generated_response, sentiment,
  is_toxic}]}`;
- `POST /clear_cache` -> `{"cleared": [...]}` (the caches of this node); a
  gateway whose stages are remote also clears its peers', and says which
  answered under `cascade`;
- `GET /health` -> the node and its role, the loaded components, those
  whose weights are random (`random_weights`, the JAX package's field),
  each model's weights (`weights`: `random_weights` and the
  `checkpoint_dir` it loaded from), and the launch count of each
  hand-written kernel in this process.

A body sent with `X-Ragtpu-Encoding: zstd` is decompressed; a reply to a
request with `X-Ragtpu-Accept-Encoding: zstd` is compressed when the
node's COMPRESSION_ALGORITHM is zstd and compressing shrinks it. A
malformed request answers 400, a failed peer (`RPCError`) or a stage that
is not ready 503, a timeout 504.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import json
import logging
import signal
import socket
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from ..core.config import Settings, load_settings, replace_settings
from ..core.device import resolve_device
from ..core.enums import ComponentType
from ..core.profiles import load_role_profile
from ..engine.batcher import BatchScheduler
from ..engine.fused_executor import FusedExecutor
from ..engine.orchestrator import Orchestrator
from ..index import make_index
from ..index.base import load_index
from ..models.components import (
    EmbedderComponent,
    LLMComponent,
    RerankerComponent,
    SentimentComponent,
    ToxicityComponent,
)
from ..ops.ivf import ivf_dedup_scores, ivf_scan_partial
from ..ops.pq import ivfpq4_adc_scores
from ..ops.topk import binmax_partial_topk, binmax_partial_topk_int8gs
from ..utils.docstore import DocumentStore
from .compression import compress, decompress, require_codec
from .rpc import ACCEPT_HEADER, ENCODING_HEADER, RPCError
from .services import GenerationService, RetrievalExecutor

logger = logging.getLogger(__name__)

# an idle keep-alive connection is closed after this long
KEEPALIVE_TIMEOUT_S = 30.0


def node_health(settings: Settings) -> dict:
    """The node number and its role, as the reference's HealthResponse."""
    return {"node": settings.node_number, "role": settings.node_role.value}


def weights_health(named: dict[str, Any]) -> dict[str, dict]:
    """Each model component's weights: random, or the checkpoint directory
    they were loaded from."""
    return {
        k: {"random_weights": c.random_weights, "checkpoint_dir": c.checkpoint_dir}
        for k, c in named.items() if hasattr(c, "checkpoint_dir")
    }


def kernel_launches() -> dict[str, int]:
    """Launch count of every hand-written kernel, by kernel name."""
    return {
        "binmax_int8gs": binmax_partial_topk_int8gs.launches,
        "binmax_bf16": binmax_partial_topk.launches,
        "ivf_scan": ivf_scan_partial.launches,
        "ivf_dedup": ivf_dedup_scores.launches,
        "ivfpq4_adc": ivfpq4_adc_scores.launches,
    }


# ---------------------------------------------------------------------------
# The fused path
# ---------------------------------------------------------------------------


def build_executor(settings: Settings) -> FusedExecutor:
    """Load every component named by `settings` and the fused executor."""
    if not settings.use_fused_pipeline:
        raise ValueError("build_executor builds the fused pipeline: set USE_FUSED_PIPELINE=1")
    if settings.index_dtype != "int8":
        raise ValueError("the port's fused pipeline scans an int8 index: set INDEX_DTYPE=int8")
    if not settings.index_path:
        raise ValueError("the fused pipeline needs a flat index at INDEX_PATH")
    if not settings.doc_tokens_path:
        raise ValueError("the fused pipeline needs DOC_TOKENS_PATH")
    device = resolve_device(settings.device_platform)
    embedder = EmbedderComponent(settings, device)
    llm = LLMComponent(settings, device)
    sentiment = SentimentComponent(settings, device)
    toxicity = ToxicityComponent(settings, device)
    for comp in (embedder, llm, sentiment, toxicity):
        comp.load()
    index = load_index(settings.index_path, device)
    if index.dim != embedder.dim:
        raise ValueError(
            f"index dim {index.dim} != embedder width {embedder.dim}"
        )
    ex = FusedExecutor(
        settings, device=device, embedder=embedder, index=index, llm=llm,
        sentiment=sentiment, toxicity=toxicity,
    )
    ex.load()
    return ex


class FusedApp:
    """The fused executor behind one device lock: each request is its own
    batch."""

    def __init__(self, executor: FusedExecutor) -> None:
        self.executor = executor
        self.settings = executor.settings
        self.routes = {"/query": self.query, "/clear_cache": self.clear_cache}
        self._device_lock = threading.Lock()

    def query(self, req: dict) -> dict:
        query, request_id, _ = _parse_query(req)
        with self._device_lock:
            out = self.executor.process_batch([{"query": query}])[0]
        return {"request_id": request_id, **out}

    def clear_cache(self, req: dict) -> dict:
        self.executor.embedder.cache.clear()
        return {"cleared": ["embedder"]}

    def health(self) -> tuple[int, dict]:
        ex = self.executor
        comps = {
            "embedder": ex.embedder, "llm": ex.llm, "index": ex.index,
            "sentiment": ex.sentiment, "toxicity": ex.toxicity,
            "fused_executor": ex,
        }
        return 200, {
            "status": "ok",
            **node_health(self.settings),
            "device": str(ex.device),
            "components": {
                k: bool(c is not None and c.is_loaded) for k, c in comps.items()
            },
            "random_weights": [
                k for k, c in comps.items() if getattr(c, "random_weights", False)
            ],
            "weights": weights_health(comps),
            "kernel_launches": kernel_launches(),
        }

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# The staged path
# ---------------------------------------------------------------------------

# profile component-config key -> Settings field for the index component
# (the reference's serve/factory.py::_INDEX_CFG_KEYS, for the ported fields)
_INDEX_CFG_KEYS = {
    "kind": "index_kind", "path": "index_path", "metric": "index_metric",
    "dtype": "index_dtype", "nlist": "index_nlist", "nprobe": "index_nprobe",
    "pq_m": "index_pq_m", "pq_bits": "index_pq_bits",
    "rescore_k": "index_rescore_k", "rescore_store": "index_rescore_store",
    "pq_rescore_k": "index_pq_rescore_k",
    "pq_rescore_kind": "index_pq_rescore_kind",
    "cap_factor": "index_cap_factor",
}


def _index_settings(settings: Settings, config: dict) -> Settings:
    """A profile's per-component index config over the env settings."""
    unknown = set(config) - set(_INDEX_CFG_KEYS)
    if unknown:
        raise ValueError(
            f"unknown index config keys {sorted(unknown)}; "
            f"allowed: {sorted(_INDEX_CFG_KEYS)}"
        )
    return replace_settings(
        settings, **{_INDEX_CFG_KEYS[k]: v for k, v in config.items()}
    )


class StagedApp:
    """Components, services, schedulers and the asyncio loop of the staged
    path, as the reference's serve/factory.py wires them from a profile.
    `index` (optional) is a built index that takes the place of
    INDEX_PATH."""

    def __init__(self, settings: Settings, *, index=None) -> None:
        self.profile = profile = load_role_profile(settings)
        if profile.batch_overrides:
            settings = replace_settings(settings, **profile.batch_overrides)
        self.settings = settings
        self.device = device = resolve_device(settings.device_platform)
        self.components: dict[str, Any] = {}
        for spec in profile.components:
            t = spec.type
            if t is ComponentType.EMBEDDER:
                comp = EmbedderComponent(settings, device)
            elif t is ComponentType.INDEX:
                comp = self._make_index(_index_settings(settings, spec.config), index)
            elif t is ComponentType.DOC_STORE:
                comp = DocumentStore(settings)
            elif t is ComponentType.RERANKER:
                comp = RerankerComponent(settings, device)
            elif t is ComponentType.LLM:
                comp = LLMComponent(settings, device)
            elif t is ComponentType.SENTIMENT:
                comp = SentimentComponent(settings, device)
            elif t is ComponentType.TOXICITY:
                comp = ToxicityComponent(settings, device)
            else:  # mesh: one device, nothing to hold; orchestrator: below
                continue
            if t is not ComponentType.INDEX:
                comp.load()
            self.components[t.value] = comp
        get = self.components.get
        self.retrieval_executor = self.generation_service = self.orchestrator = None
        if "retrieval" in profile.routes:
            self.retrieval_executor = RetrievalExecutor(
                settings, index=get("index"), embedder=get("embedder"),
                doc_store=get("doc_store"), reranker=get("reranker"),
            )
        if "generation" in profile.routes:
            self.generation_service = GenerationService(
                settings, llm=get("llm"), reranker=get("reranker"),
                sentiment=get("sentiment"), toxicity=get("toxicity"),
                doc_store=get("doc_store"),
            )
        self.routes = {"/clear_cache": self.clear_cache}
        if "gateway" in profile.routes:
            self.orchestrator = Orchestrator(
                settings, retrieval_executor=self.retrieval_executor,
                generation_service=self.generation_service,
                embedder=get("embedder") if self.retrieval_executor is None else None,
            )
            self.routes["/query"] = self.query
        if self.retrieval_executor is not None:
            self.routes["/retrieve"] = self.retrieve
        if self.generation_service is not None:
            self.routes["/generate"] = self.generate
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="staged-loop", daemon=True
        )
        self._thread.start()
        self._submit(self._start()).result(timeout=60)

    def _make_index(self, s: Settings, index):
        """The given index, else INDEX_PATH's artifact (with the
        deployment's nprobe), else an empty index of the configured kind."""
        if index is None and s.index_path:
            index = load_index(s.index_path, self.device)
            if hasattr(index, "nprobe"):
                index.nprobe = s.index_nprobe
        if index is None:
            logger.warning("index: no INDEX_PATH — starting empty (not loaded)")
            return make_index(s, self.device)
        if index.dim != s.index_dim:
            raise ValueError(f"index dim {index.dim} != INDEX_DIM {s.index_dim}")
        return index

    async def _start(self) -> None:
        s = self.settings
        self.retrieval_scheduler = (
            BatchScheduler(
                self.retrieval_executor.process_batch,
                batch_size=s.retrieval_batch_size,
                timeout_s=s.retrieval_batch_timeout_ms / 1e3,
                adaptive=s.adaptive_batching,
                flush_on_ready=s.batch_flush_on_ready,
                name="retrieval",
            )
            if self.retrieval_executor is not None else None
        )
        gen = self.generation_service
        self.generation_scheduler = (
            BatchScheduler(
                gen.process_batch_async if s.use_continuous_batching
                else gen.process_batch,
                batch_size=s.generation_batch_size,
                timeout_s=s.generation_batch_timeout_ms / 1e3,
                adaptive=s.adaptive_batching,
                # the engine interleaves many batches in one decode loop:
                # completion clocking would serialize its feed
                flush_on_ready=s.batch_flush_on_ready and not s.use_continuous_batching,
                name="generation",
            )
            if gen is not None else None
        )
        llm = self.components.get("llm")
        if llm is not None:  # the decode engine, under USE_CONTINUOUS_BATCHING
            await llm.start()
        if self.orchestrator is not None:
            await self.orchestrator.start()

    async def _stop(self) -> None:
        if self.orchestrator is not None:
            await self.orchestrator.stop()
        for sched in (self.retrieval_scheduler, self.generation_scheduler):
            if sched is not None:
                await sched.stop()
        llm = self.components.get("llm")
        if llm is not None:
            await llm.stop()

    def _submit(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def _wait(self, coro):
        return self._submit(coro).result(timeout=self.settings.request_timeout_s)

    def query(self, req: dict) -> dict:
        query, request_id, k = _parse_query(req)
        return self._wait(self.orchestrator.process_query(query, request_id, k))

    def retrieve(self, req: dict) -> dict:
        items, response_format = _parse_retrieve(req, self.settings.index_dim)
        results = self._wait(self.retrieval_scheduler.enqueue_many(items))
        if response_format == "b64":
            return _pack_results_b64(results)
        return {"results": [_result_wire(r) for r in results]}

    def generate(self, req: dict) -> dict:
        items = _parse_generate(req)
        results = self._wait(self.generation_scheduler.enqueue_many(items))
        return {"results": [
            {"generated_response": r["generated_response"],
             "sentiment": r.get("sentiment", "neutral"),
             "is_toxic": bool(r.get("is_toxic", False))}
            for r in results
        ]}

    def clear_cache(self, req: dict) -> dict:
        return self._wait(self._clear_cache())

    async def _clear_cache(self) -> dict:
        """This node's caches; a gateway whose stages are remote clears its
        peers' too (never its own URL: with TOTAL_NODES=2 generation
        stays on node 0)."""
        s = self.settings
        cleared, cascade = [], {}
        orch = self.orchestrator
        if orch is not None:
            orch.clear_cache()
            cleared.append("query")
            own = s.node_url(s.node_number)
            peers = {"retrieval": (orch.retrieval_executor, s.retrieval_url),
                     "generation": (orch.generation_service, s.generation_url)}
            for name, (local, url) in peers.items():
                if local is None and s.total_nodes > 1 and url != own:
                    cascade[name] = await orch.rpc.clear_cache(url)
        if self.retrieval_executor is not None:
            self.retrieval_executor.search_cache.clear()
            cleared.append("search")
        for name in ("embedder", "doc_store"):
            comp = self.components.get(name)
            if comp is not None:
                comp.cache.clear()
                cleared.append(name)
        return {"cleared": cleared, **({"cascade": cascade} if cascade else {})}

    def health(self) -> tuple[int, dict]:
        named = dict(self.components)
        for name in ("retrieval_executor", "generation_service", "orchestrator"):
            if getattr(self, name) is not None:
                named[name] = getattr(self, name)
        comps = {k: bool(c.is_loaded) for k, c in named.items()}
        ok = all(comps.values())
        return (200 if ok else 503), {
            "status": "ok" if ok else "degraded",
            **node_health(self.settings),
            "profile": self.profile.name,
            "device": str(self.device),
            "components": comps,
            "random_weights": [
                k for k, c in named.items() if getattr(c, "random_weights", False)
            ],
            "weights": weights_health(named),
            "kernel_launches": kernel_launches(),
        }

    def close(self) -> None:
        """Flush the schedulers, stop the orchestrator and the loop."""
        if not self.loop.is_closed():
            self._submit(self._stop()).result(timeout=self.settings.request_timeout_s)
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=60)
            self.loop.close()


# ---------------------------------------------------------------------------
# Wire shapes (serve/schemas.py)
# ---------------------------------------------------------------------------


def _opt_int(v, what: str) -> Optional[int]:
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"{what} must be an integer")
    return v


def _parse_query(req: dict) -> tuple[str, str, Optional[int]]:
    query = req.get("query")
    if not isinstance(query, str) or not query.strip():
        raise ValueError("query must be a non-empty string")
    request_id = str(req.get("request_id") or uuid.uuid4().hex)
    return query, request_id, _opt_int(req.get("k"), "k")


def _parse_retrieve(req: dict, dim: int) -> tuple[list[dict], str]:
    """The reference's RetrieveRequest checks and its handler's item build:
    (items for the retrieval scheduler, response format)."""
    items = req.get("items")
    b64 = req.get("embeddings_b64")
    if items is None and b64 is None:
        raise ValueError("either items or embeddings_b64 is required")
    if items is not None and not isinstance(items, list):
        raise ValueError("/retrieve: 'items' must be a list")
    rerank = req.get("rerank", False)
    if not isinstance(rerank, bool):
        raise ValueError("rerank must be a boolean")
    k_default = _opt_int(req.get("k"), "k")
    response_format = req.get("response_format", "json")
    if response_format not in ("json", "b64"):
        raise ValueError("response_format must be 'json' or 'b64'")
    batch_emb = None
    if b64 is not None:
        if not isinstance(b64, str) or len(b64) % 4 != 0:
            raise ValueError("embeddings_b64 length must be a multiple of 4")
        raw = base64.b64decode(b64, validate=True)
        row = dim * 4
        if items is not None and len(raw) != len(items) * row:
            raise ValueError(
                f"embeddings_b64: {len(raw)} bytes != "
                f"{len(items)} items x {dim} dim x f32"
            )
        if items is None and (len(raw) == 0 or len(raw) % row != 0):
            raise ValueError(
                f"embeddings_b64: {len(raw)} bytes is not a non-zero "
                f"multiple of {dim} dim x f32"
            )
        batch_emb = np.frombuffer(raw, "<f4").reshape(-1, dim)
    if items is None:  # itemless binary batch: one item a row, shared k
        return [
            {"query": "", "embedding": batch_emb[i], "k": k_default, "rerank": rerank}
            for i in range(batch_emb.shape[0])
        ], response_format
    out = []
    for i, it in enumerate(items):
        if not isinstance(it, dict):
            raise ValueError(f"item {i} must be an object")
        query = it.get("query", "")
        if not isinstance(query, str):
            raise ValueError(f"item {i}: query must be a string")
        emb = it.get("embedding")
        if emb is not None:
            if not isinstance(emb, list) or not all(
                isinstance(x, (int, float)) and not isinstance(x, bool) for x in emb
            ):
                raise ValueError(f"item {i}: embedding must be a list of numbers")
            if len(emb) != dim:
                raise ValueError(
                    f"item {i}: embedding dim {len(emb)} != index dim {dim}"
                )
        elif batch_emb is not None:
            emb = batch_emb[i]
        k = _opt_int(it.get("k"), f"item {i}: k")
        out.append({
            "query": query, "embedding": emb,
            "k": k if k is not None else k_default, "rerank": rerank,
        })
    return out, response_format


def _pack_results_b64(results: list[dict]) -> dict:
    """Binary id_only reply: ids int32 [B, k] (pad -1) and scores f32
    [B, k] (pad 0), base64; byte for byte the reference's
    `serve/http.py::_pack_results_b64`."""
    if any("documents" in r or "compressed_docs" in r for r in results):
        raise ValueError(
            "response_format='b64' requires documents_payload_mode=id_only"
        )
    b = len(results)
    k = max((len(r["ids"]) for r in results), default=0)
    ids = np.full((b, k), -1, "<i4")
    scores = np.zeros((b, k), "<f4")
    for i, r in enumerate(results):
        m = len(r["ids"])
        ids[i, :m] = r["ids"]
        scores[i, :m] = r["scores"]
    return {
        "count": b,
        "k": k,
        "ids_b64": base64.b64encode(ids.tobytes()).decode(),
        "scores_b64": base64.b64encode(scores.tobytes()).decode(),
    }


_DOC_FIELDS = ("id", "title", "content", "score", "rerank_score")


def _document(d, what: str) -> dict:
    """One document as the reference's `Document` validates and dumps it
    (`exclude_none`): an int id, title and content ("" when absent), and
    the scores that are set, as floats."""
    if not isinstance(d, dict):
        raise ValueError(f"{what} must be an object")
    doc_id = d.get("id")
    if isinstance(doc_id, bool) or not isinstance(doc_id, int):
        raise ValueError(f"{what}: id must be an integer")
    out = {"id": doc_id}
    for f in ("title", "content"):
        v = d.get(f, "")
        if not isinstance(v, str):
            raise ValueError(f"{what}: {f} must be a string")
        out[f] = v
    for f in ("score", "rerank_score"):
        v = d.get(f)
        if v is not None:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{what}: {f} must be a number")
            out[f] = float(v)
    return out


def _parse_generate(req: dict) -> list[dict]:
    """The reference's GenerateRequest: items of a query and the documents
    handed over (`documents`, `doc_ids` or `compressed_docs`), dumped
    without the fields that are absent."""
    items = req.get("items")
    if not isinstance(items, list):
        raise ValueError("/generate needs 'items': a list")
    out = []
    for i, it in enumerate(items):
        if not isinstance(it, dict):
            raise ValueError(f"item {i} must be an object")
        query = it.get("query")
        if not isinstance(query, str):
            raise ValueError(f"item {i}: query must be a string")
        entry: dict[str, Any] = {"query": query}
        docs = it.get("documents")
        if docs is not None:
            if not isinstance(docs, list):
                raise ValueError(f"item {i}: documents must be a list")
            entry["documents"] = [
                _document(d, f"item {i}: document {j}") for j, d in enumerate(docs)
            ]
        doc_ids = it.get("doc_ids")
        if doc_ids is not None:
            if not isinstance(doc_ids, list) or not all(
                isinstance(x, int) and not isinstance(x, bool) for x in doc_ids
            ):
                raise ValueError(f"item {i}: doc_ids must be a list of integers")
            entry["doc_ids"] = doc_ids
        packed = it.get("compressed_docs")
        if packed is not None:
            if not isinstance(packed, str):
                raise ValueError(f"item {i}: compressed_docs must be a string")
            base64.b64decode(packed, validate=True)
            entry["compressed_docs"] = packed
        out.append(entry)
    return out


def _result_wire(res: dict) -> dict:
    """A retrieval result as the reference's RetrieveResultItem dumps it
    (`exclude_none`): documents keep the Document fields that are set."""
    out = {"ids": res["ids"], "scores": res["scores"]}
    if res.get("documents") is not None:
        out["documents"] = [
            {f: d[f] for f in _DOC_FIELDS if d.get(f) is not None}
            for d in res["documents"]
        ]
    if res.get("compressed_docs") is not None:
        out["compressed_docs"] = res["compressed_docs"]
    return out


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server: "RAGServer"
    protocol_version = "HTTP/1.1"  # keep-alive; every reply has a Content-Length
    timeout = KEEPALIVE_TIMEOUT_S

    def log_message(self, fmt, *args):  # route the access log to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def setup(self) -> None:
        super().setup()
        self.server.track(self.connection, True)

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            self.server.track(self.connection, False)

    def _closing(self) -> bool:
        """A request that arrives on a kept-alive connection while the
        server closes: 503, and the connection closes."""
        if not self.server.closing:
            return False
        self.close_connection = True
        self._send(503, {"error": "the server is shutting down", "error_type": "unavailable"})
        return True

    def _send(self, code: int, body: dict, *, route: bool = False) -> None:
        """A JSON reply; a route's reply (not an error) is compressed as
        the reference's compression middleware compresses it."""
        data = json.dumps(body).encode()
        s = self.server.app.settings
        encoded = False
        if (route and s.compression_algorithm == "zstd"
                and "zstd" in self.headers.get(ACCEPT_HEADER, "")):
            data, encoded = compress(
                data, level=s.compression_level, min_bytes=s.compression_min_bytes
            )
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if self.close_connection:
            self.send_header("Connection", "close")
        if encoded:
            self.send_header(ENCODING_HEADER, "zstd")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self._closing():
            return
        if self.path != "/health":
            self._send(404, {"error": f"no route {self.path}"})
            return
        code, body = self.server.app.health()
        self._send(code, body, route=True)

    def do_POST(self):
        try:
            # read the whole body first: on a keep-alive connection unread
            # bytes would be taken for the next request
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                raise ValueError(length)
            body = self.rfile.read(length)
        except ValueError:
            self.close_connection = True
            self._send(400, {"error": "bad Content-Length", "error_type": "validation"})
            return
        if self._closing():
            return
        handler = self.server.app.routes.get(self.path)
        if handler is None:
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            if self.headers.get(ENCODING_HEADER) == "zstd":
                body = decompress(body)
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                raise ValueError("the request body must be a JSON object")
            out = handler(req)
        except ValueError as e:  # bad JSON and bad base64 are ValueErrors too
            self._send(400, {"error": str(e)[:500], "error_type": "validation"})
        except RPCError as e:  # a peer node failed: unavailable, not internal
            logger.exception("request failed")
            self._send(503, {"error": str(e)[:500], "error_type": "unavailable"})
        except (TimeoutError, concurrent.futures.TimeoutError):
            self._send(504, {"error": "request timed out", "error_type": "timeout"})
        except RuntimeError as e:  # readiness failures -> 503
            msg = str(e)
            logger.exception("request failed")
            code = 503 if "not ready" in msg or "not loaded" in msg else 500
            self._send(code, {"error": msg[:500], "error_type": "unavailable"})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            logger.exception("request failed")
            self._send(500, {"error": str(e)[:500], "error_type": "internal"})
        else:
            self._send(200, out, route=True)


class RAGServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, app, host: str, port: int):
        super().__init__((host, port), _Handler)
        self.app = app
        self.closing = False
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    def track(self, conn: socket.socket, open_: bool) -> None:
        """The connections being served, to close those kept alive."""
        with self._conns_lock:
            (self._conns.add if open_ else self._conns.discard)(conn)

    @property
    def executor(self) -> Optional[FusedExecutor]:
        """The fused executor (fused path only)."""
        return getattr(self.app, "executor", None)

    def server_close(self) -> None:
        """Stop listening, drain and close the app, then end the
        connections that are still kept alive (their next read sees EOF)."""
        self.closing = True
        super().server_close()
        self.app.close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:  # already closed by the peer
                pass


def make_server(
    settings: Settings, port: Optional[int] = None, *, index=None
) -> RAGServer:
    """Build the app for `settings` and bind the server; `port` overrides
    BASE_PORT + NODE_NUMBER (0 picks a free port); `index` hands the staged
    path a built index in place of INDEX_PATH. A node whose settings ask
    for zstd refuses to start without `zstandard`."""
    require_codec(settings)
    if settings.use_fused_pipeline:
        if index is not None:
            raise ValueError("the fused path loads its index from INDEX_PATH")
        app = FusedApp(build_executor(settings))
    else:
        app = StagedApp(settings, index=index)
    try:
        return RAGServer(
            app, settings.listen_host,
            settings.listen_port if port is None else port,
        )
    except OSError:
        app.close()
        raise


def main() -> None:
    settings = load_settings()
    logging.basicConfig(
        level=getattr(logging, settings.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    server = make_server(settings)
    logger.info(
        "node %d (%s) listening on %s:%d (%s)", settings.node_number,
        settings.node_role.value, *server.server_address[:2],
        torch.cuda.get_device_name(0) if torch.cuda.is_available()
        and settings.device_platform != "cpu" else "cpu",
    )
    # SIGTERM stops the node as Ctrl-C does: the schedulers flush, the
    # orchestrator and the decode engine stop, the server closes
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
