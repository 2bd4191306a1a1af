"""Serving entry point: `python -m rag_inference_pipeline_tpu_torch.serve.runtime`.

A stdlib `ThreadingHTTPServer`, built from `Settings` (environment
variables), over one of two paths:

- the fused path (USE_FUSED_PIPELINE=1, an int8 flat index at INDEX_PATH
  and DOC_TOKENS_PATH): one fused device step per request, serialized by a
  device lock; routes `/query` and `/health`;
- the staged path (the default), built from the role profile
  (`core/profiles.py`): the profile's components, a `RetrievalExecutor`
  behind a `BatchScheduler` for the `retrieval` route, a
  `GenerationService` for `generation`, and the `Orchestrator` for
  `gateway`. One asyncio loop, on a thread of its own, runs the
  orchestrator's workers and the schedulers; handler threads hand it their
  work with `asyncio.run_coroutine_threadsafe`.

Routes and wire shapes are the JAX package's (`serve/http.py`,
`serve/schemas.py`):

- `POST /query` `{"query", "request_id"?, "k"?}` ->
  `{request_id, generated_response, sentiment, is_toxic}`;
- `POST /retrieve` `{"items": [{"query"?, "embedding"?, "k"?}], "rerank"?,
  "k"?}` -> `{"results": [{"ids", "scores", "documents"?}]}` (the binary
  `embeddings_b64` / `response_format="b64"` wire is not ported);
- `GET /health` -> the loaded components, whether their weights are
  random, and the launch count of each hand-written kernel.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

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
from .services import GenerationService, RetrievalExecutor

logger = logging.getLogger(__name__)


def kernel_launches() -> dict[str, int]:
    """Launch count of every hand-written kernel, by kernel name."""
    return {
        "binmax_int8gs": binmax_partial_topk_int8gs.launches,
        "binmax_bf16": binmax_partial_topk.launches,
        "ivf_scan": ivf_scan_partial.launches,
        "ivf_dedup": ivf_dedup_scores.launches,
        "ivfpq4_adc": ivfpq4_adc_scores.launches,
    }


def _refuse_unported(settings: Settings) -> None:
    if settings.use_speculative_decoding:
        raise NotImplementedError("speculative decoding is not ported yet")
    if settings.use_continuous_batching:
        raise NotImplementedError("the continuous-batching decode engine is not ported yet")


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
        self.routes = {"/query": self.query}
        self._device_lock = threading.Lock()

    def query(self, req: dict) -> dict:
        query, request_id, _ = _parse_query(req)
        with self._device_lock:
            out = self.executor.process_batch([{"query": query}])[0]
        return {"request_id": request_id, **out}

    def health(self) -> tuple[int, dict]:
        ex = self.executor
        comps = {
            "embedder": ex.embedder, "llm": ex.llm, "index": ex.index,
            "sentiment": ex.sentiment, "toxicity": ex.toxicity,
            "fused_executor": ex,
        }
        return 200, {
            "status": "ok",
            "device": str(ex.device),
            "components": {
                k: bool(c is not None and c.is_loaded) for k, c in comps.items()
            },
            "random_weights": [
                k for k, c in comps.items() if getattr(c, "random_weights", False)
            ],
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
        _refuse_unported(settings)
        self.settings = settings
        self.profile = profile = load_role_profile(settings)
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
        self.routes = {}
        if "gateway" in profile.routes and profile.has(ComponentType.ORCHESTRATOR):
            self.orchestrator = Orchestrator(
                settings, retrieval_executor=self.retrieval_executor,
                generation_service=self.generation_service,
            )
            self.routes["/query"] = self.query
        if self.retrieval_executor is not None:
            self.routes["/retrieve"] = self.retrieve
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
        if self.orchestrator is not None:
            await self.orchestrator.start()

    async def _stop(self) -> None:
        if self.orchestrator is not None:
            await self.orchestrator.stop()
        if self.retrieval_scheduler is not None:
            await self.retrieval_scheduler.stop()

    def _submit(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def _wait(self, coro):
        return self._submit(coro).result(timeout=self.settings.request_timeout_s)

    def query(self, req: dict) -> dict:
        query, request_id, k = _parse_query(req)
        return self._wait(self.orchestrator.process_query(query, request_id, k))

    def retrieve(self, req: dict) -> dict:
        items = _parse_retrieve(req, self.settings.index_dim)
        results = self._wait(self.retrieval_scheduler.enqueue_many(items))
        return {"results": [_result_wire(r) for r in results]}

    def health(self) -> tuple[int, dict]:
        named = dict(self.components)
        for name in ("retrieval_executor", "generation_service", "orchestrator"):
            if getattr(self, name) is not None:
                named[name] = getattr(self, name)
        comps = {k: bool(c.is_loaded) for k, c in named.items()}
        ok = all(comps.values())
        return (200 if ok else 503), {
            "status": "ok" if ok else "degraded",
            "profile": self.profile.name,
            "device": str(self.device),
            "components": comps,
            "random_weights": [
                k for k, c in named.items() if getattr(c, "random_weights", False)
            ],
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


def _parse_retrieve(req: dict, dim: int) -> list[dict]:
    for key in ("embeddings_b64", "response_format"):
        if req.get(key) not in (None, "json"):
            raise ValueError(f"/retrieve: {key!r} (the binary wire) is not ported")
    items = req.get("items")
    if not isinstance(items, list):
        raise ValueError("/retrieve needs 'items': a list")
    rerank = req.get("rerank", False)
    if not isinstance(rerank, bool):
        raise ValueError("rerank must be a boolean")
    k_default = _opt_int(req.get("k"), "k")
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
        k = _opt_int(it.get("k"), f"item {i}: k")
        out.append({
            "query": query, "embedding": emb,
            "k": k if k is not None else k_default, "rerank": rerank,
        })
    return out


_DOC_FIELDS = ("id", "title", "content", "score", "rerank_score")


def _result_wire(res: dict) -> dict:
    """A retrieval result as the reference's RetrieveResultItem dumps it
    (`exclude_none`): documents keep the Document fields that are set."""
    out = {"ids": res["ids"], "scores": res["scores"]}
    if res.get("documents") is not None:
        out["documents"] = [
            {f: d[f] for f in _DOC_FIELDS if d.get(f) is not None}
            for d in res["documents"]
        ]
    return out


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server: "RAGServer"

    def log_message(self, fmt, *args):  # route the access log to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path != "/health":
            self._send(404, {"error": f"no route {self.path}"})
            return
        self._send(*self.server.app.health())

    def do_POST(self):
        handler = self.server.app.routes.get(self.path)
        if handler is None:
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("the request body must be a JSON object")
            out = handler(req)
        except ValueError as e:  # bad JSON is a ValueError too
            self._send(400, {"error": str(e)[:500], "error_type": "validation"})
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
            self._send(200, out)


class RAGServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, app, host: str, port: int):
        super().__init__((host, port), _Handler)
        self.app = app

    @property
    def executor(self) -> Optional[FusedExecutor]:
        """The fused executor (fused path only)."""
        return getattr(self.app, "executor", None)

    def server_close(self) -> None:
        super().server_close()
        self.app.close()


def make_server(
    settings: Settings, port: Optional[int] = None, *, index=None
) -> RAGServer:
    """Build the app for `settings` and bind the server; `port` overrides
    BASE_PORT + NODE_NUMBER (0 picks a free port); `index` hands the staged
    path a built index in place of INDEX_PATH."""
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
        "listening on %s:%d (%s)", *server.server_address[:2],
        torch.cuda.get_device_name(0) if torch.cuda.is_available()
        and settings.device_platform != "cpu" else "cpu",
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
