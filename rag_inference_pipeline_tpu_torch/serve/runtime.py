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
- `GET /health` -> the node and its role, the loaded components (from the
  component registry), those whose weights are random (`random_weights`,
  the JAX package's field), each model's weights (`weights`:
  `random_weights` and the `checkpoint_dir` it loaded from), and, fields
  of the port only, the launch count of each hand-written kernel in this
  process and, on a node with an LLM, its captured decode graphs
  (`decode_graphs`: `count` and the MB of their shared pool) and its batch
  ladder as the card's free memory clamped it at load (`llm_ladder`);
- `GET /metrics` -> the reference's 16 Prometheus metrics
  (`telemetry/metrics.py`) as `text/plain; version=0.0.4`;
- `POST /profile/start` -> `{"status": "tracing", "log_dir"}` (409 while a
  trace runs) and `POST /profile/stop` -> `{"status": "stopped", "log_dir",
  "trace"}` (409 with none running): a `torch.profiler` trace of the
  process, written as a Chrome trace (`telemetry/profiling.py`).

With FAST_JSON on (the default), `/retrieve` first tries the native codec
(`utils/fastjson.py`) on the raw body (after zstd decompression): a body
in the strict retrieve-by-embedding shape is parsed straight into an f32
matrix, and an `id_only` JSON reply is written from packed arrays (scores
as `%.9g`, which reads back as the same f32). Any other body takes the
stdlib path with the same result, so every status, every 400 and every
payload mode are the same with FAST_JSON on and off.

A body sent with `X-Ragtpu-Encoding: zstd` is decompressed; a reply to a
request with `X-Ragtpu-Accept-Encoding: zstd` is compressed when the
node's COMPRESSION_ALGORITHM is zstd and compressing shrinks it. A
malformed request answers 400, a failed peer (`RPCError`) or a stage that
is not ready 503, a timeout 504; each such error counts in
`ERRORS_TOTAL` (service `http`, the exception's type). The reference's
outer middleware (`serve/http.py:85-128`) is here too: every reply carries
the CORS headers (`cors_headers`), a preflight `OPTIONS` (one with
`Access-Control-Request-Method`) answers 204, and a reply of at least
`GZIP_MIN_SIZE` bytes is gzipped when the request accepts gzip and the
reply is not zstd-framed. `/query` refreshes the RSS and device-memory
gauges at most every 5 s.

The serving entry point builds its app with `make_server`, which turns
WARMUP_BUCKETS on where it is unset (`resolve_serving_settings`, the
reference's `serve/runtime.py:35-43`): every component warms the buckets
it will dispatch before `/health` answers. Library use (`StagedApp`,
`build_executor`) leaves it off unless set.

Both paths hold a `MeshComponent` (the reference's `serve/factory.py:
36-55`): the mesh of MESH_DP x MESH_TP over DEVICE_PLATFORM's devices, or
one the caller hands `make_server(mesh=...)` (the reference's component
overrides; `core/mesh.py::force_host_devices` puts dp positions on one
card). Every component takes it; the index shards over its dp positions,
and the fused step splits its batch over them.

SPMD (DIST_NUM_PROCESSES > 1, `serve/spmd.py`): every process loads its
part of a flat INDEX_PATH; process 0 serves HTTP with its index behind an
`SPMDIndexProxy`, the others enter `worker_loop` and serve no HTTP (the
reference's `serve/runtime.py:74-87`). A front door that fails to start
sends OP_STOP before it raises, so the workers exit instead of hanging.
"""

from __future__ import annotations

import asyncio
import base64
import concurrent.futures
import dataclasses
import gzip
import json
import logging
import signal
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np
import torch

from ..core.config import Settings, load_settings, replace_settings
from ..core.distributed import init_distributed
from ..core.mesh import MeshContext, mesh_from_settings
from ..core.enums import ComponentType
from ..core.profiles import load_role_profile
from ..core.registry import ComponentRegistry
from ..engine.batcher import BatchScheduler
from ..engine.fused_executor import FusedExecutor
from ..engine.orchestrator import Orchestrator
from ..index import make_index
from ..index.base import load_index
from ..index.flat import load_part
from ..models.components import (
    EmbedderComponent,
    LLMComponent,
    RerankerComponent,
    SentimentComponent,
    ToxicityComponent,
)
from ..models.decode_graph import graphs_of
from ..ops.ivf import ivf_dedup_scores, ivf_scan_partial
from ..ops.pq import ivfpq4_adc_scores
from ..ops.topk import binmax_partial_topk, binmax_partial_topk_int8gs
from ..telemetry.metrics import (
    CONTENT_TYPE_LATEST,
    ERRORS_TOTAL,
    render_metrics,
    update_resource_gauges,
)
from ..telemetry.profiling import DeviceTraceCapture
from ..telemetry.tracing import setup_tracing
from ..utils import fastjson
from ..utils.docstore import DocumentStore
from .compression import compress, decompress, require_codec
from .rpc import ACCEPT_HEADER, ENCODING_HEADER, RPCError
from .services import GenerationService, RetrievalExecutor
from .spmd import SPMDIndexProxy, is_front_door, is_spmd, worker_loop

logger = logging.getLogger(__name__)

# an idle keep-alive connection is closed after this long
KEEPALIVE_TIMEOUT_S = 30.0
GZIP_MIN_SIZE = 1000  # the reference's GZipMiddleware(minimum_size=1000)
GAUGE_PERIOD_S = 5.0  # /query refreshes the resource gauges at most this often


def resolve_serving_settings(settings: Settings) -> Settings:
    """The serving entry's defaults for the tri-state knobs: WARMUP_BUCKETS
    unset means on (WARMUP_BUCKETS=0 opts out)."""
    if settings.warmup_buckets is None:
        logger.info("WARMUP_BUCKETS unset: on for serving")
        settings = dataclasses.replace(settings, warmup_buckets=True)
    return settings


def cors_headers(origin: Optional[str]) -> dict[str, str]:
    """The reference's `_cors_headers` (`serve/http.py:85-99`): any origin,
    method and header with credentials, so the request's Origin is echoed
    (with `Vary: Origin`) where one is sent."""
    return {
        "Access-Control-Allow-Origin": origin or "*",
        "Access-Control-Allow-Credentials": "true",
        "Access-Control-Allow-Methods": "*",
        "Access-Control-Allow-Headers": "*",
        **({"Vary": "Origin"} if origin else {}),
    }


def node_health(settings: Settings) -> dict:
    """The node number and its role, as the reference's HealthResponse."""
    return {"node": settings.node_number, "role": settings.node_role.value}


def mesh_health(mesh: Optional[MeshContext]) -> dict:
    """The serving mesh's shape: dp and tp positions."""
    return {"dp": mesh.dp, "tp": mesh.tp} if mesh is not None else {}


def weights_health(named: dict[str, Any]) -> dict[str, dict]:
    """Each model component's weights: random, or the checkpoint directory
    they were loaded from."""
    return {
        k: {"random_weights": c.random_weights, "checkpoint_dir": c.checkpoint_dir}
        for k, c in named.items() if hasattr(c, "checkpoint_dir")
    }


def decode_graph_health(llm) -> dict:
    """The LLM's captured decode graphs: how many, and the MB of the pool
    they share (the decode engine's segment graph included)."""
    cache = graphs_of(llm.params)
    count, pool = len(cache), cache.pool_bytes
    graph = getattr(llm.engine, "graph", None)
    if graph is not None:
        count, pool = count + 1, pool + graph.pool_bytes
    return {"count": count, "pool_mb": round(pool / 2**20, 3)}


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


class MeshComponent:
    """The registry's holder of the device mesh (reference `serve/factory.py:
    36-55`): the mesh handed in, else `mesh_from_settings` at load."""

    def __init__(self, settings: Settings, ctx: Optional[MeshContext] = None) -> None:
        self.settings = settings
        self._given = ctx
        self.ctx: Optional[MeshContext] = None

    @property
    def is_loaded(self) -> bool:
        return self.ctx is not None

    def load(self) -> None:
        self.ctx = self._given if self._given is not None else mesh_from_settings(self.settings)
        logger.info("mesh ready: dp=%d tp=%d devices=%s", self.ctx.dp, self.ctx.tp,
                    [str(d) for d in self.ctx.devices])

    def unload(self) -> None:
        self.ctx = None


def build_executor(
    settings: Settings, registry: Optional[ComponentRegistry] = None,
    mesh: Optional[MeshContext] = None,
) -> FusedExecutor:
    """Load every component named by `settings` and the fused executor,
    each registered (and so loaded, and warmed where WARMUP_BUCKETS is on)
    in `registry`, in the order the reference's profile places them.
    `mesh` takes the place of the settings' mesh."""
    if not settings.use_fused_pipeline:
        raise ValueError("build_executor builds the fused pipeline: set USE_FUSED_PIPELINE=1")
    if settings.index_dtype != "int8":
        raise ValueError("the port's fused pipeline scans an int8 index: set INDEX_DTYPE=int8")
    if not settings.index_path:
        raise ValueError("the fused pipeline needs a flat index at INDEX_PATH")
    if not settings.doc_tokens_path:
        raise ValueError("the fused pipeline needs DOC_TOKENS_PATH")
    if settings.dist_num_processes > 1:
        raise ValueError("the fused pipeline runs in one process: set DIST_NUM_PROCESSES=1")
    reg = ComponentRegistry() if registry is None else registry
    ctx = reg.register("mesh", MeshComponent(settings, mesh)).ctx
    device = ctx.front
    embedder = reg.register("embedder", EmbedderComponent(settings, device, mesh=ctx))
    # the fused step scans the index itself: nothing searches it to warm
    index = reg.register("index", load_index(
        settings.index_path, device, rescore_store=settings.index_rescore_store, mesh=ctx,
    ), load=False)
    if index.dim != embedder.dim:
        raise ValueError(
            f"index dim {index.dim} != embedder width {embedder.dim}"
        )
    llm = reg.register("llm", LLMComponent(settings, device, mesh=ctx))
    sentiment = reg.register("sentiment", SentimentComponent(settings, device, mesh=ctx))
    toxicity = reg.register("toxicity", ToxicityComponent(settings, device, mesh=ctx))
    return reg.register("fused_executor", FusedExecutor(
        settings, device=device, embedder=embedder, index=index, llm=llm,
        sentiment=sentiment, toxicity=toxicity, mesh=ctx,
    ))


class FusedApp:
    """The fused executor behind one device lock: each request is its own
    batch. `registry` holds the components `build_executor` registered;
    without one, the executor's parts are registered as they are."""

    def __init__(
        self, executor: FusedExecutor, registry: Optional[ComponentRegistry] = None
    ) -> None:
        self.executor = ex = executor
        self.settings = executor.settings
        if registry is None:
            registry = ComponentRegistry()
            for name in ("embedder", "index", "llm", "sentiment", "toxicity"):
                if getattr(ex, name) is not None:
                    registry.register(name, getattr(ex, name), load=False)
            registry.register("fused_executor", ex, load=False)
        self.registry = registry
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
        reg = self.registry
        named = {k: reg.get(k) for k in reg.names}
        return 200, {
            "status": "ok",
            **node_health(self.settings),
            "device": str(self.executor.device),
            "mesh": mesh_health(self.executor.mesh),
            "components": reg.health(),
            "random_weights": [
                k for k, c in named.items() if getattr(c, "random_weights", False)
            ],
            "weights": weights_health(named),
            "kernel_launches": kernel_launches(),
            "decode_graphs": decode_graph_health(self.executor.llm),
            "llm_ladder": list(self.executor.llm.ladder),
        }

    def close(self) -> None:
        """Unload in reverse order (the fused app starts nothing, so there
        is nothing to stop)."""
        self.registry.unload_all()


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


class IndexComponent:
    """A staged node's index (the reference's `serve/factory.py::
    IndexComponent`, `:61-119`): a built index handed in, else INDEX_PATH's
    artifact on the mesh with the deployment's nprobe and nprobe_local,
    else an empty index of the configured kind. With WARMUP_BUCKETS on,
    `load()` runs one search at RETRIEVAL_K (reference `index/base.py:
    80-88`) and one of every shape bucket at every k of the retrieval
    executor's ladder that the index holds (`serve/factory.py:100-115`), on
    seeded unit queries; results are read back and dropped, and no cache
    sees them. `unload()` drops only an index it loaded itself.

    Under SPMD each process loads its part of a flat INDEX_PATH; a worker
    searches only when the front door's broadcasts drive it (no warm-up),
    and the front door's index is an `SPMDIndexProxy`."""

    def __init__(
        self, settings: Settings, device: torch.device, index=None,
        mesh: Optional[MeshContext] = None,
    ) -> None:
        self.settings = settings
        self.device = device
        self.mesh = mesh
        self._given = index
        self.index = None
        self.warmed: tuple[tuple[int, int], ...] = ()

    @property
    def is_loaded(self) -> bool:
        return self.index is not None and self.index.is_loaded

    def load(self) -> None:
        s, index = self.settings, self._given
        if index is None and s.index_path:
            # where the rescore copy lands is the deployment's choice
            index = self._load_path()
            # runtime knobs, not artifact state
            if hasattr(index, "nprobe"):
                index.nprobe = s.index_nprobe
            if hasattr(index, "nprobe_local"):
                index.nprobe_local = s.index_nprobe_local
        if index is None:
            logger.warning("index: no INDEX_PATH — starting empty (not loaded)")
            self.index = make_index(s, self.device, mesh=self.mesh)
            return
        if index.dim != s.index_dim:
            raise ValueError(f"index dim {index.dim} != INDEX_DIM {s.index_dim}")
        if hasattr(index, "metric_labels"):
            index.metric_labels = (s.run_id, str(s.node_number))
        self.index = index
        if is_spmd():
            if not is_front_door():
                return  # worker: searches only from the front door's broadcasts
            self.index = SPMDIndexProxy(index)
        if s.warmup_buckets:
            self.warmup()

    def _load_path(self):
        s = self.settings
        if not is_spmd():
            return load_index(s.index_path, self.device,
                              rescore_store=s.index_rescore_store, mesh=self.mesh)
        with np.load(s.index_path, allow_pickle=False) as z:
            kind = str(z["kind"])
        if kind != "flat":
            raise ValueError(f"SPMD serving splits a flat index over processes, not {kind!r}")
        return load_part(
            s.index_path, torch.distributed.get_rank(), torch.distributed.get_world_size(),
            mesh=self.mesh, device=self.device, rescore_store=s.index_rescore_store,
        )

    def warmup(self) -> None:
        s, index = self.settings, self.index
        t0 = time.perf_counter()
        ks = [k for k in sorted({s.retrieval_k, 16, 32, 64, 128}) if k <= index.ntotal]
        searches = [(1, s.retrieval_k)] if s.retrieval_k <= index.ntotal else []
        searches += [(b, k) for b in s.shape_buckets for k in ks]
        g = torch.Generator().manual_seed(0)
        for b, k in searches:
            q = torch.randn(b, index.dim, generator=g)
            scores, ids = index.search((q / q.norm(dim=1, keepdim=True)).numpy(), k)
            scores.cpu(), ids.cpu()
        self.warmed = tuple(searches)
        logger.info("index warmup: %d searches in %.2fs", len(searches),
                    time.perf_counter() - t0)

    def unload(self) -> None:
        if self.index is not None and self._given is None:
            unload = getattr(self.index, "unload", None)
            if unload is not None:
                unload()
        self.index = None


class StagedApp:
    """Components, services, schedulers and the asyncio loop of the staged
    path, as the reference's serve/factory.py wires them from a profile,
    held in one `ComponentRegistry`: each component is loaded (and warmed)
    as it is registered, started in order, stopped and unloaded in reverse
    order. `index` (optional) is a built index that takes the place of
    INDEX_PATH."""

    _SERVICES = ("retrieval_executor", "generation_service", "orchestrator")

    def __init__(
        self, settings: Settings, *, index=None, mesh: Optional[MeshContext] = None,
    ) -> None:
        self.profile = profile = load_role_profile(settings)
        if profile.batch_overrides:
            settings = replace_settings(settings, **profile.batch_overrides)
        self.settings = settings
        # the mesh comes first: every component is placed on it
        mesh_comp = MeshComponent(settings, mesh)
        mesh_comp.load()
        self.mesh = ctx = mesh_comp.ctx
        self.device = device = ctx.front
        self.registry = reg = ComponentRegistry()
        for spec in profile.components:
            t = spec.type
            if t is ComponentType.MESH:
                reg.register(spec.name, mesh_comp, load=False)
                continue
            if t is ComponentType.EMBEDDER:
                comp = EmbedderComponent(settings, device, mesh=ctx)
            elif t is ComponentType.INDEX:
                comp = IndexComponent(_index_settings(settings, spec.config), device, index,
                                      mesh=ctx)
            elif t is ComponentType.DOC_STORE:
                comp = DocumentStore(settings)
            elif t is ComponentType.RERANKER:
                comp = RerankerComponent(settings, device, mesh=ctx)
            elif t is ComponentType.LLM:
                comp = LLMComponent(settings, device, mesh=ctx)
            elif t is ComponentType.SENTIMENT:
                comp = SentimentComponent(settings, device, mesh=ctx)
            elif t is ComponentType.TOXICITY:
                comp = ToxicityComponent(settings, device, mesh=ctx)
            else:  # orchestrator: below
                continue
            reg.register(spec.name, comp)
            if spec.name != t.value and t.value not in reg:
                reg.alias(t.value, spec.name)
        get = self.components.get
        self.retrieval_executor = self.generation_service = self.orchestrator = None
        if "retrieval" in profile.routes:
            self.retrieval_executor = reg.register("retrieval_executor", RetrievalExecutor(
                settings, index=get("index"), embedder=get("embedder"),
                doc_store=get("doc_store"), reranker=get("reranker"),
            ), load=False)
        if "generation" in profile.routes:
            self.generation_service = reg.register("generation_service", GenerationService(
                settings, llm=get("llm"), reranker=get("reranker"),
                sentiment=get("sentiment"), toxicity=get("toxicity"),
                doc_store=get("doc_store"),
            ), load=False)
        self.routes = {"/clear_cache": self.clear_cache}
        if "gateway" in profile.routes:
            self.orchestrator = reg.register("orchestrator", Orchestrator(
                settings, retrieval_executor=self.retrieval_executor,
                generation_service=self.generation_service,
                embedder=get("embedder") if self.retrieval_executor is None else None,
            ), load=False)
            self.routes["/query"] = self.query
        if self.retrieval_executor is not None:
            self.routes["/retrieve"] = self.retrieve
            if settings.fast_json:
                # built (or refused) at start-up, not in the first request
                fastjson.load_lib()
        if self.generation_service is not None:
            self.routes["/generate"] = self.generate
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="staged-loop", daemon=True
        )
        self._thread.start()
        self._submit(self._start()).result(timeout=60)

    @property
    def components(self) -> dict[str, Any]:
        """The profile's components by type name (the index itself, not its
        holder)."""
        reg = self.registry
        return {
            t.value: getattr(reg.get(t.value), "index", reg.get(t.value))
            for t in ComponentType if t.value in reg and t.value not in self._SERVICES
        }

    async def _start(self) -> None:
        s = self.settings
        self.retrieval_scheduler = (
            BatchScheduler(
                self.retrieval_executor.process_batch,
                batch_size=s.retrieval_batch_size,
                timeout_s=s.retrieval_batch_timeout_ms / 1e3,
                adaptive=s.adaptive_batching,
                flush_on_ready=s.batch_flush_on_ready,
                name="retrieval", run_id=s.run_id, node=str(s.node_number),
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
                name="generation", run_id=s.run_id, node=str(s.node_number),
            )
            if gen is not None else None
        )
        # the LLM's decode engine (under USE_CONTINUOUS_BATCHING), then the
        # orchestrator's workers
        await self.registry.start_all()

    async def _stop(self) -> None:
        """The gateway drains into the schedulers, the schedulers flush,
        then every component stops in reverse order (the orchestrator's
        second stop finds nothing to do)."""
        if self.orchestrator is not None:
            await self.orchestrator.stop()
        for sched in (self.retrieval_scheduler, self.generation_scheduler):
            if sched is not None:
                await sched.stop()
        await self.registry.stop_all()

    def _submit(self, coro) -> concurrent.futures.Future:
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def _wait(self, coro):
        return self._submit(coro).result(timeout=self.settings.request_timeout_s)

    def query(self, req: dict) -> dict:
        query, request_id, k = _parse_query(req)
        return self._wait(self.orchestrator.process_query(query, request_id, k))

    def retrieve(self, req: dict):
        items, response_format = _parse_retrieve(req, self.settings.index_dim)
        return self._retrieve(items, response_format)

    def retrieve_fast(self, body: bytes):
        """A `/retrieve` body in the native codec's strict shape, answered
        as `retrieve` answers it (the reference's `serve/http.py:223-240`);
        None for any other body, which then takes `retrieve`."""
        fj = fastjson.parse_retrieve(body, self.settings.index_dim)
        if fj is None:
            return None
        items = [
            {"query": "", "embedding": fj.embeddings[i],
             "k": int(fj.item_k[i]) if fj.item_k[i] >= 0 else fj.k,
             "rerank": fj.rerank}
            for i in range(fj.embeddings.shape[0])
        ]
        return self._retrieve(items, fj.response_format)

    def _retrieve(self, items: list[dict], response_format: str):
        """The reply: a dict, or the id_only JSON already encoded (bytes)."""
        results = self._wait(self.retrieval_scheduler.enqueue_many(items))
        if response_format == "b64":
            return _pack_results_b64(results)
        wire = [_result_wire(r) for r in results]
        if self.settings.fast_json:
            encoded = fastjson.encode_results(wire)
            if encoded is not None:
                return encoded
        return {"results": wire}

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
        reg = self.registry
        named = {k: reg.get(k) for k in reg.names}
        comps = reg.health()
        ok = all(comps.values())
        body = {
            "status": "ok" if ok else "degraded",
            **node_health(self.settings),
            "profile": self.profile.name,
            "device": str(self.device),
            "mesh": mesh_health(self.mesh),
            "components": comps,
            "random_weights": [
                k for k, c in named.items() if getattr(c, "random_weights", False)
            ],
            "weights": weights_health(named),
            "kernel_launches": kernel_launches(),
        }
        llm = self.components.get("llm")
        if llm is not None and llm.is_loaded:
            body["decode_graphs"] = decode_graph_health(llm)
            body["llm_ladder"] = list(llm.ladder)
        return (200 if ok else 503), body

    def close(self) -> None:
        """Flush the schedulers, stop every component and the loop, then
        unload the components in reverse order."""
        if not self.loop.is_closed():
            self._submit(self._stop()).result(timeout=self.settings.request_timeout_s)
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=60)
            self.loop.close()
            self.registry.unload_all()


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

    def _reply(self, code: int, data: bytes, content_type: str = "application/json",
               *, route: bool = False) -> None:
        """A reply with the CORS headers. A route's reply (not an error) is
        compressed as the reference's compression middleware compresses
        it; then any reply of GZIP_MIN_SIZE bytes or more that is not
        zstd-framed is gzipped for a client that accepts gzip."""
        s = self.server.app.settings
        headers = cors_headers(self.headers.get("Origin"))
        if (route and s.compression_algorithm == "zstd"
                and "zstd" in self.headers.get(ACCEPT_HEADER, "")):
            data, encoded = compress(
                data, level=s.compression_level, min_bytes=s.compression_min_bytes,
                run_id=s.run_id, node=str(s.node_number), direction="in",
            )
            if encoded:
                headers[ENCODING_HEADER] = "zstd"
        if (len(data) >= GZIP_MIN_SIZE and ENCODING_HEADER not in headers
                and "gzip" in self.headers.get("Accept-Encoding", "")):
            data = gzip.compress(data, compresslevel=6)
            headers["Content-Encoding"] = "gzip"
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        if self.close_connection:
            self.send_header("Connection", "close")
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send(self, code: int, body, *, route: bool = False) -> None:
        """`body`: a dict, or JSON already encoded (bytes)."""
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self._reply(code, data, route=route)

    def _error(self, code: int, exc: BaseException, body: dict) -> None:
        """An error reply, counted in ERRORS_TOTAL by the exception's type."""
        s = self.server.app.settings
        ERRORS_TOTAL.labels(s.run_id, str(s.node_number), "http", type(exc).__name__).inc()
        self._send(code, body)

    def _read_body(self) -> Optional[bytes]:
        """The whole body (on a keep-alive connection unread bytes would be
        taken for the next request); None after a 400 for a bad length."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length < 0:
                raise ValueError(length)
            return self.rfile.read(length)
        except ValueError:
            self.close_connection = True
            self._send(400, {"error": "bad Content-Length", "error_type": "validation"})
            return None

    def do_OPTIONS(self):
        """A CORS preflight answers 204; any other OPTIONS 405."""
        if self._read_body() is None or self._closing():
            return
        if "Access-Control-Request-Method" not in self.headers:
            self._send(405, {"error": f"OPTIONS {self.path} is not allowed"})
            return
        self.send_response(204)
        for k, v in cors_headers(self.headers.get("Origin")).items():
            self.send_header(k, v)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        if self._closing():
            return
        if self.path == "/health":
            code, body = self.server.app.health()
            self._send(code, body, route=True)
        elif self.path == "/metrics":
            self._reply(200, render_metrics(), CONTENT_TYPE_LATEST)
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _profile(self, action: str) -> None:
        """`/profile/start` and `/profile/stop`: 409 for a second start or
        a stop with no trace running."""
        trace = self.server.trace
        try:
            if action == "start":
                self._send(200, {"status": "tracing", "log_dir": trace.start()})
            else:
                path = trace.stop()
                self._send(200, {"status": "stopped", "log_dir": trace.log_dir,
                                 "trace": path})
        except RuntimeError as e:
            self._send(409, {"error": str(e)[:200]})

    def do_POST(self):
        body = self._read_body()
        if body is None or self._closing():
            return
        if self.path in ("/profile/start", "/profile/stop"):
            self._profile(self.path.rsplit("/", 1)[1])
            return
        handler = self.server.app.routes.get(self.path)
        if handler is None:
            self._send(404, {"error": f"no route {self.path}"})
            return
        if self.path == "/query":
            self.server.refresh_gauges()
        try:
            if self.headers.get(ENCODING_HEADER) == "zstd":
                body = decompress(body)
            out = None
            if self.path == "/retrieve" and self.server.app.settings.fast_json:
                out = self.server.app.retrieve_fast(body)
            if out is None:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the request body must be a JSON object")
                out = handler(req)
        except ValueError as e:  # bad JSON and bad base64 are ValueErrors too
            self._error(400, e, {"error": str(e)[:500], "error_type": "validation"})
        except RPCError as e:  # a peer node failed: unavailable, not internal
            logger.exception("request failed")
            self._error(503, e, {"error": str(e)[:500], "error_type": "unavailable"})
        except (TimeoutError, concurrent.futures.TimeoutError) as e:
            self._error(504, e, {"error": "request timed out", "error_type": "timeout"})
        except RuntimeError as e:  # readiness failures -> 503
            msg = str(e)
            logger.exception("request failed")
            code = 503 if "not ready" in msg or "not loaded" in msg else 500
            self._error(code, e, {"error": msg[:500], "error_type": "unavailable"})
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            logger.exception("request failed")
            self._error(500, e, {"error": str(e)[:500], "error_type": "internal"})
        else:
            self._send(200, out, route=True)


class RAGServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, app, host: str, port: int):
        # bind after the fields exist: a failed bind must raise its OSError
        # to the caller, who closes the app (the base class would run the
        # overridden server_close on a half-built server)
        super().__init__((host, port), _Handler, bind_and_activate=False)
        self.app = app
        self.closing = False
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        self.trace = DeviceTraceCapture()
        self._gauges_at = float("-inf")
        try:
            self.server_bind()
            self.server_activate()
        except OSError:
            self.socket.close()
            raise

    def refresh_gauges(self) -> None:
        """The resource gauges, at most every GAUGE_PERIOD_S."""
        now = time.monotonic()
        if now - self._gauges_at > GAUGE_PERIOD_S:
            self._gauges_at = now
            s = self.app.settings
            update_resource_gauges(s.run_id, str(s.node_number))

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
        if self.trace.active:
            self.trace.stop()
        self.app.close()
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:  # already closed by the peer
                pass


def make_server(
    settings: Settings, port: Optional[int] = None, *, index=None,
    mesh: Optional[MeshContext] = None,
) -> RAGServer:
    """Build the app for `settings` and bind the server; `port` overrides
    BASE_PORT + NODE_NUMBER (0 picks a free port); `index` hands the staged
    path a built index in place of INDEX_PATH; `mesh` takes the place of
    the settings' mesh. A node whose settings ask for zstd refuses to start
    without `zstandard`. WARMUP_BUCKETS unset means on here
    (`resolve_serving_settings`). An SPMD front door that cannot bind
    stops its workers (OP_STOP, as the app closes) before it raises."""
    require_codec(settings)
    settings = resolve_serving_settings(settings)
    if settings.use_fused_pipeline:
        if index is not None:
            raise ValueError("the fused path loads its index from INDEX_PATH")
        registry = ComponentRegistry()
        app = FusedApp(build_executor(settings, registry, mesh), registry)
    else:
        app = StagedApp(settings, index=index, mesh=mesh)
    try:
        return RAGServer(
            app, settings.listen_host,
            settings.listen_port if port is None else port,
        )
    except OSError:
        app.close()  # unloads the index: an SPMD proxy sends OP_STOP
        raise


def serve_worker(settings: Settings) -> None:
    """An SPMD worker process (DIST_PROCESS_ID > 0): its app's components,
    no HTTP; the front door's broadcast searches until OP_STOP, then the
    components stop (reference `serve/runtime.py:74-87`). It logs its
    kernels' launch counts as it leaves: it has no /health to read them."""
    app = StagedApp(resolve_serving_settings(settings))
    try:
        index = app.components.get("index")
        if index is None:
            raise RuntimeError("SPMD worker process has no index component")
        worker_loop(index)
        logger.info("SPMD worker kernel launches %s", json.dumps(kernel_launches()))
    finally:
        app.close()


def main() -> None:
    settings = load_settings()
    logging.basicConfig(
        level=getattr(logging, settings.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    setup_tracing(settings)
    init_distributed(settings)
    if is_spmd() and not is_front_door():
        serve_worker(settings)
        return
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
