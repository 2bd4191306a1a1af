"""Warm-up and the HTTP layer of the port's servers on the CPU.

A tiny staged server and a tiny fused server with WARMUP_BUCKETS=1 warm
exactly the buckets they can dispatch, leave no cache entry behind, and
then answer byte for byte as the same servers without warm-up. With the
decode graphs' CUDA code path run on the CPU (an eager stand-in for the
capture), warm-up captures every graph the requests replay and the
requests capture none. Then `/metrics` after three `/query`, `/profile`
start and stop with both 409s, the CORS preflight and headers against the
reference's `_cors_headers`, and gzip at and below GZIP_MIN_SIZE and on a
zstd-framed reply.

The tiny decoder's vocabulary is widened to 1024 rows (the hash
tokenizer's word ids start at 1000) and its layer weights scaled by 20 so
that it answers in words, as in tests/test_torch_multinode.py.
"""

import asyncio
import dataclasses
import gzip
import http.client
import json
import threading
import uuid

import numpy as np
import pytest
import torch
from aiohttp.test_utils import make_mocked_request
from prometheus_client.parser import text_string_to_metric_families

from rag_inference_pipeline_tpu.serve.http import _cors_headers
from rag_inference_pipeline_tpu_torch.core.config import load_settings
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import decode_graph
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.telemetry.profiling import DeviceTraceCapture
from rag_inference_pipeline_tpu_torch.utils.docstore import build_sqlite_store

CPU = torch.device("cpu")
DIM = 64
WAIT_S = 120
_WORDS = ["alpha", "beta", "gamma", "delta", "retrieval", "vector", "tpu",
          "gpu", "kernel", "index", "query", "answer", "doc", "cluster"]
STAGED = dict(
    EMBEDDING_MODEL="tiny-embed", RERANKER_MODEL="tiny-rerank", LLM_MODEL="tiny-llm",
    SENTIMENT_MODEL="tiny-sentiment", TOXICITY_MODEL="tiny-toxicity",
    BATCH_SHAPE_BUCKETS="1,2,4,8,16", PREFILL_BUCKETS="32,64", MAX_TOKENS="4",
    TRUNCATE_LENGTH="96", RETRIEVAL_K="5", LLM_CONTEXT_DOCS="2", LLM_DOC_CHARS="60",
    PARAM_DTYPE="float32", INDEX_DIM=str(DIM), INDEX_PQ_M="16", GATEWAY_BATCH_SIZE="4",
    GATEWAY_PIPELINE_CHUNKS="2", MODEL_WEIGHTS_DIR="", DEVICE_PLATFORM="cpu",
    DOC_STORE_BACKEND="sqlite", INDEX_KIND="ivf_flat", INDEX_NPROBE="4",
    COMPRESSION_ALGORITHM="none",
)
QUERIES = [f"{w} and {v}: what does the corpus say?" for w, v in
           zip(_WORDS[:4], _WORDS[5:9])]


class _EagerCapture:
    """A CUDA graph's stand-in on the CPU: the body runs when built and on
    each replay (tests/test_torch_decode_graph.py)."""

    def __init__(self, body, device, pool=None):
        body()
        self.body = body
        self.pool_bytes, self.capture_s = 0, 0.0

    def replay(self):
        self.body()


@pytest.fixture()
def tiny(monkeypatch):
    """The widened, word-answering tiny decoder; the decode graphs' code
    path on the CPU."""
    base = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(
        lambda: dataclasses.replace(base(), vocab_size=1024)))
    init = tcomp.init_qwen_params

    def scaled_init(cfg, **kw):
        tree = init(cfg, **kw)
        with torch.no_grad():
            for lp in tree.layers:
                for name, p in lp.named_parameters():
                    if name.endswith("_w"):
                        p.mul_(20)
        return tree

    monkeypatch.setattr(tcomp, "init_qwen_params", scaled_init)
    monkeypatch.setattr(decode_graph, "uses_graphs", lambda device: True)
    monkeypatch.setattr(decode_graph, "CapturedGraph", _EagerCapture)
    monkeypatch.setattr(decode_graph.GraphCache, "pool", lambda self: None)


@pytest.fixture(scope="module")
def staged_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("warmup")
    rng = np.random.default_rng(5)
    docs = [(i, f"title {i}", " ".join(rng.choice(_WORDS, rng.integers(4, 20))))
            for i in range(300)]
    build_sqlite_store(str(tmp / "documents.db"), docs)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ivf = IVFFlatIndex(DIM, 8, nprobe=3, device=CPU)
    ivf.train_add(vecs, iters=3)
    ivf.save(str(tmp / "ivf.npz"))
    return dict(STAGED, DOCUMENT_DB_PATH=str(tmp / "documents.db"),
                INDEX_PATH=str(tmp / "ivf.npz")), vecs


@pytest.fixture(scope="module")
def fused_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("warmup_fused")
    rng = np.random.default_rng(6)
    idx = FlatIndex(DIM, device=CPU, rescore_k=64)
    idx.add(rng.standard_normal((300, DIM)).astype(np.float32))
    idx.save(str(tmp / "index.npz"))
    toks = rng.integers(1000, 1024, (300, 8)).astype(np.int32)
    np.save(tmp / "doc_tokens.npy", toks)
    np.save(tmp / "doc_tokens_mask.npy", np.ones_like(toks))
    return {
        "DEVICE_PLATFORM": "cpu", "USE_FUSED_PIPELINE": "1", "INDEX_DTYPE": "int8",
        "INDEX_PATH": str(tmp / "index.npz"), "DOC_TOKENS_PATH": str(tmp / "doc_tokens.npy"),
        "EMBEDDING_MODEL": "tiny-embed", "LLM_MODEL": "tiny-llm",
        "SENTIMENT_MODEL": "tiny-sentiment", "TOXICITY_MODEL": "tiny-toxicity",
        "BATCH_SHAPE_BUCKETS": "1,2,4,8,16", "MAX_TOKENS": "3", "TRUNCATE_LENGTH": "32",
        "RETRIEVAL_K": "5", "PARAM_DTYPE": "float32", "MODEL_WEIGHTS_DIR": "",
        "COMPRESSION_ALGORITHM": "none",
    }


@pytest.fixture()
def serve():
    running = []

    def start(env):
        server = runtime.make_server(load_settings(env), port=0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        running.append((server, th))
        return server

    yield start
    for server, th in running:
        server.shutdown()
        server.server_close()
        th.join(timeout=WAIT_S)
        assert not th.is_alive()


@pytest.fixture(scope="module")
def retrieval_node(staged_env):
    """One cold retrieval_default node with zstd replies, shared by the
    HTTP-layer tests."""
    env, _ = staged_env
    server = runtime.make_server(load_settings({
        **env, "WARMUP_BUCKETS": "0", "PIPELINE_ROLE_PROFILE": "retrieval_default",
        "COMPRESSION_ALGORITHM": "zstd", "COMPRESSION_MIN_BYTES": "64"}), port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield server
    server.shutdown()
    server.server_close()
    th.join(timeout=WAIT_S)
    assert not th.is_alive()


def _call(server, method, path, body=None, headers=None):
    """(status, headers, body bytes) of one request on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=WAIT_S)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={
            **({"Content-Type": "application/json"} if data else {}), **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _queries(server, tag):
    out = []
    for i, q in enumerate(QUERIES):
        status, _, body = _call(server, "POST", "/query", {"query": q, "request_id": f"{tag}{i}"})
        assert status == 200, body
        out.append(body)
    return out


def _graphs(llm) -> int:
    return len(decode_graph.graphs_of(llm.params))


def test_resolve_serving_settings():
    assert load_settings({}).warmup_buckets is None
    assert runtime.resolve_serving_settings(load_settings({})).warmup_buckets is True
    off = load_settings({"WARMUP_BUCKETS": "0"})
    assert runtime.resolve_serving_settings(off).warmup_buckets is False


def test_staged_warmup_warms_the_dispatched_buckets(tiny, staged_env, serve):
    env, vecs = staged_env
    cold = serve({**env, "WARMUP_BUCKETS": "0"})
    warm = serve(env)  # make_server: unset means on
    comps = warm.app.components
    llm = comps["llm"]
    # GENERATION_BATCH_SIZE=8: buckets up to 8 of the 1..16 ladder; the
    # prefill lengths 32, 64 and the cap min(96, 256 - 4)
    assert llm.warmed == tuple((b, p) for b in (1, 2, 4, 8) for p in (32, 64, 96))
    for name in ("embedder", "reranker", "sentiment", "toxicity"):
        assert comps[name].warmed_buckets == (1, 2, 4, 8, 16), name
    ks = (5, 16, 32, 64, 128)
    assert warm.app.registry.get("index").warmed == (
        ((1, 5),) + tuple((b, k) for b in (1, 2, 4, 8, 16) for k in ks))
    assert cold.app.components["llm"].warmed == ()
    assert cold.app.registry.get("index").warmed == ()
    assert _graphs(llm) == 12 and _graphs(cold.app.components["llm"]) == 0
    # no cache entry a request could hit
    app = warm.app
    for cache in (app.orchestrator.query_cache, app.retrieval_executor.search_cache,
                  comps["embedder"].cache, comps["doc_store"].cache):
        assert not cache._data
    answers = _queries(warm, "q")
    assert answers == _queries(cold, "q")
    assert any(json.loads(a)["generated_response"].strip() for a in answers)
    body = {"items": [{"embedding": v.tolist()} for v in vecs[:3]] + [{"query": "gpu", "k": 7}]}
    assert _call(warm, "POST", "/retrieve", body)[2] == _call(cold, "POST", "/retrieve", body)[2]
    assert _graphs(llm) == 12  # the requests captured nothing new
    _, _, health = _call(warm, "GET", "/health")
    assert json.loads(health)["decode_graphs"] == {"count": 12, "pool_mb": 0.0}


def test_engine_warmup_runs_the_prefill_only(tiny, staged_env, serve):
    env, _ = staged_env
    warm = serve({**env, "WARMUP_BUCKETS": "1", "USE_CONTINUOUS_BATCHING": "1",
                  "DECODE_MAX_CONCURRENCY": "4", "KV_CACHE_MAX_LEN": "128"})
    llm = warm.app.components["llm"]
    assert llm.warmed == tuple((b, p) for b in (1, 2, 4, 8) for p in (32, 64, 96))
    # only the engine's segment graph, which it captures when it starts
    assert _graphs(llm) == 0 and llm.engine.graph is not None
    _, _, health = _call(warm, "GET", "/health")
    assert json.loads(health)["decode_graphs"]["count"] == 1


def test_fused_warmup_warms_the_dispatched_buckets(tiny, fused_env, serve):
    cold = serve({**fused_env, "WARMUP_BUCKETS": "0"})
    warm = serve({**fused_env, "WARMUP_BUCKETS": "1"})
    ex = warm.executor
    # FUSED_CHUNK_LANES=8: no chunk is padded past bucket 8 of 1..16
    assert ex.warmed_buckets == (1, 2, 4, 8) and ex.warmup_s > 0
    assert cold.executor.warmed_buckets == ()
    assert ex.llm.warmed == ()  # the fused pipeline owns decode
    assert _graphs(ex.llm) == 4
    assert _queries(warm, "f") == _queries(cold, "f")
    assert _graphs(ex.llm) == 4
    status, headers, text = _call(warm, "GET", "/metrics")
    assert status == 200 and headers["content-type"] == "text/plain; version=0.0.4; charset=utf-8"
    assert {f.name for f in text_string_to_metric_families(text.decode())} >= {
        "pipeline_requests", "pipeline_stage_duration_seconds"}


def _metric(text: str, sample: str, **labels) -> float:
    total = 0.0
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name == sample and all(s.labels.get(k) == v for k, v in labels.items()):
                total += s.value
    return total


def test_metrics_after_three_queries(tiny, staged_env, serve):
    env, _ = staged_env
    run_id = f"m-{uuid.uuid4().hex}"
    server = serve({**env, "WARMUP_BUCKETS": "0", "RUN_ID": run_id})
    for i, q in enumerate(QUERIES[:3]):
        assert _call(server, "POST", "/query", {"query": q, "request_id": str(i)})[0] == 200
    assert _call(server, "POST", "/query", {"query": QUERIES[0]})[0] == 200  # cached
    assert _call(server, "POST", "/query", {"query": " "})[0] == 400
    status, headers, raw = _call(server, "GET", "/metrics")
    text = raw.decode()
    assert status == 200 and headers["content-type"] == runtime.CONTENT_TYPE_LATEST
    for name in ("pipeline_requests_total", "pipeline_request_latency_seconds",
                 "pipeline_stage_duration_seconds", "pipeline_batch_size",
                 "pipeline_batch_flush_total", "pipeline_batch_wait_seconds",
                 "pipeline_queue_depth", "pipeline_cache_events_total",
                 "pipeline_rpc_duration_seconds", "pipeline_errors_total",
                 "pipeline_compression_ratio", "pipeline_memory_rss_bytes",
                 "pipeline_device_memory_bytes", "pipeline_tokens_generated_total",
                 "pipeline_engine_lanes_active", "pipeline_engine_segments_total"):
        assert f"# HELP {name} " in text and f"# TYPE {name} " in text, name
    r = dict(run_id=run_id)
    assert _metric(text, "pipeline_requests_total", service="gateway", status="ok", **r) == 3
    assert _metric(text, "pipeline_requests_total", status="cache_hit", **r) == 1
    assert _metric(text, "pipeline_request_latency_seconds_count", **r) == 3
    assert _metric(text, "pipeline_cache_events_total", cache="query", event="miss", **r) == 3
    assert _metric(text, "pipeline_cache_events_total", cache="query", event="hit", **r) == 1
    assert _metric(text, "pipeline_errors_total", service="http", error_type="ValueError",
                   **r) == 1
    for service, stages in (("retrieval", ("embed", "search", "fetch")),
                            ("generation", ("rerank", "llm", "sentiment", "toxicity"))):
        for stage in stages:
            assert _metric(text, "pipeline_stage_duration_seconds_count",
                           service=service, stage=stage, **r) >= 1, stage
    assert _metric(text, "pipeline_batch_size_count", service="gateway", **r) >= 1
    assert _metric(text, "pipeline_memory_rss_bytes", **r) > 0


def test_profile_start_and_stop(retrieval_node, tmp_path):
    server = retrieval_node
    server.trace = DeviceTraceCapture(str(tmp_path / "traces"))
    status, _, body = _call(server, "POST", "/profile/stop")
    assert status == 409
    status, _, body = _call(server, "POST", "/profile/start")
    assert (status, json.loads(body)) == (200, {"status": "tracing",
                                                "log_dir": str(tmp_path / "traces")})
    assert _call(server, "POST", "/profile/start")[0] == 409
    assert _call(server, "POST", "/retrieve", {"items": [{"query": "gpu"}]})[0] == 200
    status, _, body = _call(server, "POST", "/profile/stop")
    reply = json.loads(body)
    assert status == 200 and reply["status"] == "stopped"
    assert reply["log_dir"] == str(tmp_path / "traces")
    with open(reply["trace"]) as f:
        assert json.load(f)["traceEvents"]
    assert _call(server, "POST", "/profile/stop")[0] == 409


@pytest.mark.parametrize("origin", [None, "https://ui.example"])
def test_cors_matches_reference(retrieval_node, origin):
    server = retrieval_node
    hdrs = {"Access-Control-Request-Method": "POST",
            **({"Origin": origin} if origin else {})}
    want = {k.lower(): v for k, v in
            _cors_headers(make_mocked_request("OPTIONS", "/retrieve", headers=hdrs)).items()}
    status, headers, body = _call(server, "OPTIONS", "/retrieve", headers=hdrs)
    assert status == 204 and body == b""
    assert {k: headers[k] for k in want} == want
    assert ("vary" in headers) == (origin is not None)
    # a plain OPTIONS is no preflight; every other reply carries the headers
    plain = {"Origin": origin} if origin else {}
    assert _call(server, "OPTIONS", "/retrieve", headers=plain)[0] == 405
    status, headers, _ = _call(server, "POST", "/retrieve", {"items": [{"query": "gpu"}]},
                               headers=plain)
    assert status == 200 and {k: headers[k] for k in want} == want
    assert _call(server, "GET", "/nowhere", headers=plain)[1]["access-control-allow-origin"] \
        == (origin or "*")


def test_gzip_at_and_below_the_threshold(retrieval_node, staged_env):
    server, (_, vecs) = retrieval_node, staged_env
    big = {"items": [{"embedding": v.tolist()} for v in vecs[:8]]}
    _, plain_h, plain = _call(server, "POST", "/retrieve", big)
    assert len(plain) >= runtime.GZIP_MIN_SIZE and "content-encoding" not in plain_h
    _, h, body = _call(server, "POST", "/retrieve", big, {"Accept-Encoding": "gzip"})
    assert h["content-encoding"] == "gzip" and gzip.decompress(body) == plain
    assert int(h["content-length"]) == len(body)
    small = {"items": [{"embedding": vecs[0].tolist(), "k": 1}]}
    _, h, body = _call(server, "POST", "/retrieve", small, {"Accept-Encoding": "gzip"})
    assert len(body) < runtime.GZIP_MIN_SIZE and "content-encoding" not in h
    json.loads(body)
    _, h, body = _call(server, "POST", "/retrieve", big, {
        "Accept-Encoding": "gzip", "X-Ragtpu-Accept-Encoding": "zstd"})
    assert h["x-ragtpu-encoding"] == "zstd" and "content-encoding" not in h


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """A later file on the same xdist worker gets a fresh event loop
    policy (tests/test_torch_multinode.py says why)."""
    yield
    asyncio.set_event_loop_policy(None)
