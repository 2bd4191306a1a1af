"""The three-node deployment of the port on the CPU: the orchestrator's
RPC bodies against the JAX orchestrator's, each side with a recording fake
RPC, in the `full`, `id_only` and `compressed` payload modes and with a
gateway-side embedder; then three port servers in one process on
consecutive ports (gateway, retrieval, generation) answering `/query`
byte for byte as the `single_node_full` port server does, `/generate`,
`/clear_cache` with its cascade, the binary `/retrieve` wire, zstd bodies
both ways and a failed peer as 503; and the launcher
`tools/start_pipeline.py` starting three node processes on the fixture
checkpoints.

The in-process servers run the tiny models with random seeded weights: the
decoder widened to 1024 rows (the hash tokenizer's word ids start at 1000)
with its layer weights scaled by 20, so that it answers in words, and the
toxicity bias lowered, so that the answers are not all filtered
(tests/test_torch_staged.py does the same to the JAX-converted weights).
"""

import asyncio
import base64
import dataclasses
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.engine.orchestrator import Orchestrator as JOrchestrator
from rag_inference_pipeline_tpu.serve.compression import pack_docs as j_pack_docs
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.engine.orchestrator import Orchestrator
from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.serve import compression as tcompress
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.serve.rpc import ACCEPT_HEADER, ENCODING_HEADER
from rag_inference_pipeline_tpu_torch.utils.docstore import build_sqlite_store

CPU = torch.device("cpu")
DIM = 64  # BertConfig.tiny().hidden
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "weights")
WAIT_S = 120  # every socket wait of these tests

# ---------------------------------------------------------------------------
# The orchestrator's RPC bodies against the JAX orchestrator's
# ---------------------------------------------------------------------------

_ORCH = dict(total_nodes=3, gateway_batch_size=4, gateway_batch_timeout_ms=10.0,
             gateway_pipeline_chunks=2, retrieval_k=3)
_QUERIES = ["what is a kernel?", "tell me about vectors", "gpu or tpu?", "index please"]


def _docs(ids):
    return [{"id": i, "title": f"title {i}", "content": f"content of {i} " * 3,
             "score": 1.0 - i / 100} for i in ids]


class _RecordingRPC:
    """Answers /retrieve in `mode`'s shape and /generate with the query;
    records every body as JSON. `fail_chunk` fails that /retrieve call."""

    def __init__(self, mode, fail_chunk=None):
        self.mode, self.fail_chunk = mode, fail_chunk
        self.calls = {"retrieve": [], "generate": []}

    async def post(self, url, payload, target="peer"):
        route = url.rsplit("/", 1)[1]
        self.calls[route].append(json.dumps(payload))
        if route == "retrieve":
            if len(self.calls["retrieve"]) == self.fail_chunk:
                raise RuntimeError("retrieval peer exploded")
            out = []
            for j, it in enumerate(payload["items"]):
                ids = [3 * j + len(it["query"]) % 5 + d for d in range(3)]
                res = {"ids": ids, "scores": [0.9, 0.8, 0.7]}
                if self.mode == "full":
                    res["documents"] = _docs(ids)
                elif self.mode == "compressed":
                    res["compressed_docs"] = j_pack_docs(_docs(ids))
                out.append(res)
            return {"results": out}
        return {"results": [
            {"generated_response": f"answer to {it['query']} with "
             f"{sorted(k for k in it if k != 'query')}",
             "sentiment": "neutral", "is_toxic": False}
            for it in payload["items"]
        ]}

    async def close(self):
        pass


class _FakeEmbedder:
    is_loaded = True

    def encode(self, texts):
        rng = [np.random.default_rng(len(t) * 7919 + sum(map(ord, t))) for t in texts]
        return np.stack([r.standard_normal(8).astype(np.float32) for r in rng])


def _drive(orch, queries):
    async def go():
        await orch.start()
        try:
            return await asyncio.gather(
                *[orch.process_query(q, f"r{i}") for i, q in enumerate(queries)],
                return_exceptions=True)
        finally:
            await orch.stop()

    return asyncio.run(asyncio.wait_for(go(), timeout=WAIT_S))


@pytest.mark.parametrize("mode", ["full", "id_only", "compressed", "embedder"])
def test_orchestrator_rpc_bodies_match_jax(mode):
    """The same queries through both orchestrators: identical /retrieve and
    /generate bodies (the same `embeddings_b64` bytes with an embedder)
    and answers."""
    payload_mode = "full" if mode == "embedder" else mode
    kw = dict(_ORCH, documents_payload_mode=payload_mode)
    emb = {"embedder": _FakeEmbedder()} if mode == "embedder" else {}
    jrpc, trpc = _RecordingRPC(payload_mode), _RecordingRPC(payload_mode)
    jout = _drive(JOrchestrator(JSettings(**kw), rpc=jrpc, **emb), _QUERIES)
    tout = _drive(Orchestrator(Settings(**kw), rpc=trpc, **emb), _QUERIES)
    assert tout == jout and all(isinstance(o, dict) for o in tout)
    assert trpc.calls == jrpc.calls
    assert len(trpc.calls["retrieve"]) == 2  # a batch of 4 in two chunks
    body = json.loads(trpc.calls["retrieve"][0])
    assert ("embeddings_b64" in body) == (mode == "embedder")
    gen = json.loads(trpc.calls["generate"][0])["items"][0]
    want = {"full": "documents", "embedder": "documents", "id_only": "doc_ids",
            "compressed": "compressed_docs"}[mode]
    assert set(gen) == {"query", want}


def test_failed_remote_chunk_fails_only_its_futures():
    """The second chunk's /retrieve fails: its two requests fail, the other
    two answer, in both packages alike."""
    outs = []
    for orch_cls, settings_cls in ((JOrchestrator, JSettings), (Orchestrator, Settings)):
        rpc = _RecordingRPC("full", fail_chunk=2)
        outs.append(_drive(orch_cls(settings_cls(**_ORCH), rpc=rpc), _QUERIES))
    for out in outs:
        assert [isinstance(o, Exception) for o in out] == [False, False, True, True]
        assert "exploded" in str(out[2])
    assert outs[0][:2] == outs[1][:2]


def test_peer_result_count_is_checked():
    class Short(_RecordingRPC):
        async def post(self, url, payload, target="peer"):
            out = await super().post(url, payload, target)
            return {"results": out["results"][:-1]}

    out = _drive(Orchestrator(Settings(**_ORCH), rpc=Short("full")), _QUERIES[:1])
    assert isinstance(out[0], RuntimeError) and "returned 0 results for 1" in str(out[0])


# ---------------------------------------------------------------------------
# Three port servers in one process
# ---------------------------------------------------------------------------

_TINY = dict(
    EMBEDDING_MODEL="tiny-embed", RERANKER_MODEL="tiny-rerank", LLM_MODEL="tiny-llm",
    SENTIMENT_MODEL="tiny-sentiment", TOXICITY_MODEL="tiny-toxicity",
    BATCH_SHAPE_BUCKETS="1,2,4,8", PREFILL_BUCKETS="32,64", MAX_TOKENS="4",
    TRUNCATE_LENGTH="96", RETRIEVAL_K="5", LLM_CONTEXT_DOCS="2", LLM_DOC_CHARS="60",
    PARAM_DTYPE="float32", INDEX_DIM=str(DIM), INDEX_PQ_M="16", GATEWAY_BATCH_SIZE="4",
    GATEWAY_PIPELINE_CHUNKS="2", MODEL_WEIGHTS_DIR="", DEVICE_PLATFORM="cpu",
    DOC_STORE_BACKEND="sqlite", INDEX_KIND="ivf_flat", INDEX_NPROBE="4",
    RPC_BACKOFF_BASE_S="0.01", COMPRESSION_MIN_BYTES="64",
)
_WORDS = ["alpha", "beta", "gamma", "delta", "retrieval", "vector", "tpu",
          "gpu", "kernel", "index", "query", "answer", "doc", "cluster"]


def _free_base(n: int = 3) -> int:
    """A base port with `n` consecutive ports free just now."""
    for _ in range(100):
        base = random.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free base port")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A sqlite doc store and an IVF-Flat artifact over 300 unit rows."""
    tmp = tmp_path_factory.mktemp("multinode")
    rng = np.random.default_rng(3)
    docs = [(i, f"title {i}", " ".join(rng.choice(_WORDS, rng.integers(4, 20))))
            for i in range(300)]
    build_sqlite_store(str(tmp / "documents.db"), docs)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ivf = IVFFlatIndex(DIM, 8, nprobe=3, device=CPU)
    ivf.train_add(vecs, iters=3)
    ivf.save(str(tmp / "ivf.npz"))
    return dict(_TINY, DOCUMENT_DB_PATH=str(tmp / "documents.db"),
                INDEX_PATH=str(tmp / "ivf.npz")), vecs


@pytest.fixture()
def cluster(corpus, monkeypatch):
    """`single(**env)` starts a single_node_full server; `three(**env)` the
    three nodes on consecutive free ports. All stop after the test."""
    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(
        lambda: dataclasses.replace(tiny(), vocab_size=1024)))
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
    tox_load = tcomp.ToxicityComponent.load

    def calm_load(self):
        tox_load(self)
        self.params.classifier.b.fill_(-5.0)

    monkeypatch.setattr(tcomp.ToxicityComponent, "load", calm_load)
    env, _ = corpus
    running = []

    def serve(server):
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        running.append((server, th))
        return server

    def single(**over):
        return serve(runtime.make_server(load_settings({**env, **over}), port=0))

    def three(gateway=None, **over):
        for _ in range(10):
            base = _free_base()
            built = []
            try:
                for node in (2, 1, 0):
                    node_env = {**env, **over, "TOTAL_NODES": "3",
                                "NODE_NUMBER": str(node), "BASE_PORT": str(base)}
                    if node == 0 and gateway:
                        node_env["PIPELINE_ROLE_PROFILE"] = gateway
                    built.append(runtime.make_server(load_settings(node_env)))
            except OSError:  # a port was taken meanwhile: another base
                for server in built:
                    server.server_close()
                continue
            return [serve(s) for s in reversed(built)]  # nodes 0, 1, 2
        raise RuntimeError("could not bind three consecutive ports")

    yield single, three
    for server, th in reversed(running):
        server.shutdown()
        server.server_close()
        th.join(timeout=WAIT_S)
        assert not th.is_alive()


def _post(server, path, body, headers=None, raw=False):
    """(status, headers, body bytes) of one POST on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=WAIT_S)
    try:
        data = body if raw else json.dumps(body).encode()
        conn.request("POST", path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(server, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{server.server_address[1]}{path}", timeout=WAIT_S
    ) as r:
        return r.status, json.loads(r.read())


def _queries(n, tag="q"):
    return [{"query": f"{tag} {i}: tell me about {w} and {v}", "request_id": f"{tag}{i}"}
            for i, (w, v) in enumerate(zip(_WORDS[:n], _WORDS[3:3 + n]))]


@pytest.mark.parametrize("mode", ["full", "id_only", "compressed", "gateway_with_embedding"])
def test_three_nodes_answer_as_one(cluster, mode):
    """Sequential /query through the gateway: byte for byte the one-node
    server's replies; then concurrent ones all answer."""
    single, three = cluster
    env = {} if mode == "gateway_with_embedding" else {"DOCUMENTS_PAYLOAD_MODE": mode}
    one = single(**env)
    gateway, node1, node2 = three(
        gateway=mode if mode == "gateway_with_embedding" else None, **env)
    assert [_get(s, "/health")[1]["role"] for s in (gateway, node1, node2)] == [
        "gateway", "retrieval", "generation"]
    emb = gateway.app.components.get("embedder")
    assert gateway.app.orchestrator.embedder is emb
    assert (emb is not None) == (mode == "gateway_with_embedding")
    words = 0
    for q in _queries(5):
        want = _post(one, "/query", q)
        got = _post(gateway, "/query", q)
        assert got[0] == want[0] == 200
        assert got[2] == want[2]  # the same bytes
        words += bool(json.loads(got[2])["generated_response"].strip())
    assert words >= 3  # the tiny decoder answers in words
    out = [None] * 4

    def ask(i, q):
        out[i] = _post(gateway, "/query", q)

    threads = [threading.Thread(target=ask, args=(i, q))
               for i, q in enumerate(_queries(4, tag="c"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
        assert not t.is_alive()
    for i, (status, _, body) in enumerate(out):
        assert status == 200 and json.loads(body)["request_id"] == f"c{i}"
    # the gateway ran no stage itself: retrieval and generation were remote
    assert node1.app.retrieval_executor.search_cache._data
    assert gateway.app.retrieval_executor is gateway.app.generation_service is None


def test_clear_cache_cascades(cluster):
    single, three = cluster
    gateway, node1, node2 = three()
    for q in _queries(2):
        assert _post(gateway, "/query", q)[0] == 200
    assert gateway.app.orchestrator.query_cache._data
    assert node1.app.retrieval_executor.search_cache._data
    status, _, body = _post(gateway, "/clear_cache", {})
    assert status == 200 and json.loads(body) == {
        "cleared": ["query"], "cascade": {"retrieval": True, "generation": True}}
    assert not gateway.app.orchestrator.query_cache._data
    assert not node1.app.retrieval_executor.search_cache._data
    assert not node1.app.components["embedder"].cache._data
    assert json.loads(_post(node1, "/clear_cache", {})[2]) == {
        "cleared": ["search", "embedder", "doc_store"]}
    assert json.loads(_post(node2, "/clear_cache", {})[2]) == {"cleared": ["doc_store"]}
    one = single()
    assert json.loads(_post(one, "/clear_cache", {})[2]) == {
        "cleared": ["query", "search", "embedder", "doc_store"]}
    node2.shutdown()
    node2.server_close()  # a dead peer: the cascade says so
    status, _, body = _post(gateway, "/clear_cache", {})
    assert json.loads(body)["cascade"] == {"retrieval": True, "generation": False}
    status, _, body = _post(gateway, "/query", _queries(3)[2])
    assert status == 503 and json.loads(body)["error_type"] == "unavailable"


def test_generate_route(cluster):
    """/generate on the generation node as on the one-node server; doc ids
    and packed documents; bad items are 400."""
    single, three = cluster
    one = single()
    _, _, node2 = three()
    docs = [{"id": 3, "title": "title 3", "content": "gpu kernel index"},
            {"id": 9, "content": "vector cluster answer", "score": 0.5}]
    body = {"items": [
        {"query": "what about gpu kernels?", "documents": docs},
        {"query": "and by id?", "doc_ids": [5, 6, 7]},
        {"query": "packed", "compressed_docs": tcompress.pack_docs(docs)},
        {"query": "no documents"},
    ]}
    status, _, got = _post(node2, "/generate", body)
    assert status == 200 and got == _post(one, "/generate", body)[2]
    results = json.loads(got)["results"]
    assert len(results) == 4 and all(
        set(r) == {"generated_response", "sentiment", "is_toxic"} for r in results)
    for bad in ({"items": "x"}, {"items": [{"documents": []}]},
                {"items": [{"query": "a", "doc_ids": [1.5]}]}):
        assert _post(node2, "/generate", bad)[0] == 400
    assert _post(node2, "/query", {"query": "no gateway here"})[0] == 404


def test_binary_retrieve_wire(cluster, corpus):
    """embeddings_b64 with and without items gives the JSON wire's ids;
    response_format=b64 packs them in id_only mode and is a 400 with
    documents; zstd bodies both ways."""
    single, three = cluster
    _, vecs = corpus
    _, node1, _ = three(DOCUMENTS_PAYLOAD_MODE="id_only")
    rows = vecs[:6] + 0.001
    b64 = base64.b64encode(rows.astype("<f4").tobytes()).decode()
    status, _, plain = _post(node1, "/retrieve", {
        "items": [{"embedding": r.tolist()} for r in rows]})
    assert status == 200
    plain = json.loads(plain)["results"]
    assert [r["ids"][0] for r in plain] == list(range(6))
    status, _, itemless = _post(node1, "/retrieve", {"embeddings_b64": b64})
    assert status == 200 and json.loads(itemless)["results"] == plain
    status, _, packed = _post(node1, "/retrieve", {
        "items": [{} for _ in rows], "embeddings_b64": b64, "response_format": "b64"})
    packed = json.loads(packed)
    assert status == 200 and (packed["count"], packed["k"]) == (6, 5)
    ids = np.frombuffer(base64.b64decode(packed["ids_b64"]), "<i4").reshape(6, 5)
    scores = np.frombuffer(base64.b64decode(packed["scores_b64"]), "<f4").reshape(6, 5)
    assert ids.tolist() == [r["ids"] for r in plain]
    np.testing.assert_array_equal(scores, np.array([r["scores"] for r in plain], "<f4"))
    # zstd both ways: a compressed request body, a compressed reply
    body = json.dumps({"embeddings_b64": b64, "k": 5}).encode()
    zbody, was = tcompress.compress(body, min_bytes=0)
    assert was
    status, headers, reply = _post(node1, "/retrieve", zbody, raw=True, headers={
        ENCODING_HEADER: "zstd", ACCEPT_HEADER: "zstd"})
    assert status == 200 and headers.get(ENCODING_HEADER) == "zstd"
    assert reply[:4] == tcompress.ZSTD_MAGIC
    assert json.loads(tcompress.decompress(reply))["results"] == plain
    full = single(PIPELINE_ROLE_PROFILE="retrieval_default")
    status, _, err = _post(full, "/retrieve", {"embeddings_b64": b64, "response_format": "b64"})
    assert status == 400 and "id_only" in json.loads(err)["error"]
    status, _, docs = _post(full, "/retrieve", {"embeddings_b64": b64})
    docs = json.loads(docs)["results"]
    assert [r["ids"] for r in docs] == [r["ids"] for r in plain]
    assert docs[0]["documents"][0]["title"] == "title 0"


# ---------------------------------------------------------------------------
# The launcher: three node processes through the entry point
# ---------------------------------------------------------------------------


def test_start_pipeline_runs_three_node_processes(corpus, tmp_path):
    """tools/start_pipeline.py starts nodes 0, 1 and 2 (the fixture
    checkpoints), waits for their /health, serves /query end to end over
    the RPC hop, and stops every node on SIGTERM with exit code 0."""
    env, _ = corpus
    env = dict(env, MODEL_WEIGHTS_DIR=FIXTURE, EMBEDDING_MODEL="tiny-bert",
               RERANKER_MODEL="tiny-rerank", LLM_MODEL="tiny-qwen",
               SENTIMENT_MODEL="tiny-sent", TOXICITY_MODEL="tiny-tox",
               ALLOW_RANDOM_WEIGHTS="0", PREFILL_BUCKETS="64,128", MAX_TOKENS="4",
               TOTAL_NODES="3", OMP_NUM_THREADS="1")
    for attempt in range(3):
        base = _free_base()
        log_dir = tmp_path / f"logs{attempt}"
        proc = subprocess.Popen(
            [sys.executable, "-m", "rag_inference_pipeline_tpu_torch.tools.start_pipeline",
             "--timeout", str(WAIT_S), "--log-dir", str(log_dir)],
            cwd=ROOT, env={**os.environ, **env, "BASE_PORT": str(base)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True,  # its nodes share its process group
        )
        try:
            lines = []
            deadline = time.monotonic() + WAIT_S + 30
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line)
                if line.startswith("pipeline up"):
                    break
            if not lines or not lines[-1].startswith("pipeline up"):
                proc.wait(timeout=WAIT_S)
                if any("Address already in use" in p.read_text()
                       for p in log_dir.glob("node*.log")):
                    continue  # a port was taken meanwhile: another base
                pytest.fail(f"the pipeline did not come up: {proc.stderr.read()}")
            assert lines[:3] == [f"node {n} healthy at http://127.0.0.1:{base + n}\n"
                                 for n in range(3)]
            req = urllib.request.Request(
                f"http://127.0.0.1:{base}/query",
                data=json.dumps({"query": "a finance summary", "request_id": "p0"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                answer = json.loads(r.read())
            assert answer["request_id"] == "p0"
            assert set(answer) == {"request_id", "generated_response", "sentiment", "is_toxic"}
            with urllib.request.urlopen(f"http://127.0.0.1:{base + 1}/health",
                                        timeout=WAIT_S) as r:
                health = json.loads(r.read())
            assert (health["node"], health["role"], health["profile"]) == (
                1, "retrieval", "retrieval_default")
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=WAIT_S) == 0, proc.stderr.read()
            return
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its nodes
                proc.wait(timeout=WAIT_S)
            proc.stdout.close()
            proc.stderr.close()
    pytest.fail("could not bind three consecutive ports")


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run leaves the main thread's event loop policy with its loop
    set to None; a later file on the same xdist worker whose
    asyncio.get_event_loop() expects a loop then raises
    (tests/test_core.py::TestRegistry::test_lifecycle). Hand the next file
    a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
