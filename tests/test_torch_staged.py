"""Port parity for the staged path: the retrieval executor over flat bf16,
IVF-Flat and IVF-PQ4, the generation service and the orchestrator's /query,
against the JAX package on converted tiny weights (float32 on the CPU);
the built-in role profiles against the JAX loader; and the stdlib server
answering concurrent /query and /retrieve.

The hash tokenizer's word ids start at 1000, past the tiny decoder's
512-row vocabulary: both sides widen it to 1024 rows, as in
tests/test_torch_pipeline.py.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.core.profiles import load_role_profile as j_profile
from rag_inference_pipeline_tpu.engine.orchestrator import Orchestrator as JOrchestrator
from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
from rag_inference_pipeline_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
from rag_inference_pipeline_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
from rag_inference_pipeline_tpu.models import components as jcomp
from rag_inference_pipeline_tpu.models.qwen import init_qwen_params
from rag_inference_pipeline_tpu.serve.services import (
    GenerationService as JGenerationService,
)
from rag_inference_pipeline_tpu.serve.services import (
    RetrievalExecutor as JRetrievalExecutor,
)
from rag_inference_pipeline_tpu.utils.docstore import DocumentStore as JDocumentStore
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.core.enums import PayloadMode
from rag_inference_pipeline_tpu_torch.core.profiles import load_role_profile
from rag_inference_pipeline_tpu_torch.engine.batcher import BatchScheduler
from rag_inference_pipeline_tpu_torch.engine.orchestrator import Orchestrator
from rag_inference_pipeline_tpu_torch.index import make_index
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
from rag_inference_pipeline_tpu_torch.index.ivf_pq import IVFPQIndex
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.layers import QuantizedEmbed, QuantizedLinear
from rag_inference_pipeline_tpu_torch.models.weights import (
    bert_params_from_jax,
    qwen_params_from_jax,
)
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.serve.rpc import RPCClient
from rag_inference_pipeline_tpu_torch.serve.services import (
    GenerationService,
    RetrievalExecutor,
)
from rag_inference_pipeline_tpu_torch.utils.docstore import (
    DocumentStore,
    build_sqlite_store,
)

CPU = torch.device("cpu")
DIM = 64  # BertConfig.tiny().hidden

_TINY = dict(
    embedding_model="tiny-embed", reranker_model="tiny-rerank",
    llm_model="tiny-llm", sentiment_model="tiny-sentiment",
    toxicity_model="tiny-toxicity", batch_shape_buckets="1,2,4,8",
    prefill_buckets="32,64", max_tokens=4, truncate_length=96,
    retrieval_k=5, llm_context_docs=2, llm_doc_chars=60,
    param_dtype="float32", index_dim=DIM, gateway_batch_size=4,
    gateway_pipeline_chunks=2, model_weights_dir="",
    # both packages check that index_pq_m divides index_dim
    index_pq_m=16,
)

_WORDS = ["alpha", "beta", "gamma", "delta", "retrieval", "vector", "tpu",
          "gpu", "kernel", "index", "query", "answer", "doc", "cluster"]


def _docs(rng, n):
    return {
        i: {"id": i, "title": f"title {i}",
            "content": " ".join(rng.choice(_WORDS, rng.integers(4, 20)))}
        for i in range(n)
    }


def _component_pairs(js, ts):
    """Tiny JAX components and their ports on the same (converted)
    weights; the decoder widened to 1024 rows on both sides."""
    names = ("EmbedderComponent", "RerankerComponent", "LLMComponent",
             "SentimentComponent", "ToxicityComponent")
    pairs = {}
    for name in names:
        jc, tc = getattr(jcomp, name)(js), getattr(tcomp, name)(ts, CPU)
        jc.load()
        tc.load()
        if name == "LLMComponent":
            jc.cfg = dataclasses.replace(jc.cfg, vocab_size=1024)
            tc.cfg = dataclasses.replace(tc.cfg, vocab_size=1024)
            jc.params = init_qwen_params(jax.random.key(7), jc.cfg)
            # at the init scale the tiny decoder echoes the prompt's last
            # token (the hash tokenizer's [SEP], which decodes to ""):
            # larger layer weights make it answer in words
            for lp in jc.params["layers"]:
                for key in [k for k in lp if k.endswith("_w")]:
                    lp[key] = 20 * lp[key]
            tc.params = qwen_params_from_jax(jax.device_get(jc.params), tc.cfg)
        else:
            tc.params = bert_params_from_jax(jax.device_get(jc.params), tc.cfg)
        pairs[name[: -len("Component")].lower()] = (jc, tc)
    # random toxicity heads flag every text: lower their bias on both sides
    # so the decoded texts themselves are compared
    pairs["toxicity"][0].params["classifier"]["b"] = jax.numpy.full((6,), -5.0)
    pairs["toxicity"][1].params.classifier.b.fill_(-5.0)
    return pairs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Tiny components on both sides, a doc store, and flat bf16, IVF-Flat
    and IVF-PQ4 indexes over the same corpus (JAX-built, loaded by the port
    from the JAX artifacts)."""
    rng = np.random.default_rng(0)
    js = JSettings(**_TINY)
    ts = Settings(**_TINY, device_platform="cpu")
    pairs = _component_pairs(js, ts)
    docs = _docs(rng, 400)
    stores = (JDocumentStore(js, docs=docs), DocumentStore(ts, docs=docs))
    for s in stores:
        s.load()
    corpus = pairs["embedder"][1].encode([d["content"] for d in docs.values()])
    tmp = tmp_path_factory.mktemp("staged")
    jflat = JFlatIndex(DIM, dtype="bfloat16")
    jflat.add(corpus)
    jflat.save(str(tmp / "flat.npz"))
    jivf = JIVFFlatIndex(DIM, 8, nprobe=3)
    jivf.train_add(corpus, iters=4)
    jivf.save(str(tmp / "ivf.npz"))
    # PQ4 (K6's plain version here, Pallas interpret in JAX) with an exact
    # re-score of a 24-deep shortlist
    jpq = JIVFPQIndex(DIM, 8, 16, nprobe=3, rescore_k=24, ksub=16)
    jpq.train_add(corpus, kmeans_iters=4, pq_iters=4)
    jpq.save(str(tmp / "pq.npz"))
    return dict(
        js=js, ts=ts, pairs=pairs, docs=docs, stores=stores, tmp=tmp,
        corpus=corpus,
        indexes={
            "flat": (jflat, load_index(str(tmp / "flat.npz"), CPU)),
            "ivf_flat": (jivf, load_index(str(tmp / "ivf.npz"), CPU)),
            "ivf_pq": (jpq, load_index(str(tmp / "pq.npz"), CPU)),
        },
    )


def _executors(world, kind):
    p, (jstore, tstore) = world["pairs"], world["stores"]
    jidx, tidx = world["indexes"][kind]
    jex = JRetrievalExecutor(
        world["js"], index=jidx, embedder=p["embedder"][0], doc_store=jstore,
        reranker=p["reranker"][0],
    )
    tex = RetrievalExecutor(
        world["ts"], index=tidx, embedder=p["embedder"][1], doc_store=tstore,
        reranker=p["reranker"][1],
    )
    return jex, tex


def _generation(world):
    p, (jstore, tstore) = world["pairs"], world["stores"]
    kw = ("llm", "reranker", "sentiment", "toxicity")
    jgen = JGenerationService(world["js"], doc_store=jstore,
                              **{k: p[k][0] for k in kw})
    tgen = GenerationService(world["ts"], doc_store=tstore,
                             **{k: p[k][1] for k in kw})
    return jgen, tgen


def _assert_results_match(tout, jout):
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert t["ids"] == j["ids"]
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-5, atol=1e-5)
        assert ("documents" in t) == ("documents" in j)
        for td, jd in zip(t.get("documents", []), j.get("documents", [])):
            assert sorted(td) == sorted(jd)
            for key in td:
                if key in ("score", "rerank_score"):
                    assert td[key] == pytest.approx(jd[key], rel=1e-5, abs=1e-5)
                else:
                    assert td[key] == jd[key]


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq"])
def test_retrieval_executor_matches_jax(world, kind):
    """Encoded and provided embeddings, per-item k (the k ladder), the
    rerank flag, a batch over the largest bucket (chunked) and the search
    cache on a repeat: the same ids, scores and documents."""
    jex, tex = _executors(world, kind)
    rng = np.random.default_rng(1)
    items = [{"query": f"{w} query about {w}", "k": 3 + i % 4}
             for i, w in enumerate(_WORDS[:9])]
    items[2]["embedding"] = world["corpus"][17] + 0.01
    items[4]["rerank"] = True
    items.append({"query": "", "embedding": rng.standard_normal(DIM).astype(np.float32)})
    jout = jex.process_batch([dict(i) for i in items])
    tout = tex.process_batch([dict(i) for i in items])
    _assert_results_match(tout, jout)
    assert all(len(r["ids"]) == (it.get("k") or 5) for r, it in zip(tout, items))
    assert "rerank_score" in tout[4]["documents"][0]
    again = tex.process_batch([dict(i) for i in items])  # search-cache hits
    _assert_results_match(again, jout)


def test_retrieval_executor_id_only_and_readiness(world):
    ts = dataclasses.replace(world["ts"], documents_payload_mode=PayloadMode.ID_ONLY)
    _, tidx = world["indexes"]["flat"]
    tex = RetrievalExecutor(ts, index=tidx, embedder=world["pairs"]["embedder"][1])
    out = tex.process_batch([{"query": "alpha beta"}])
    assert set(out[0]) == {"ids", "scores"} and len(out[0]["ids"]) == 5
    empty = RetrievalExecutor(world["ts"], index=make_index(world["ts"], CPU))
    with pytest.raises(RuntimeError, match="not ready"):
        empty.process_batch([{"query": "x", "embedding": np.zeros(DIM)}])


def test_generation_service_matches_jax(world):
    """Handed-over documents and doc ids: rerank -> LLM -> sentiment ->
    toxicity give the same responses."""
    jgen, tgen = _generation(world)
    docs = world["docs"]
    items = [
        {"query": f"what is {w}?", "documents": [dict(docs[i]) for i in (3 * j, 3 * j + 1, 50 + j)]}
        for j, w in enumerate(_WORDS[:6])
    ]
    items.append({"query": "by id please", "doc_ids": [5, 6, 7, 999]})
    items.append({"query": "no documents"})
    tout = tgen.process_batch([dict(i) for i in items])
    jout = jgen.process_batch([dict(i) for i in items])
    assert tout == jout
    assert not any(o["is_toxic"] for o in tout)
    assert all(o["generated_response"].startswith("tok") for o in tout)


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq"])
def test_orchestrator_query_matches_jax(world, kind):
    """/query through the orchestrator (query cache, batching, the three
    stage workers) gives the JAX package's responses."""
    jex, tex = _executors(world, kind)
    jgen, tgen = _generation(world)
    queries = [f"tell me about {w} and {v}" for w, v in zip(_WORDS, _WORDS[3:])][:7]
    queries.append(queries[0].upper())  # the normalized cache key: a hit

    async def drive(orch):
        await orch.start()
        try:
            return await asyncio.gather(*[
                orch.process_query(q, f"r{i}") for i, q in enumerate(queries)
            ])
        finally:
            await orch.stop()

    jorch = JOrchestrator(world["js"], retrieval_executor=jex, generation_service=jgen)
    torch_orch = Orchestrator(world["ts"], retrieval_executor=tex, generation_service=tgen)
    jout = asyncio.run(drive(jorch))
    tout = asyncio.run(drive(torch_orch))
    assert tout == jout
    assert [o["request_id"] for o in tout] == [f"r{i}" for i in range(len(queries))]
    assert not torch_orch.scheduler.flush_on_ready  # staged: timer-clocked


def test_orchestrator_flush_on_ready_follows_is_loaded(world):
    """Completion clocking is on only with a fused executor that is loaded
    (the reference checks that one exists); a node without local stages
    sends them over its RPC client."""

    class Fused:
        def __init__(self, loaded):
            self.is_loaded = loaded

        def process_batch(self, items):
            return [{"generated_response": i["query"], "sentiment": "neutral",
                     "is_toxic": False} for i in items]

    on = Orchestrator(world["ts"], fused_executor=Fused(True))
    assert on.scheduler.flush_on_ready
    out = asyncio.run(on.process_query("hello", "r1"))
    assert out["generated_response"] == "hello"
    off = Orchestrator(world["ts"], fused_executor=Fused(False))
    assert not off.scheduler.flush_on_ready and isinstance(off.rpc, RPCClient)
    remote = Orchestrator(world["ts"], retrieval_executor=object())
    assert remote.generation_service is None and isinstance(remote.rpc, RPCClient)


def test_batch_scheduler_batches_and_stops_its_timer():
    """A full batch flushes at once, the rest on the timer; per-item
    exceptions fail only their own item; stop() cancels a pending timer."""
    seen = []

    def process(items):
        seen.append(list(items))
        return [ValueError("bad") if i == 3 else i * 10 for i in items]

    async def drive():
        sched = BatchScheduler(process, batch_size=4, timeout_s=0.01,
                               flush_on_ready=False)
        out = await sched.enqueue_many([0, 1, 2, 4, 5])
        with pytest.raises(ValueError):
            await sched.enqueue(3)
        late = BatchScheduler(process, batch_size=8, timeout_s=30.0,
                              adaptive=False, flush_on_ready=False)
        task = asyncio.ensure_future(late.enqueue(7))
        await asyncio.sleep(0)
        await late.stop()
        assert late._timer is None and await task == 70
        with pytest.raises(RuntimeError, match="stopped"):
            await late.enqueue(1)
        await sched.stop()
        return out, sched.flushes, late.flushes

    out, flushes, late = asyncio.run(drive())
    assert out == [0, 10, 20, 40, 50]
    assert seen[0] == [0, 1, 2, 4] and flushes["full"] == 1
    assert flushes["timeout"] == 2 and late["shutdown"] == 1


@pytest.mark.parametrize("name", ["single_node_full", "retrieval_default", "retrieval_ivf"])
def test_builtin_profiles_match_the_jax_loader(name):
    env = {"pipeline_role_profile": None if name == "single_node_full" else name}
    jp = j_profile(JSettings(total_nodes=1, **env))
    tp = load_role_profile(Settings(total_nodes=1, **env))
    assert tp.name == jp.name
    assert list(tp.routes) == list(jp.routes)
    assert [(c.type.value, c.alias, c.config) for c in tp.components] == [
        (c.type.value, c.alias, c.config) for c in jp.components
    ]


def test_refusals_name_what_is_not_ported(tmp_path):
    s = Settings(**_TINY, device_platform="cpu")
    with pytest.raises(NotImplementedError, match="native"):
        DocumentStore(s).load()
    host = load_settings({"INDEX_KIND": "ivf_pq", "INDEX_RESCORE_STORE": "host"})
    with pytest.raises(NotImplementedError, match="INDEX_RESCORE_STORE"):
        make_index(host, CPU)
    np.savez(tmp_path / "odd.npz", kind="hnsw", dim=8)
    with pytest.raises(ValueError, match="hnsw"):
        load_index(str(tmp_path / "odd.npz"), CPU)
    with pytest.raises(NotImplementedError, match="ROLE_PROFILE_OVERRIDE_PATH"):
        load_role_profile(Settings(role_profile_override_path=str(tmp_path / "p.yaml")))
    with pytest.raises(ValueError, match="carries"):
        load_role_profile(Settings(pipeline_role_profile="no_such_profile"))


# ---------------------------------------------------------------------------
# The stdlib server on the CPU
# ---------------------------------------------------------------------------


def _req(port, path, body=None, timeout=120):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def served(tmp_path, monkeypatch):
    """Start the port's server for an env; stop it after the test."""
    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(
        tqwen.QwenConfig, "tiny",
        staticmethod(lambda: dataclasses.replace(tiny(), vocab_size=1024)),
    )
    rng = np.random.default_rng(3)
    db = str(tmp_path / "documents.db")
    build_sqlite_store(db, [(i, d["title"], d["content"]) for i, d in _docs(rng, 300).items()])
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ivf = IVFFlatIndex(DIM, 8, nprobe=3, device=CPU)
    ivf.train_add(vecs, iters=3)
    ivf.save(str(tmp_path / "ivf.npz"))
    env = {k.upper(): str(v) for k, v in _TINY.items()}
    env.update(DEVICE_PLATFORM="cpu", DOC_STORE_BACKEND="sqlite",
               DOCUMENT_DB_PATH=db, INDEX_KIND="ivf_flat",
               INDEX_PATH=str(tmp_path / "ivf.npz"), INDEX_NPROBE="4",
               MODEL_WEIGHTS_DIR="")
    servers = []

    def start(**over):
        server = runtime.make_server(load_settings({**env, **over}), port=0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        servers.append((server, th))
        return server.server_address[1], server

    yield start, vecs
    for server, th in servers:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
        assert not th.is_alive()


def test_server_serves_staged_query_and_retrieve(served):
    start, vecs = served
    port, server = start()
    assert server.app.profile.name == "single_node_full"
    assert server.app.components["index"].nprobe == 4  # the deployment's nprobe
    results = [None] * 6

    def ask(i):
        results[i] = _req(port, "/query", {"query": f"question {i} about gpu", "request_id": f"q{i}"})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    body = {"items": [{"query": "kernel index", "k": 3},
                      {"embedding": vecs[7].tolist()},
                      {"embedding": vecs[9].tolist(), "k": 2}]}
    status, ret = _req(port, "/retrieve", body)
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    for i, (st, b) in enumerate(results):
        assert st == 200 and b["request_id"] == f"q{i}"
        assert set(b) == {"request_id", "generated_response", "sentiment", "is_toxic"}
    assert status == 200 and len(ret["results"]) == 3
    assert [len(r["ids"]) for r in ret["results"]] == [3, 5, 2]
    assert ret["results"][1]["ids"][0] == 7 and ret["results"][2]["ids"][0] == 9
    doc = ret["results"][1]["documents"][0]
    assert set(doc) == {"id", "title", "content", "score"} and doc["title"] == "title 7"
    st, health = _req(port, "/health")
    assert st == 200 and health["status"] == "ok" and all(health["components"].values())
    assert set(health["kernel_launches"]) == {
        "binmax_int8gs", "binmax_bf16", "ivf_scan", "ivf_dedup", "ivfpq4_adc"}
    assert sum(health["kernel_launches"].values()) == 0  # the CPU: plain versions
    for bad in ({"items": [{"embedding": [1.0, 2.0]}]}, {"items": "x"},
                {"items": [{"query": "x"}], "response_format": "b64"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _req(port, "/retrieve", bad)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/query", {"query": "  "})
    assert e.value.code == 400


def test_server_serves_ivf_pq(served, tmp_path):
    """The PQ profiles and INDEX_KIND=ivf_pq on the staged server: /retrieve
    on retrieval_pq4 finds each corpus row first (PQ4 shortlist, exact
    re-score); /query on single_node_full answers over the same artifact."""
    start, vecs = served
    idx = IVFPQIndex(DIM, 8, 16, nprobe=4, rescore_k=64, ksub=16, device=CPU)
    idx.train_add(vecs, kmeans_iters=3, pq_iters=4)
    idx.save(str(tmp_path / "pq.npz"))
    port, server = start(PIPELINE_ROLE_PROFILE="retrieval_pq4",
                         INDEX_PATH=str(tmp_path / "pq.npz"), INDEX_NPROBE="8")
    assert server.app.profile.name == "retrieval_pq4"
    assert server.app.settings.index_pq_bits == 8  # the profile's config is per index
    index = server.app.components["index"]
    assert isinstance(index, IVFPQIndex) and index.ksub == 16 and index.nprobe == 8
    status, ret = _req(port, "/retrieve", {"items": [{"embedding": vecs[i].tolist()} for i in range(9)]})
    assert status == 200 and [r["ids"][0] for r in ret["results"]] == list(range(9))
    st, health = _req(port, "/health")
    assert st == 200 and health["kernel_launches"]["ivfpq4_adc"] == 0  # the CPU
    port2, server2 = start(INDEX_KIND="ivf_pq", INDEX_PATH=str(tmp_path / "pq.npz"))
    assert server2.app.profile.name == "single_node_full"
    st, body = _req(port2, "/query", {"query": "gpu kernel index", "request_id": "p0"})
    assert st == 200 and set(body) == {"request_id", "generated_response", "sentiment", "is_toxic"}


def test_server_retrieval_profile_over_flat_bf16(served, tmp_path):
    start, vecs = served
    flat = make_index(load_settings({"INDEX_DIM": str(DIM), "INDEX_PQ_M": "16"}), CPU)
    flat.add(vecs)
    flat.save(str(tmp_path / "flat.npz"))
    port, server = start(PIPELINE_ROLE_PROFILE="retrieval_default",
                         INDEX_KIND="flat", INDEX_PATH=str(tmp_path / "flat.npz"))
    assert server.app.profile.name == "retrieval_default"
    status, ret = _req(port, "/retrieve", {"items": [{"embedding": vecs[i].tolist()} for i in range(9)]})
    assert status == 200 and [r["ids"][0] for r in ret["results"]] == list(range(9))
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, "/query", {"query": "no gateway here"})
    assert e.value.code == 404


@pytest.mark.parametrize("engine,spec", [("1", "0"), ("0", "1"), ("1", "1")])
def test_server_serves_query_with_engine_and_speculation(served, engine, spec):
    """USE_CONTINUOUS_BATCHING and USE_SPECULATIVE_DECODING, alone and
    together, serve concurrent /query on the staged path with the plain
    server's answers; with the engine on, its segments did the decoding
    and it stops with the server."""
    start, _ = served
    queries = [f"question {i} about gpu kernels" for i in range(4)]

    def answers(port):
        out = [None] * len(queries)

        def ask(i):
            out[i] = _req(port, "/query", {"query": queries[i], "request_id": f"e{i}"})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert all(st == 200 for st, _ in out)
        return [b["generated_response"] for _, b in out]

    plain_port, _ = start()
    port, server = start(USE_CONTINUOUS_BATCHING=engine, USE_SPECULATIVE_DECODING=spec,
                         SPECULATIVE_GAMMA="4", KV_CACHE_MAX_LEN="256")
    llm = server.app.components["llm"]
    assert answers(port) == answers(plain_port)
    if engine == "1":
        eng = llm.engine
        assert eng is not None and eng.speculative == (spec == "1")
        assert eng.segments > 0 and eng.lanes_active == 0
        server.shutdown()
        server.server_close()
        assert llm.engine is None
    else:
        assert llm.engine is None


def test_server_serves_staged_query_with_int8_weights(served):
    """LLM_WEIGHT_QUANT=int8 and ENCODER_WEIGHT_QUANT=int8 on the staged
    server: every model component holds a W8A8 tree, and concurrent /query
    answer through the orchestrator, with the decode engine the same
    answers as without it (over the same int8 weights)."""
    start, _ = served
    knobs = dict(LLM_WEIGHT_QUANT="int8", ENCODER_WEIGHT_QUANT="int8")
    port, server = start(**knobs)
    comps = server.app.components
    assert isinstance(comps["llm"].params.embed, QuantizedEmbed)
    assert isinstance(comps["llm"].params.layers[0].down_w, QuantizedLinear)
    for name in ("embedder", "reranker", "sentiment", "toxicity"):
        assert isinstance(comps[name].params.layers[0].q_w, QuantizedLinear), name
    assert isinstance(comps["sentiment"].params.classifier.w, QuantizedLinear)

    def answers(port):
        out = [None] * 3

        def ask(i):
            out[i] = _req(port, "/query", {"query": f"int8 question {i} about gpu",
                                           "request_id": f"w{i}"})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        for i, (st, body) in enumerate(out):
            assert st == 200 and body["request_id"] == f"w{i}"
            assert set(body) == {"request_id", "generated_response", "sentiment", "is_toxic"}
        return [b["generated_response"] for _, b in out]

    eng_port, eng_server = start(**knobs, USE_CONTINUOUS_BATCHING="1",
                                 KV_CACHE_MAX_LEN="256")
    assert answers(eng_port) == answers(port)
    assert eng_server.app.components["llm"].engine.segments > 0


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run leaves the main thread's event loop policy with its loop
    set to None; a later file on the same xdist worker whose
    asyncio.get_event_loop() expects a loop then raises
    (tests/test_core.py::TestRegistry::test_lifecycle). Hand the next file
    a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
