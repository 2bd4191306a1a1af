"""The native doc store (`native/docstore.cc` through the port's
`utils/docstore.py`) on the CPU: against the JAX package's sqlite and
memory backends on the same documents, non-ASCII and empty texts
included; `create_test_docs --backend native` (the default); and a staged
one-node server with the default DOC_STORE_BACKEND answering /retrieve
and /query.

No test here calls the JAX package's native wrapper: it builds with
`make -C native` in place, which races under xdist.
"""

import asyncio
import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.utils.docstore import DocumentStore as JDocumentStore
from rag_inference_pipeline_tpu.utils.docstore import build_sqlite_store as j_build_sqlite
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.tools import create_test_docs
from rag_inference_pipeline_tpu_torch.utils import docstore

CPU = torch.device("cpu")
DIM = 64

# titles and contents with non-ASCII text (2-, 3- and 4-byte UTF-8), an
# empty title, an empty content, quotes, newlines and a long text
_SPECIAL = [
    (0, "Café résumé", "naïve façade — “quoted” text"),
    (1, "", "a document with an empty title"),
    (2, "中文标题", "内容 with mixed scripts: Ελληνικά, русский, العربية"),
    (3, "emoji 🚀🔥", "🙂 " * 50),
    (4, "empty content", ""),
    (5, "tabs\tand\nnewlines", "line one\nline two\r\n\t\"quoted\" 'single'"),
    (6, "long", "x" * 5000 + "é"),
]


def _docs(n: int):
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "δέλτα", "ñandú", "kernel", "index", "词"]
    out = list(_SPECIAL)
    for i in range(len(_SPECIAL), n):
        out.append((i, f"title {i}", " ".join(rng.choice(words, rng.integers(1, 30)))))
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("docstores")
    docs = _docs(500)
    j_build_sqlite(str(tmp / "documents.db"), docs)
    docstore.build_native_store(str(tmp / "documents.ragdoc"), docs)
    return tmp, docs


def _port(backend, path, **kw):
    store = docstore.DocumentStore(Settings(doc_store_backend=backend,
                                            document_db_path=path, **kw))
    store.load()
    return store


@pytest.mark.parametrize("in_memory", [False, True])
@pytest.mark.parametrize("truncate", [None, 7, 100_000])
def test_native_matches_reference_sqlite_and_memory(stores, in_memory, truncate):
    tmp, docs = stores
    ids = [0, 1, 2, 3, 4, 5, 6, 499, 250, 3, 10_000, -1, 7]  # repeats, misses
    native = _port("native", str(tmp / "documents.ragdoc"), doc_store_in_memory=in_memory)
    jsql = JDocumentStore(JSettings(doc_store_backend="sqlite",
                                    document_db_path=str(tmp / "documents.db"),
                                    doc_store_in_memory=in_memory))
    jsql.load()
    jmem = JDocumentStore(JSettings(doc_store_backend="memory"), docs={
        i: {"id": i, "title": t, "content": c} for i, t, c in docs})
    jmem.load()
    got = native.fetch_documents_batch(ids, truncate_length=truncate)
    assert got == jsql.fetch_documents_batch(ids, truncate_length=truncate)
    assert got == jmem.fetch_documents_batch(ids, truncate_length=truncate)
    # the second fetch comes from the cache and is the same
    assert native.fetch_documents_batch(ids, truncate_length=truncate) == got
    native.unload()


def test_native_backend_reads_by_length(stores):
    """Raw bytes with lengths: every document round-trips exactly, the
    miss is None, and the count is the file's."""
    tmp, docs = stores
    backend = docstore._NativeBackend(str(tmp / "documents.ragdoc"), False)
    try:
        assert backend.count() == len(docs)
        got = backend.get_batch([d[0] for d in docs] + [777_777])
        assert got[-1] is None
        assert [(g["id"], g["title"], g["content"]) for g in got[:-1]] == docs
        assert backend.get_batch([]) == []
    finally:
        backend.close()


def test_native_refusals(tmp_path):
    with pytest.raises(RuntimeError, match="duplicate id"):
        docstore.build_native_store(str(tmp_path / "dup.ragdoc"), [(1, "a", "b"), (1, "c", "d")])
    with pytest.raises(FileNotFoundError, match="native doc store"):
        _port("native", str(tmp_path / "missing.ragdoc"))
    (tmp_path / "junk.ragdoc").write_bytes(b"not a store" * 10)
    with pytest.raises(FileNotFoundError):
        _port("native", str(tmp_path / "junk.ragdoc"))
    with pytest.raises(ValueError, match="document_db_path"):
        _port("native", None)
    docstore.build_native_store(str(tmp_path / "empty.ragdoc"), [])
    empty = _port("native", str(tmp_path / "empty.ragdoc"))
    assert empty.fetch_documents_batch([3]) == [{"id": 3, "title": "doc_3", "content": ""}]


def test_create_test_docs_native_by_default(tmp_path, monkeypatch):
    """The tool writes documents.ragdoc by default, and documents.db with
    --backend sqlite; both hold the reference's synthetic documents."""
    monkeypatch.setenv("DEVICE_PLATFORM", "cpu")
    base = ["--num-docs", "120", "--dim", "16", "--kind", "flat"]
    assert create_test_docs.main(["--out-dir", str(tmp_path / "n"), *base]) == 0
    assert create_test_docs.main(["--out-dir", str(tmp_path / "s"), *base,
                                  "--backend", "sqlite"]) == 0
    assert not (tmp_path / "n" / "documents.db").exists()
    native = _port("native", str(tmp_path / "n" / "documents.ragdoc"))
    sql = _port("sqlite", str(tmp_path / "s" / "documents.db"))
    rng = np.random.default_rng(0)
    want = [create_test_docs.synth_doc(i, rng) for i in range(120)]
    ids = list(range(120))
    got = native.fetch_documents_batch(ids, truncate_length=10_000)
    assert [(d["id"], d["title"], d["content"]) for d in got] == want
    assert got == sql.fetch_documents_batch(ids, truncate_length=10_000)


# ---------------------------------------------------------------------------
# A staged server with the default doc store
# ---------------------------------------------------------------------------


def _req(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_staged_server_with_default_doc_store(stores, tmp_path, monkeypatch):
    """single_node_full with DOC_STORE_BACKEND unset: the native store loads
    and /retrieve and /query answer; /retrieve's documents are those of the
    sqlite store for the same ids."""
    tmp, docs = stores
    monkeypatch.delenv("DOC_STORE_BACKEND", raising=False)
    base = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(
        lambda: dataclasses.replace(base(), vocab_size=1024)))
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((len(docs), DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ivf = IVFFlatIndex(DIM, 8, nprobe=3, device=CPU)
    ivf.train_add(vecs, iters=3)
    ivf.save(str(tmp_path / "ivf.npz"))
    env = dict(
        EMBEDDING_MODEL="tiny-embed", RERANKER_MODEL="tiny-rerank", LLM_MODEL="tiny-llm",
        SENTIMENT_MODEL="tiny-sentiment", TOXICITY_MODEL="tiny-toxicity",
        BATCH_SHAPE_BUCKETS="1,2,4,8", PREFILL_BUCKETS="32,64", MAX_TOKENS="3",
        TRUNCATE_LENGTH="96", RETRIEVAL_K="5", LLM_CONTEXT_DOCS="2", PARAM_DTYPE="float32",
        INDEX_DIM=str(DIM), INDEX_PQ_M="16", MODEL_WEIGHTS_DIR="", DEVICE_PLATFORM="cpu",
        INDEX_KIND="ivf_flat", INDEX_NPROBE="8", INDEX_PATH=str(tmp_path / "ivf.npz"),
        DOCUMENT_DB_PATH=str(tmp / "documents.ragdoc"), WARMUP_BUCKETS="0",
        COMPRESSION_ALGORITHM="none",
    )
    settings = load_settings(env)
    assert settings.doc_store_backend == "native"
    server = runtime.make_server(settings, port=0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        port = server.server_address[1]
        st, health = _req(port, "/health")
        assert st == 200 and health["status"] == "ok" and health["components"]["doc_store"]
        st, ret = _req(port, "/retrieve", {"items": [{"embedding": vecs[i].tolist()}
                                                     for i in (2, 3, 6)]})
        assert st == 200 and [r["ids"][0] for r in ret["results"]] == [2, 3, 6]
        sql = _port("sqlite", str(tmp / "documents.db"))
        for r in ret["results"]:
            want = sql.fetch_documents_batch(r["ids"], truncate_length=96)
            assert [{k: d[k] for k in ("id", "title", "content")} for d in r["documents"]] == want
        st, out = _req(port, "/query", {"query": "alpha and kernel", "request_id": "n1"})
        assert st == 200 and out["request_id"] == "n1"
        assert set(out) == {"request_id", "generated_response", "sentiment", "is_toxic"}
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    assert not th.is_alive()


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run in the server's loop thread leaves the policy's loop set
    to None; hand the next file on this xdist worker a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
