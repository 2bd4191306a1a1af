"""The native JSON codec of `/retrieve` (`native/fastjson.cc` through the
port's `utils/fastjson.py`) on the CPU.

The contract: `parse_retrieve` either reads a body exactly as the port's
stdlib path (`json.loads`, then `serve/runtime.py::_parse_retrieve`) reads
it, or returns None and leaves the body to that path; it never accepts a
body the stdlib path refuses. A hypothesis differential test holds it to
that over generated bodies (NaN literals, escapes, non-ASCII keys, dim
mismatches, `embeddings_b64`, float and boolean `k`, byte corruption).
`encode_results` reads back (`json.loads`) as the stdlib encoding of the
same results does, scores equal as f32. A staged server answers every
`/retrieve` body with the same status and body with FAST_JSON on and off.

No test here calls the JAX package's native wrapper (it builds with
`make -C native` in place, which races under xdist).
"""

import asyncio
import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rag_inference_pipeline_tpu_torch.core.config import load_settings
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.utils import docstore, fastjson

DIM = 8
CPU = torch.device("cpu")


def _stdlib(body: bytes):
    """The port's stdlib path: (items, response_format), or the error."""
    try:
        req = json.loads(body or b"{}")
        if not isinstance(req, dict):
            raise ValueError("the request body must be a JSON object")
        return runtime._parse_retrieve(req, DIM)
    except Exception as e:  # noqa: BLE001 — any refusal is compared
        return ("error", type(e).__name__)


def _assert_same_reading(fast, slow):
    assert slow[0] != "error", slow
    items, fmt = slow
    assert fast.response_format == fmt
    assert fast.embeddings.shape == (len(items), DIM)
    for i, it in enumerate(items):
        assert it["query"] == ""
        with np.errstate(over="ignore"):  # f64 past f32's range: inf on both sides
            want = np.asarray(it["embedding"], np.float32)
        np.testing.assert_array_equal(fast.embeddings[i], want)
        k = int(fast.item_k[i]) if fast.item_k[i] >= 0 else fast.k
        assert k == it["k"] and fast.rerank == it["rerank"]


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------

_floats = st.one_of(
    st.floats(allow_nan=False, allow_infinity=False, width=32),
    st.floats(allow_nan=True, allow_infinity=True),
    st.integers(-10**6, 10**6),
)
_k = st.one_of(st.none(), st.integers(-3, 40), st.integers(2**31 - 2, 2**40),
               st.just(3.0), st.just(2.5), st.booleans(), st.just("5"))
_keys = st.sampled_from(["query", "embedding", "k", "items", "rerank", "response_format",
                         "note", "é", "ключ", "x" * 40, "k2"])
_junk = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(), st.floats(allow_nan=False),
              st.text(max_size=6)),
    lambda inner: st.one_of(st.lists(inner, max_size=3),
                            st.dictionaries(st.text(max_size=4), inner, max_size=3)),
    max_leaves=6,
)


@st.composite
def _item(draw):
    it = {}
    if draw(st.integers(0, 9)):
        n = draw(st.sampled_from([DIM, DIM, DIM, DIM - 1, DIM + 1, 0]))
        it["embedding"] = draw(st.lists(_floats, min_size=n, max_size=n))
    if draw(st.booleans()):
        it["query"] = draw(st.sampled_from(["", "", "text", None, 5]))
    if draw(st.booleans()):
        it["k"] = draw(_k)
    for key in draw(st.lists(_keys, max_size=2)):
        it.setdefault(key, draw(_junk))
    return it


@st.composite
def _body(draw) -> bytes:
    req = {}
    if draw(st.integers(0, 9)):
        req["items"] = draw(st.lists(_item(), min_size=0, max_size=4))
    if draw(st.booleans()):
        req["rerank"] = draw(st.one_of(st.booleans(), st.none(), st.just(1)))
    if draw(st.booleans()):
        req["k"] = draw(_k)
    if draw(st.integers(0, 3)) == 0:
        req["response_format"] = draw(st.sampled_from(["json", "b64", "xml", None]))
    if draw(st.integers(0, 5)) == 0:
        req["embeddings_b64"] = base64.b64encode(
            np.zeros(DIM * len(req.get("items") or [1]), "<f4").tobytes()).decode()
    for key in draw(st.lists(_keys, max_size=2)):
        req.setdefault(key, draw(_junk))
    text = json.dumps(
        req, indent=draw(st.sampled_from([None, None, 2])),
        ensure_ascii=draw(st.booleans()),
        separators=draw(st.sampled_from([None, (",", ":")])),
    )
    mutation = draw(st.integers(0, 9))
    if mutation == 0:  # an escaped key that decodes to a known one
        text = text.replace('"k"', '"\\u006b"', 1)
    elif mutation == 1 and text:  # one byte replaced
        pos = draw(st.integers(0, len(text) - 1))
        text = text[:pos] + chr(draw(st.integers(32, 126))) + text[pos + 1:]
    elif mutation == 2:  # a key given twice: the stdlib keeps the last
        text = text[:-1] + (', "k": 2, "k": 9}' if len(text) > 2 else '"k": 9}')
    raw = text.encode()
    if mutation == 3:  # invalid UTF-8 inside a string
        raw = raw.replace(b'"note"', b'"no\xfft"', 1)
    return raw


@settings(max_examples=500, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_body())
def test_parse_retrieve_differential(body):
    fast = fastjson.parse_retrieve(body, DIM)
    slow = _stdlib(body)
    if fast is not None:
        _assert_same_reading(fast, slow)


def test_parse_retrieve_takes_the_strict_shape():
    """Bodies in the strict shape take the fast path, whitespace, per-item
    and default k, rerank and both formats included; the number forms read
    as the stdlib reads them."""
    rng = np.random.default_rng(0)
    for fmt in ("json", "b64"):
        req = {"items": [{"query": "", "embedding": rng.standard_normal(DIM).tolist()},
                         {"embedding": rng.standard_normal(DIM).tolist(), "k": 3},
                         {"embedding": [1, -2.5, 3e2, 0.125, -0, 4e-3, 60e1, 0], "k": None}],
               "rerank": True, "k": 7, "response_format": fmt}
        for indent in (None, 4):
            body = json.dumps(req, indent=indent).encode()
            fast = fastjson.parse_retrieve(body, DIM)
            assert fast is not None
            _assert_same_reading(fast, _stdlib(body))
    body = b'{"items":[{"embedding":[1, -2.5, 3e2, 0.125, -0, 4E-3, 60e+1, 0]}]}'
    np.testing.assert_array_equal(
        fastjson.parse_retrieve(body, DIM).embeddings[0],
        np.asarray(json.loads(body)["items"][0]["embedding"], np.float32))


@pytest.mark.parametrize("body", [
    b"", b"{", b"[]", b"null",
    b'{"items": []}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}], "k": 3.0}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8], "k": 2e0}]}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}], "\\u006b": 3}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}], "n\xc3\xa9": 1}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}], "n": "\xff"}',
    b'{"items": [{"embedding": [NaN, 2, 3, 4, 5, 6, 7, 8]}]}',
    b'{"items": [{"embedding": [1, 2, 3]}]}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}], "embeddings_b64": ""}',
    b'{"items": [{"query": "x", "embedding": [1, 2, 3, 4, 5, 6, 7, 8]}]}',
    b'{"items": [{"embedding": [1, 2, 3, 4, 5, 6, 7, 8]}]} trailing',
])
def test_parse_retrieve_declines(body):
    assert fastjson.parse_retrieve(body, DIM) is None


def _results(rng, n):
    return [{"ids": [int(x) for x in rng.integers(0, 2**62, m)],
             "scores": [float(np.float32(x)) for x in rng.standard_normal(m) * 10.0 ** rng.integers(-40, 38)]}
            for m in rng.integers(0, 12, n)]


@pytest.mark.parametrize("n", [0, 1, 64, 512])
def test_encode_results_reads_back_as_the_stdlib_encoding(n):
    rng = np.random.default_rng(n)
    results = _results(rng, n)
    if n:
        results[0] = {"ids": [1, 2, 3], "scores": [-0.0, float(np.float32(1e-45)), 3.4e38]}
    enc = fastjson.encode_results(results)
    got = json.loads(enc)
    want = json.loads(json.dumps({"results": results}))
    assert list(got) == ["results"] and len(got["results"]) == n
    for g, w in zip(got["results"], want["results"]):
        assert g["ids"] == w["ids"]
        np.testing.assert_array_equal(np.asarray(g["scores"], np.float32),
                                      np.asarray(w["scores"], np.float32))
    assert fastjson.encode_results([{"ids": [1], "scores": [1.0], "documents": []}]) is None
    assert fastjson.encode_results([{"ids": [1], "scores": [1.0], "documents": None}]) is not None
    assert fastjson.encode_results([{"ids": [1, 2], "scores": [1.0]}]) is None


# ---------------------------------------------------------------------------
# The server, FAST_JSON on and off
# ---------------------------------------------------------------------------

_BAD = [
    {"items": [{"embedding": [1.0, 2.0]}]},
    {"items": "x"},
    {"items": [{"embedding": [0.5] * DIM}], "k": 3.5},
    {"items": [{"embedding": [0.5] * DIM}], "k": True},
    {"items": [{"embedding": [0.5] * DIM}], "rerank": "yes"},
    {"items": [{"embedding": [0.5] * DIM}], "response_format": "xml"},
    {"items": [{"embedding": [0.5] * DIM, "query": 3}]},
    {},
]


def _post(port, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/retrieve", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _same_reply(a, b):
    assert a[0] == b[0], (a, b)
    if a[0] != 200:
        assert a[1] == b[1]
        return
    ja, jb = json.loads(a[1]), json.loads(b[1])
    if "results" not in ja:  # the b64 reply: byte for byte
        assert ja == jb
        return
    for ra, rb in zip(ja["results"], jb["results"], strict=True):
        assert ra["ids"] == rb["ids"] and ra.keys() == rb.keys()
        np.testing.assert_array_equal(np.asarray(ra["scores"], np.float32),
                                      np.asarray(rb["scores"], np.float32))
        assert ra.get("documents") == rb.get("documents")


@pytest.mark.parametrize("mode", ["id_only", "full"])
def test_server_replies_the_same_with_fast_json_on_and_off(tmp_path, monkeypatch, mode):
    """retrieval_rerank_no_embedding (index, doc store, reranker) over an
    int8 flat index with the host rescore store and the default native doc
    store: every body, good and bad, gets
    the same status and reply with FAST_JSON=1 and 0; the good strict
    bodies take the fast path (its parse counted), the id_only JSON reply
    its encoder."""
    monkeypatch.delenv("DOC_STORE_BACKEND", raising=False)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    docstore.build_native_store(str(tmp_path / "docs.ragdoc"),
                                [(i, f"t{i}", f"c{i} ü") for i in range(200)])
    index = FlatIndex(DIM, device=CPU, rescore_store="host")
    index.add(x)
    env = dict(DEVICE_PLATFORM="cpu", PIPELINE_ROLE_PROFILE="retrieval_rerank_no_embedding",
               RERANKER_MODEL="tiny-rerank", MODEL_WEIGHTS_DIR="",
               INDEX_KIND="flat", INDEX_DTYPE="int8", INDEX_RESCORE_STORE="host",
               INDEX_DIM=str(DIM), INDEX_PQ_M="4", RETRIEVAL_K="5", WARMUP_BUCKETS="0",
               DOCUMENT_DB_PATH=str(tmp_path / "docs.ragdoc"), COMPRESSION_ALGORITHM="none",
               DOCUMENTS_PAYLOAD_MODE=mode, BATCH_SHAPE_BUCKETS="1,2,4,8")
    good = [
        {"items": [{"embedding": x[i].tolist()} for i in (3, 4, 5)]},
        {"items": [{"query": "", "embedding": x[7].tolist(), "k": 2}], "k": 4, "rerank": False},
        {"items": [{"embedding": x[9].tolist()}], "response_format": "b64"},
        {"embeddings_b64": base64.b64encode(x[:2].astype("<f4").tobytes()).decode()},
    ]
    bodies = [json.dumps(b).encode() for b in good + _BAD] + [b"not json", b"[1]"]
    replies = {}
    parsed = []
    real = fastjson.parse_retrieve

    def counting(body, dim):
        out = real(body, dim)
        parsed.append(out is not None)
        return out

    monkeypatch.setattr(fastjson, "parse_retrieve", counting)
    for flag in ("1", "0"):
        server = runtime.make_server(load_settings({**env, "FAST_JSON": flag}), port=0,
                                     index=index)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            assert server.app.settings.fast_json == (flag == "1")
            replies[flag] = [_post(server.server_address[1], b) for b in bodies]
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=60)
    for a, b in zip(replies["1"], replies["0"], strict=True):
        _same_reply(a, b)
    # a b64 reply needs id_only: 400 in full mode, either way
    assert [r[0] for r in replies["1"][:len(good)]] == [
        200, 200, 200 if mode == "id_only" else 400, 200]
    assert all(r[0] == 400 for r in replies["1"][len(good):])
    # fast parses: the three strict bodies on FAST_JSON=1, none on 0
    assert parsed.count(True) == 3
    if mode == "id_only":
        fast_reply = replies["1"][0][1]
        assert b", " not in fast_reply  # the native encoder's compact form
        assert json.loads(fast_reply)["results"][0]["ids"][0] == 3
    else:
        doc = json.loads(replies["1"][0][1])["results"][0]["documents"][0]
        assert doc["title"] == "t3" and doc["content"] == "c3 ü"


def test_bench_fastjson_smoke(tmp_path):
    from rag_inference_pipeline_tpu_torch.tools import bench_fastjson

    out = bench_fastjson.main(["--smoke", "--out", str(tmp_path / "f.json")])
    assert sorted(out["rows"]) == ["b16", "b4"]
    assert all(r["parse_same"] and r["encode_same"] for r in out["rows"].values())


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run in the server's loop thread leaves the policy's loop set
    to None; hand the next file on this xdist worker a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
