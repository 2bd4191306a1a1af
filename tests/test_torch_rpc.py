"""The port's wire between nodes against the JAX package: zstd bodies and
packed documents both ways, the binary /retrieve reply byte for byte, the
node URLs at TOTAL_NODES 1, 2 and 3, all 22 role profiles and the built-in
ones; and the port's stdlib RPC client against a stdlib stub server
(retries on a 5xx, none on a 4xx, a refused connection, a timeout, zstd
replies, keep-alive reuse).
"""

import asyncio
import glob
import http.server
import json
import os
import socket
import sys
import threading

import numpy as np
import pytest

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.core.enums import NodeRole as JNodeRole
from rag_inference_pipeline_tpu.core.profiles import Profile as JProfile
from rag_inference_pipeline_tpu.core.profiles import _builtin_profile as j_builtin
from rag_inference_pipeline_tpu.core.profiles import load_profile_file
from rag_inference_pipeline_tpu.core.profiles import load_role_profile as j_role_profile
from rag_inference_pipeline_tpu.serve import compression as jcomp
from rag_inference_pipeline_tpu.serve.http import _pack_results_b64 as j_pack
from rag_inference_pipeline_tpu_torch.core import profiles as tprofiles
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.core.enums import NodeRole
from rag_inference_pipeline_tpu_torch.serve import compression as tcomp
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.serve.rpc import (
    ACCEPT_HEADER,
    ENCODING_HEADER,
    RPCClient,
    RPCError,
    RPCServiceError,
    RPCTimeoutError,
)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
YAMLS = sorted(glob.glob(os.path.join(CONFIGS, "*.yaml")))

# ---------------------------------------------------------------------------
# Compression: the same wire both ways
# ---------------------------------------------------------------------------

_BODIES = {
    "json": json.dumps({"items": [{"query": f"q {i}", "k": 10} for i in range(64)]}).encode(),
    "repeated": b"x" * 4096,
    "random": np.random.default_rng(0).bytes(4096),
    "small": b'{"items": []}',
}


@pytest.mark.parametrize("name", sorted(_BODIES))
def test_compress_is_the_jax_wire(name):
    """Port output through JAX `decompress` and back; the same decision to
    compress (min_bytes, keep only when it shrinks) at each level."""
    data = _BODIES[name]
    for level in (1, 3):
        tout, twas = tcomp.compress(data, level=level, min_bytes=512)
        jout, jwas = jcomp.compress(data, level=level, min_bytes=512)
        assert twas == jwas == (name in ("json", "repeated"))
        assert tout == jout  # the same library, level and frame: the same bytes
        assert jcomp.decompress(tout) == data and tcomp.decompress(jout) == data
        assert (tout[:4] == tcomp.ZSTD_MAGIC) == twas


def test_pack_docs_across_packages():
    docs = [{"id": i, "title": f"title {i}", "content": "word " * (i + 3),
             "score": 0.5 - i / 10} for i in range(5)]
    tpacked, jpacked = tcomp.pack_docs(docs), jcomp.pack_docs(docs)
    assert tpacked == jpacked
    assert jcomp.unpack_docs(tpacked) == docs and tcomp.unpack_docs(jpacked) == docs
    assert tcomp.unpack_docs(tcomp.pack_docs([])) == []


@pytest.mark.parametrize("why", ["algorithm", "payload", "none"])
def test_require_codec_refuses_without_zstandard(monkeypatch, why):
    """A node that asks for zstd refuses to start, by name, when the
    package does not import; a node that asks for none starts."""
    monkeypatch.setitem(sys.modules, "zstandard", None)  # import -> ImportError
    env = {"COMPRESSION_ALGORITHM": "none" if why != "algorithm" else "zstd",
           "DOCUMENTS_PAYLOAD_MODE": "compressed" if why == "payload" else "full"}
    settings = load_settings(env)
    if why == "none":
        tcomp.require_codec(settings)
        return
    with pytest.raises(RuntimeError, match="COMPRESSION_ALGORITHM=none"):
        tcomp.require_codec(settings)
    with pytest.raises(RuntimeError, match="zstandard"):
        runtime.make_server(settings, port=0)  # refused before anything loads


# ---------------------------------------------------------------------------
# The binary /retrieve reply and the /retrieve and /generate parses
# ---------------------------------------------------------------------------

_RESULTS = {
    "empty": [],
    "ragged": [{"ids": [3], "scores": [0.5]}, {"ids": [1, 2], "scores": [0.9, 0.8]},
               {"ids": [], "scores": []}],
    "full": [{"ids": list(range(i, i + 10)), "scores": [1.0 / (j + 1) for j in range(10)]}
             for i in range(64)],
}


@pytest.mark.parametrize("name", sorted(_RESULTS))
def test_pack_results_b64_is_byte_identical_to_jax(name):
    assert runtime._pack_results_b64(_RESULTS[name]) == j_pack(_RESULTS[name])


def test_pack_results_b64_refuses_documents_as_jax():
    for res in ([{"ids": [1], "scores": [0.1], "documents": []}],
                [{"ids": [1], "scores": [0.1], "compressed_docs": "AAAA"}]):
        with pytest.raises(ValueError, match="id_only"):
            j_pack(res)
        with pytest.raises(ValueError, match="id_only"):
            runtime._pack_results_b64(res)


def test_parse_retrieve_binary_wire():
    """embeddings_b64 with items (filling those without an embedding) and
    without (one item a row, the shared k), and each refusal of the
    reference's handler."""
    import base64

    dim = 4
    rows = np.arange(12, dtype=np.float32).reshape(3, dim)
    b64 = base64.b64encode(rows.tobytes()).decode()
    items, fmt = runtime._parse_retrieve({"embeddings_b64": b64, "k": 7}, dim)
    assert fmt == "json" and [it["k"] for it in items] == [7, 7, 7]
    np.testing.assert_array_equal(np.stack([it["embedding"] for it in items]), rows)
    items, fmt = runtime._parse_retrieve(
        {"items": [{"query": "a"}, {"embedding": [9.0] * dim, "k": 2}, {}],
         "embeddings_b64": b64, "response_format": "b64", "rerank": True}, dim)
    assert fmt == "b64" and items[0]["query"] == "a" and items[1]["k"] == 2
    np.testing.assert_array_equal(items[0]["embedding"], rows[0])
    assert items[1]["embedding"] == [9.0] * dim and all(it["rerank"] for it in items)
    for bad in ({}, {"embeddings_b64": b64[:-4] + "!!!!"}, {"embeddings_b64": "AAA"},
                {"embeddings_b64": ""}, {"items": [{}], "embeddings_b64": b64},
                {"embeddings_b64": base64.b64encode(rows.tobytes()[:-4]).decode()},
                {"items": [], "response_format": "xml"}, {"items": [], "rerank": 1},
                {"items": [{"embedding": [1.0]}]}, {"items": [{"k": 1.5}]}):
        with pytest.raises(ValueError):
            runtime._parse_retrieve(bad, dim)


def test_parse_generate_dumps_as_the_reference():
    """GenerateItem.model_dump(exclude_none=True): documents gain the
    default title and content, scores become floats, absent fields go."""
    from rag_inference_pipeline_tpu.serve.schemas import GenerateRequest

    req = {"items": [
        {"query": "a", "documents": [{"id": 1, "content": "x", "score": 1},
                                     {"id": 2, "title": "t", "rerank_score": 0.5}]},
        {"query": "b", "doc_ids": [4, 5]},
        {"query": "c", "compressed_docs": tcomp.pack_docs([{"id": 1}])},
        {"query": "d"},
    ]}
    ref = [it.model_dump(exclude_none=True)
           for it in GenerateRequest.model_validate(req).items]
    got = runtime._parse_generate(req)
    assert got == ref
    assert [list(g) for g in got] == [list(r) for r in ref]
    assert isinstance(got[0]["documents"][0]["score"], float)
    for bad in ({}, {"items": [{}]}, {"items": [{"query": "a", "doc_ids": ["1"]}]},
                {"items": [{"query": "a", "documents": [{"title": "no id"}]}]},
                {"items": [{"query": "a", "compressed_docs": "not base64!"}]}):
        with pytest.raises(ValueError):
            runtime._parse_generate(bad)


# ---------------------------------------------------------------------------
# Topology settings and the role profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [1, 2, 3])
def test_node_urls_match_jax(total):
    ips = {"node_0_ip": "10.0.0.10", "node_1_ip": "10.0.0.11", "node_2_ip": "10.0.0.12"}
    for node in range(3):
        kw = dict(total_nodes=total, node_number=node, base_port=9100, **ips)
        j, t = JSettings(**kw), Settings(**kw)
        assert t.node_role.value == j.node_role.value
        assert t.retrieval_url == j.retrieval_url
        assert t.generation_url == j.generation_url
        assert [t.node_url(n) for n in range(3)] == [j.node_url(n) for n in range(3)]
        assert t.listen_port == j.listen_port
    for bad in (dict(total_nodes=0), dict(total_nodes=4), dict(node_number=3)):
        with pytest.raises(ValueError):
            JSettings(**bad)
        with pytest.raises(ValueError):
            Settings(**bad)


def test_rpc_settings_have_the_jax_defaults():
    j, t = JSettings(), Settings()
    for name in ("rpc_retries", "rpc_backoff_base_s", "http_max_connections",
                 "compression_algorithm", "compression_level", "compression_min_bytes",
                 "generation_batch_size", "generation_batch_timeout_ms",
                 "node_0_ip", "node_1_ip", "node_2_ip", "request_timeout_s"):
        assert getattr(t, name) == getattr(j, name), name
    env = {"RPC_RETRIES": "5", "RPC_BACKOFF_BASE_S": "0.25", "NODE_2_IP": "10.1.2.3",
           "COMPRESSION_ALGORITHM": "none", "HTTP_MAX_CONNECTIONS": "7"}
    t = load_settings(env)
    assert (t.rpc_retries, t.rpc_backoff_base_s, t.node_2_ip, t.compression_algorithm,
            t.http_max_connections) == (5, 0.25, "10.1.2.3", "none", 7)
    with pytest.raises(ValueError, match="compression_algorithm"):
        Settings(compression_algorithm="lz4")


def _key(p):
    return (p.name, p.description, [(c.type.value, c.alias, c.config) for c in p.components],
            list(p.routes), p.batch_overrides)


@pytest.mark.parametrize("path", YAMLS, ids=[os.path.basename(p)[:-5] for p in YAMLS])
def test_profiles_match_the_yaml(path):
    """Each of the 22 profiles as the JAX loader reads its YAML; dropping a
    route's required component is refused by both."""
    jp = load_profile_file(path)
    tp = tprofiles.named_profile(jp.name)
    assert _key(tp) == _key(jp)
    assert tprofiles.load_role_profile(Settings(pipeline_role_profile=jp.name)) is tp
    required = {"gateway": "orchestrator", "retrieval": "index", "generation": "llm"}
    for route in jp.routes:
        kept = [c for c in jp.components if c.type.value != required[route]]
        with pytest.raises(ValueError, match="requires components"):
            JProfile(name=jp.name, components=kept, routes=jp.routes)
        with pytest.raises(ValueError, match="requires components"):
            tprofiles.Profile(name=tp.name, routes=tp.routes, components=tuple(
                c for c in tp.components if c.type.value != required[route]))


def test_the_port_carries_every_yaml_profile():
    assert tprofiles.profile_names() == sorted(os.path.basename(p)[:-5] for p in YAMLS)
    assert len(YAMLS) == 22


def test_profile_checks_match_jax():
    """Unknown and repeated routes, repeated aliases: refused by both."""
    spec = [{"type": "orchestrator"}]
    for kw in (dict(routes=["nope"]), dict(routes=["gateway", "gateway"]),
               dict(routes=["gateway"], components=spec * 2)):
        kw.setdefault("components", spec)
        with pytest.raises(ValueError):
            JProfile(name="x", **kw)
        with pytest.raises(ValueError):
            tprofiles.Profile(
                name="x", routes=tuple(kw["routes"]),
                components=tuple(tprofiles.ComponentSpec(tprofiles.ComponentType(c["type"]))
                                 for c in kw["components"]))


@pytest.mark.parametrize("total", [1, 2, 3])
def test_role_profile_selection_matches_jax(total):
    """No PIPELINE_ROLE_PROFILE: single_node_full on one node, else the
    built-in profile of each node's role."""
    for node in range(3):
        jp = j_role_profile(JSettings(total_nodes=total, node_number=node))
        tp = tprofiles.load_role_profile(Settings(total_nodes=total, node_number=node))
        assert _key(tp) == _key(jp)
    for role in NodeRole:
        assert _key(tprofiles.builtin_profile(role)) == _key(j_builtin(JNodeRole(role.value)))


# ---------------------------------------------------------------------------
# The RPC client against a stdlib stub server
# ---------------------------------------------------------------------------


class _Stub:
    """A keep-alive stdlib server on a free port whose replies a test
    scripts: `replies` is a list of (status, body bytes, headers, delay)
    taken in order, the last repeated."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.requests = []  # (path, headers, body, client port)
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 10

            def log_message(self, *a):
                pass

            def _reply(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                stub.requests.append((self.path, dict(self.headers), body,
                                      self.client_address[1]))
                status, data, headers, delay = (
                    stub.replies.pop(0) if len(stub.replies) > 1 else stub.replies[0])
                if delay:
                    threading.Event().wait(delay)
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_POST = do_GET = _reply

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _ok(obj, headers=None, status=200, delay=0.0):
    return (status, json.dumps(obj).encode(), headers or {}, delay)


def _client(**over):
    base = dict(rpc_retries=3, rpc_backoff_base_s=0.01, request_timeout_s=10.0,
                compression_min_bytes=64)
    return RPCClient(Settings(**{**base, **over}))


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_rpc_retries_a_5xx_then_succeeds():
    with _Stub([_ok({"error": "boom"}, status=503), _ok({"error": "boom"}, status=500),
                _ok({"ok": True})]) as stub:
        client = _client()

        async def go():
            try:
                return await client.post(f"{stub.url}/echo", {"x": 1})
            finally:
                await client.close()

        assert _run(go()) == {"ok": True}
    assert len(stub.requests) == 3
    assert len({r[3] for r in stub.requests}) == 1  # one keep-alive connection


def test_rpc_never_retries_a_4xx():
    with _Stub([_ok({"error": "bad"}, status=400)]) as stub:
        client = _client()
        with pytest.raises(RPCServiceError) as e:
            _run(client.post(f"{stub.url}/echo", {}))
        _run(client.close())
    assert e.value.status == 400 and "bad" in str(e.value)
    assert len(stub.requests) == 1


def test_rpc_refused_connection_exhausts_the_retries():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens there now
    client = _client(rpc_retries=2)
    with pytest.raises(RPCError) as e:
        _run(client.post(f"http://127.0.0.1:{port}/retrieve", {}))
    assert not isinstance(e.value, RPCServiceError) and "connect" in str(e.value)
    assert _run(client.clear_cache(f"http://127.0.0.1:{port}")) is False
    with pytest.raises(RPCError):
        _run(client.get(f"http://127.0.0.1:{port}/health"))


def test_rpc_timeout_is_its_own_error():
    with _Stub([_ok({"late": True}, delay=1.0)]) as stub:
        client = _client(rpc_retries=1, request_timeout_s=0.2)
        with pytest.raises(RPCTimeoutError):
            _run(client.post(f"{stub.url}/slow", {}))
        _run(client.close())


def test_rpc_compresses_and_reads_zstd():
    """A large body goes out compressed with its header and an Accept
    header; a zstd reply (sniffed by its magic) is decompressed; with
    COMPRESSION_ALGORITHM=none neither header is sent."""
    big = {"results": [{"ids": list(range(50)), "scores": [0.5] * 50}] * 8}
    reply = tcomp.compress(json.dumps(big).encode(), min_bytes=0)[0]
    with _Stub([(200, reply, {ENCODING_HEADER: "zstd"}, 0.0), _ok({"small": 1})]) as stub:
        client = _client()
        payload = {"items": [{"query": "word " * 40}]}
        assert _run(client.post(f"{stub.url}/retrieve", payload)) == big
        plain = _client(compression_algorithm="none")
        assert _run(plain.post(f"{stub.url}/retrieve", payload)) == {"small": 1}
        assert _run(client.get(f"{stub.url}/health")) == {"small": 1}
        assert _run(client.clear_cache(stub.url)) is True
        _run(client.close())
        _run(plain.close())
    (_, h1, b1, _), (_, h2, b2, _) = stub.requests[:2]
    assert h1[ENCODING_HEADER] == "zstd" and h1[ACCEPT_HEADER] == "zstd"
    assert json.loads(jcomp.decompress(b1)) == payload
    assert ENCODING_HEADER not in h2 and ACCEPT_HEADER not in h2
    assert json.loads(b2) == payload
    assert stub.requests[3][0] == "/clear_cache"


def test_rpc_bounds_the_connections_per_peer():
    """HTTP_MAX_CONNECTIONS=2: eight concurrent calls use at most two
    connections at a time, reused."""
    with _Stub([_ok({"ok": 1}, delay=0.05)]) as stub:
        client = _client(http_max_connections=2)

        async def go():
            try:
                return await asyncio.gather(*[
                    client.post(f"{stub.url}/echo", {"i": i}) for i in range(8)])
            finally:
                await client.close()

        assert _run(go()) == [{"ok": 1}] * 8
    assert len(stub.requests) == 8 and len({r[3] for r in stub.requests}) <= 2


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run leaves the main thread's event loop policy with its loop
    set to None; a later file on the same xdist worker whose
    asyncio.get_event_loop() expects a loop then raises
    (tests/test_core.py::TestRegistry::test_lifecycle). Hand the next file
    a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
