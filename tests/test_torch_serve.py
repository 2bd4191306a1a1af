"""The port's serving surface on the CPU: settings, device resolution, the
flat index artifact shared with the JAX package, and the stdlib HTTP
runtime answering concurrent /query requests."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
from rag_inference_pipeline_tpu_torch.core import device as tdevice
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.serve import runtime

CPU = torch.device("cpu")


def test_settings_defaults_and_env_names_match_jax():
    ref = JSettings()
    for f in dataclasses.fields(Settings):
        assert getattr(Settings(), f.name) == getattr(ref, f.name), f.name
    s = load_settings({
        "RETRIEVAL_K": "7", "USE_FUSED_PIPELINE": "yes", "BASE_PORT": "9000",
        "NODE_NUMBER": "2", "BATCH_SHAPE_BUCKETS": "1,4", "INDEX_PATH": "/x",
    })
    assert (s.retrieval_k, s.use_fused_pipeline, s.listen_port) == (7, True, 9002)
    assert s.shape_buckets == (1, 4) and s.index_path == "/x"


def test_device_resolution():
    assert tdevice.resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        tdevice.resolve_device("tpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: cuda resolves instead of raising")
    for platform in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tdevice.resolve_device(platform)


def test_flat_index_npz_round_trip(tmp_path):
    """An artifact written by the JAX FlatIndex loads into the port with
    the same codes, scale and rescore copy, and searches to the same ids;
    the port's own save loads back into the JAX FlatIndex."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((1000, 32)).astype(np.float32)
    jidx = JFlatIndex(32, dtype="int8")
    jidx.add(vecs)
    path = str(tmp_path / "j.npz")
    jidx.save(path)
    tidx = load_index(path, CPU)
    assert tidx.ntotal == 1000 and tidx._db_i8.shape[0] % tidx._chunk_i8 == 0
    np.testing.assert_array_equal(
        tidx._db_i8[:1000].numpy(), np.asarray(jidx._db_i8[:1000])
    )
    assert tidx._db_gscale.item() == float(jidx._db_gscale)
    np.testing.assert_array_equal(
        tidx._db[:1000].float().numpy(),
        np.asarray(jidx._db[:1000].astype(jnp.float32)),
    )
    q = rng.standard_normal((5, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tidx.search(q, 10)[1].numpy(), np.asarray(jidx.search(q, 10)[1])
    )
    # the port builds the same index from the same vectors, and its save
    # is a JAX artifact
    own = FlatIndex(32, device=CPU)
    own.add(vecs)
    np.testing.assert_array_equal(own._db_i8.numpy(), tidx._db_i8.numpy())
    path2 = str(tmp_path / "t.npz")
    own.save(path2)
    back = JFlatIndex._load(path2)
    np.testing.assert_array_equal(
        np.asarray(back._db_i8[:1000]), np.asarray(jidx._db_i8[:1000])
    )
    np.testing.assert_array_equal(
        np.asarray(back.search(q, 10)[1]), np.asarray(jidx.search(q, 10)[1])
    )


def test_flat_index_re_add_matches_jax():
    """A second add re-quantizes the whole store from the bf16 originals,
    as the reference does."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((300, 16)).astype(np.float32)
    b = 3 * rng.standard_normal((200, 16)).astype(np.float32)
    jidx, tidx = JFlatIndex(16, dtype="int8"), FlatIndex(16, device=CPU)
    for v in (a, b):
        jidx.add(v)
        tidx.add(v)
    assert tidx.ntotal == jidx.ntotal == 500
    np.testing.assert_array_equal(
        tidx._db_i8[:500].numpy(), np.asarray(jidx._db_i8[:500])
    )
    assert tidx._db_gscale.item() == float(jidx._db_gscale)


@pytest.mark.parametrize("dtype,metric", [("bfloat16", "ip"), ("bfloat16", "l2"),
                                          ("float32", "l2")])
def test_flat_vector_index_npz_both_ways(tmp_path, dtype, metric):
    """bf16 / f32 vector storage: a JAX artifact loads in the port and the
    port's save loads in the JAX index, with the same ids and scores (the
    CPU routes both through the exact scan; l2 uses the stored norms)."""
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    jidx = JFlatIndex(24, dtype=dtype, metric=metric)
    jidx.add(vecs[:400])
    jidx.add(vecs[400:])  # a second add appends
    jidx.save(str(tmp_path / "j.npz"))
    tidx = load_index(str(tmp_path / "j.npz"), CPU)
    assert (tidx.ntotal, tidx.dtype_name, tidx.metric) == (700, dtype, metric)
    own = FlatIndex(24, dtype=dtype, metric=metric, device=CPU)
    own.add(vecs[:400])
    own.add(vecs[400:])
    own.save(str(tmp_path / "t.npz"))
    back = JFlatIndex._load(str(tmp_path / "t.npz"))
    for t, j in ((tidx, jidx), (own, back)):
        ts, ti = t.search(q, 10)
        js, ji = (np.asarray(a) for a in j.search(q, 10))
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="storage dtype"):
        FlatIndex(24, dtype="float16")


@pytest.fixture(params=[64, 0], ids=["rescore", "no_rescore"])
def corpus(tmp_path, request):
    """A saved tiny corpus; without a rescore copy the executor takes the
    host path (re-quantized dequantized codes)."""
    rng = np.random.default_rng(1)
    idx = FlatIndex(64, device=CPU, rescore_k=request.param)
    idx.add(rng.standard_normal((300, 64)).astype(np.float32))
    idx.save(str(tmp_path / "index.npz"))
    toks = rng.integers(1, 1000, (300, 8)).astype(np.int32)
    np.save(tmp_path / "doc_tokens.npy", toks)
    np.save(tmp_path / "doc_tokens_mask.npy", np.ones_like(toks))
    return {
        "DEVICE_PLATFORM": "cpu", "USE_FUSED_PIPELINE": "1",
        "INDEX_DTYPE": "int8", "INDEX_PATH": str(tmp_path / "index.npz"),
        "DOC_TOKENS_PATH": str(tmp_path / "doc_tokens.npy"),
        "EMBEDDING_MODEL": "tiny-embed", "LLM_MODEL": "tiny-llm",
        "SENTIMENT_MODEL": "tiny-sentiment", "TOXICITY_MODEL": "tiny-toxicity",
        "BATCH_SHAPE_BUCKETS": "1,2,4,8", "MAX_TOKENS": "3",
        "TRUNCATE_LENGTH": "32", "RETRIEVAL_K": "5", "PARAM_DTYPE": "float32",
        "MODEL_WEIGHTS_DIR": "",
    }


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_runtime_serves_concurrent_queries(corpus, monkeypatch):
    # the hash tokenizer's word ids start at 1000: give the tiny decoder a
    # vocabulary that holds them (the JAX package gathers NaN rows there)
    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(
        tqwen.QwenConfig, "tiny",
        staticmethod(lambda: dataclasses.replace(tiny(), vocab_size=1024)),
    )
    server = runtime.make_server(load_settings(corpus), port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        results = [None] * 6

        def ask(i):
            results[i] = _post(port, {"query": f"question {i} about docs",
                                      "request_id": f"r{i}"})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, (status, body) in enumerate(results):
            assert status == 200
            assert set(body) == {
                "request_id", "generated_response", "sentiment", "is_toxic"
            }
            assert body["request_id"] == f"r{i}"
            assert isinstance(body["is_toxic"], bool)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=30
        ) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert all(health["components"].values())
        assert health["kernel_launches"]["binmax_int8gs"] == 0  # CPU: plain
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"query": "   "})
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


@pytest.mark.parametrize("drop", ["USE_FUSED_PIPELINE", "INDEX_DTYPE",
                                  "INDEX_PATH", "DOC_TOKENS_PATH"])
def test_runtime_refuses_incomplete_settings(corpus, drop):
    env = dict(corpus, **{drop: ""})
    with pytest.raises(ValueError):
        runtime.build_executor(load_settings(env))
