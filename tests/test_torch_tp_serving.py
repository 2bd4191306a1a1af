"""Tensor parallelism in the port's serving paths on the CPU: n-gram
speculation and the decode engine at tp = 2 (and the engine's lane pool
over dp), the components split over the front tp group with the engine
that `LLMComponent.start` builds on the mesh, and the fused server at
MESH_TP = 2, each against the unsplit port (tests/test_torch_tp.py holds
the models to the JAX package). tp positions repeat the CPU
(`core/mesh.py::force_host_devices`)."""

import asyncio
import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.layers import MeshTree, TPTree
from rag_inference_pipeline_tpu_torch.parallel import sharding as tsharding


def _tmesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=force_host_devices(dp * tp))


def _ids(rng, b, t, vocab, lengths=None):
    ids = rng.integers(1, vocab, (b, t)).astype(np.int32)
    lengths = lengths if lengths is not None else [t] * b
    mask = (np.arange(t)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _varied(tcfg, seed):
    """A tiny decoder whose tokens vary (the layer weights scaled up, as
    tests/test_torch_decode_engine.py's `varied`)."""
    tp = tqwen.init_qwen_params(tcfg, generator=torch.Generator().manual_seed(seed))
    for lp in tp.layers:
        for name, p in lp.named_parameters():
            if name.endswith("_w"):
                p.data.mul_(20.0)
    return tp


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "w8a8"])
def test_speculative_tp2_matches_tp1(quantize):
    tcfg = dataclasses.replace(tqwen.QwenConfig.tiny(), vocab_size=1024)
    tp = _varied(tcfg, 4)
    if quantize:
        tp = tqwen.quantize_qwen_params(tp)
    (tree,) = tsharding.place_params(_tmesh(1, 2), tp, tcfg)
    rng = np.random.default_rng(9)
    ids, mask = _ids(rng, 4, 12, 1000, [12, 9, 5, 12])
    ids[:, 6:9] = ids[:, 2:5]  # repeated bigrams: drafts that verify
    ids *= mask
    kw = dict(gamma=4, cache_len=30)
    solo, solo_mean = tqwen.ngram_speculative_generate(tp, tcfg, _t(ids), _t(mask), 10, **kw)
    got, mean = tqwen.ngram_speculative_generate(tree, tcfg, _t(ids), _t(mask), 10, **kw)
    assert torch.equal(got, solo) and float(mean) == float(solo_mean)
    greedy = tqwen.greedy_generate(tree, tcfg, _t(ids), _t(mask), 10, cache_len=30)
    assert torch.equal(got, greedy)


def _serve(eng, jobs):
    async def main():
        await eng.start()
        try:
            return await asyncio.gather(*(eng.submit(p, m) for p, m in jobs))
        finally:
            await eng.stop()

    return asyncio.new_event_loop().run_until_complete(main())


@pytest.mark.parametrize("mode", ["plain", "spec"])
@pytest.mark.parametrize("layout", [(1, 2), (2, 2), (2, 1)], ids=["tp2", "dp2tp2", "dp2"])
def test_engine_on_a_mesh_matches_unsharded(mode, layout):
    """The engine's lane pool over the mesh (`kv_cache_sharding`: lanes over
    dp, kv heads over tp) gives the unsharded engine's tokens."""
    tcfg = dataclasses.replace(tqwen.QwenConfig.tiny(), vocab_size=1024)
    tp = _varied(tcfg, 6)
    rng = np.random.default_rng(10)
    jobs = [(rng.integers(1, 1000, n).astype(np.int32), m)
            for n, m in ((5, 9), (8, 6), (3, 12), (7, 4), (6, 8))]
    kw = dict(lanes=4, cache_len=48, segment_steps=3, eos_token_id=1023,
              admit_buckets=(1, 2, 4), prefill_buckets=(8, 16))
    if mode == "spec":
        kw.update(speculative=True, gamma=3, spec_rounds=2)
    mesh = _tmesh(*layout)
    eng = DecodeEngine(tp, tcfg, mesh=mesh, **kw)
    assert len(eng.cache.grid) == layout[0] and len(eng.cache.grid[0]) == layout[1]
    assert eng.cache.grid[0][0][0].shape[1] == 4 // layout[0]
    assert eng.cache.grid[0][0][0].shape[3] == tcfg.kv_heads // layout[1]
    assert _serve(eng, jobs) == _serve(DecodeEngine(tp, tcfg, **kw), jobs)


# ---------------------------------------------------------------------------
# Components and the server at MESH_TP = 2
# ---------------------------------------------------------------------------


_TINY = dict(llm_model="tiny-llm", embedding_model="tiny-embed", max_tokens=5,
             truncate_length=32, batch_shape_buckets="1,2,4", prefill_buckets="32",
             kv_cache_max_len=64, decode_max_concurrency=4, decode_segment_steps=4,
             device_platform="cpu", model_weights_dir="", param_dtype="float32")


def test_components_shard_by_tp_and_engine_takes_the_mesh(monkeypatch):
    """Each component holds its tree split over the front tp group, and
    answers as the unsplit one does; `LLMComponent.start` builds the
    engine on the component's mesh (its lanes over dp, kv heads over tp),
    which it did not before (the engine ran every lane on the front)."""
    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny",
                        staticmethod(lambda: dataclasses.replace(tiny(), vocab_size=1024)))
    cpu = torch.device("cpu")
    s = Settings(**_TINY, use_continuous_batching=True)
    mesh = _tmesh(2, 2)
    llm = tcomp.LLMComponent(s, cpu, mesh=mesh)
    emb = tcomp.EmbedderComponent(s, cpu, mesh=mesh)
    solo_llm, solo_emb = tcomp.LLMComponent(s, cpu), tcomp.EmbedderComponent(s, cpu)
    for c in (llm, emb, solo_llm, solo_emb):
        c.load()
    assert isinstance(llm.params, TPTree) and isinstance(emb.params, TPTree)
    assert llm.params.devices == mesh.group(0)
    texts = ["tensor parallel encoders", "a second query"]
    np.testing.assert_allclose(emb.encode(texts), solo_emb.encode(texts), atol=2e-5)
    docs = [[{"content": "shards of the heads"}], []]
    assert llm.generate_batch(texts, docs) == solo_llm.generate_batch(texts, docs)

    async def main():
        await llm.start()
        try:
            eng = llm.engine
            assert len(eng.cache.grid) == 2 and len(eng.cache.grid[0]) == 2
            assert isinstance(eng.params, MeshTree)
            return await llm.generate_batch_engine(texts, docs)
        finally:
            await llm.stop()

    assert asyncio.new_event_loop().run_until_complete(main()) == llm.generate_batch(
        texts, docs)


def test_fused_server_at_mesh_tp2(tmp_path, monkeypatch):
    """`make_server(mesh=...)` with MESH_TP = 2: /health reports the mesh,
    every model is split over tp, and /query answers as the tp = 1 server
    with the same seeded weights."""
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
    from rag_inference_pipeline_tpu_torch.serve import runtime

    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny",
                        staticmethod(lambda: dataclasses.replace(tiny(), vocab_size=1024)))
    rng = np.random.default_rng(1)
    idx = FlatIndex(64, device=torch.device("cpu"), rescore_k=64)
    idx.add(rng.standard_normal((200, 64)).astype(np.float32))
    idx.save(str(tmp_path / "index.npz"))
    toks = rng.integers(1, 1000, (200, 8)).astype(np.int32)
    np.save(tmp_path / "doc_tokens.npy", toks)
    np.save(tmp_path / "doc_tokens_mask.npy", np.ones_like(toks))
    env = {
        "DEVICE_PLATFORM": "cpu", "USE_FUSED_PIPELINE": "1", "INDEX_DTYPE": "int8",
        "INDEX_PATH": str(tmp_path / "index.npz"),
        "DOC_TOKENS_PATH": str(tmp_path / "doc_tokens.npy"),
        "EMBEDDING_MODEL": "tiny-embed", "LLM_MODEL": "tiny-llm",
        "SENTIMENT_MODEL": "tiny-sentiment", "TOXICITY_MODEL": "tiny-toxicity",
        "BATCH_SHAPE_BUCKETS": "1,2,4", "MAX_TOKENS": "3", "TRUNCATE_LENGTH": "32",
        "RETRIEVAL_K": "5", "PARAM_DTYPE": "float32", "MODEL_WEIGHTS_DIR": "",
        "WARMUP_BUCKETS": "0", "MESH_TP": "2",
    }
    answers = {}
    for tp in (2, 1):
        server = runtime.make_server(load_settings(env), port=0, mesh=_tmesh(1, tp))
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        port = server.server_address[1]
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
                health = json.loads(r.read())
            assert health["mesh"] == {"dp": 1, "tp": tp}
            ex = server.executor
            split = [isinstance(c.params, TPTree)
                     for c in (ex.embedder, ex.llm, ex.sentiment, ex.toxicity)]
            assert split == [tp == 2] * 4
            bodies = []
            for i in range(3):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/query",
                    data=json.dumps({"query": f"question {i}", "request_id": f"r{i}"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    bodies.append(json.loads(r.read()))
            answers[tp] = bodies
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)
    assert answers[2] == answers[1]
    assert load_settings(env).mesh_tp == 2
