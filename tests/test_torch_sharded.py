"""Port parity for data parallelism, part two: the sharded token gather,
the fused step at dp = 2 and the flat, IVF-Flat and IVF-PQ indexes at
dp > 1, against the JAX package on the same inputs.

The JAX side runs on the 8-device fake CPU mesh of `tests/conftest.py`,
Pallas in interpret mode, as its own tests run it; the port runs on a mesh
of dp positions on the one CPU (`force_host_devices`), its kernels' plain
versions. Unit vectors sum in another order, so scores are held to
rtol=1e-5, atol=1e-5; ids and tokens are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core import make_mesh as j_make_mesh
from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh

TOL = dict(rtol=1e-5, atol=1e-5)


def _meshes(dp):
    return j_make_mesh(dp=dp, tp=1), make_mesh(dp=dp, devices=force_host_devices(dp))


def _unit_vectors(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _same(t_out, j_out):
    ts, ti = (a.numpy() for a in t_out)
    js, ji = (np.asarray(a) for a in j_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, **TOL)


# ---------------------------------------------------------------------------
# The sharded token gather and the fused step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_token_gather_matches_jax(dp):
    """Owners contribute their rows, ids of -1 (and past the store) none."""
    from rag_inference_pipeline_tpu.engine.device_pipeline import (
        sharded_token_gather as j_gather,
    )
    from rag_inference_pipeline_tpu_torch.engine.device_pipeline import sharded_token_gather

    rng = np.random.default_rng(dp)
    n, length = 40, 6
    tok = rng.integers(1, 500, (n, length)).astype(np.int32)
    msk = (rng.random((n, length)) > 0.3).astype(np.int32)
    ids = rng.integers(0, n, (5, 3)).astype(np.int32)
    ids[0, 1] = -1
    ids[2, :] = -1
    ids[3, 0] = n - 1
    jm, tm = _meshes(dp)
    jg, jmk = j_gather(jm, jm.put(jnp.asarray(tok), jm.rows_dp),
                       jm.put(jnp.asarray(msk), jm.rows_dp), jnp.asarray(ids))
    tg, tmk = sharded_token_gather(tm, tm.put(tok, tm.rows_dp), tm.put(msk, tm.rows_dp),
                                   torch.from_numpy(ids))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    assert (tg.numpy()[2] == 0).all() and (tmk.numpy()[0, 1] == 0).all()


def _tiny_models():
    from rag_inference_pipeline_tpu.models.bert import BertConfig as JBertConfig
    from rag_inference_pipeline_tpu.models.bert import init_bert_params
    from rag_inference_pipeline_tpu.models.qwen import QwenConfig as JQwenConfig
    from rag_inference_pipeline_tpu.models.qwen import init_qwen_params
    from rag_inference_pipeline_tpu_torch.models.bert import BertConfig
    from rag_inference_pipeline_tpu_torch.models.qwen import QwenConfig
    from rag_inference_pipeline_tpu_torch.models.weights import (
        bert_params_from_jax,
        qwen_params_from_jax,
    )

    bcfg, qcfg = JBertConfig.tiny(), JQwenConfig.tiny()
    jb = init_bert_params(jax.random.key(1), bcfg)
    jq = init_qwen_params(jax.random.key(2), qcfg)
    tb = bert_params_from_jax(jax.device_get(jb), BertConfig.tiny())
    tq = qwen_params_from_jax(jax.device_get(jq), QwenConfig.tiny())
    return (bcfg, qcfg, jb, jq), (BertConfig.tiny(), QwenConfig.tiny(), tb, tq)


@pytest.mark.parametrize("from_index", [False, True])
def test_fused_step_dp2_matches_jax(from_index):
    """The fused step on a dp = 2 mesh against the JAX DeviceRAGPipeline on
    a dp = 2 mesh: the embed and the decode batch-over-dp, K1 once a shard,
    the sharded token store; ids and tokens identical. from_index takes
    the fast path over a sharded FlatIndex's row shards."""
    from rag_inference_pipeline_tpu.engine.device_pipeline import DeviceRAGPipeline as JPipe
    from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
    from rag_inference_pipeline_tpu_torch.engine.device_pipeline import DeviceRAGPipeline
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex

    (bcfg, qcfg, jb, jq), (tbcfg, tqcfg, tb, tq) = _tiny_models()
    rng = np.random.default_rng(3)
    n, doc_len = 701, 8
    db = _unit_vectors(rng, n, bcfg.hidden)
    toks = rng.integers(1, 400, (n, doc_len)).astype(np.int32)
    toks[:, doc_len - 3 :] *= (rng.random((n, 3)) > 0.5).astype(np.int32)
    kw = dict(k=5, ctx_docs=2, max_new_tokens=4, rescore_k=64)
    jm, tm = _meshes(2)
    jpipe = JPipe(mesh=jm, bert_cfg=bcfg, qwen_cfg=qcfg, index_dtype="int8",
                  doc_tok_len=doc_len, **kw)
    tpipe = DeviceRAGPipeline(device=tm.front, bert_cfg=tbcfg, qwen_cfg=tqcfg, mesh=tm, **kw)
    if from_index:
        jidx = JFlatIndex(bcfg.hidden, dtype="int8", mesh=jm)
        jidx.add(db)
        jpipe.build(jb, jq, None, toks, db_i8=jidx._db_i8, db_scale=jidx._db_gscale,
                    db_rescore=jidx._db, ntotal=n)
        tidx = FlatIndex(bcfg.hidden, dtype="int8", mesh=tm)
        tidx.add(db)
        assert len(tidx._db_i8) == 2
        tpipe.build(tb, tq, None, toks, db_i8=tidx._db_i8, db_scale=tidx._db_gscale,
                    db_rescore=tidx._db, ntotal=n)
    else:
        jpipe.build(jb, jq, db, toks)
        tpipe.build(tb, tq, db, toks)
    assert len(tpipe.doc_tokens) == 2 and tpipe.bert_params[0] is tpipe.bert_params[1]
    q = rng.integers(1, 400, (8, 10)).astype(np.int32)
    qm = (np.arange(10)[None] < rng.integers(1, 11, (8, 1))).astype(np.int32)
    q *= qm
    jout = jpipe.step(q, qm)
    tout = tpipe.step(q, qm)
    np.testing.assert_array_equal(tout.doc_ids.numpy(), np.asarray(jout.doc_ids))
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores), **TOL)
    with pytest.raises(ValueError, match="multiple of dp=2"):
        tpipe.step(q[:3], qm[:3])


# ---------------------------------------------------------------------------
# The indexes at dp > 1
# ---------------------------------------------------------------------------


def _no_jax_native(monkeypatch):
    """The JAX host refine takes its numpy route: never build the JAX
    package's native code in a test."""
    from rag_inference_pipeline_tpu.utils import cpuscan as jcpuscan

    def refuse(*_a, **_k):
        raise OSError("native build disabled in tests")

    monkeypatch.setattr(jcpuscan, "load_lib", refuse)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("store", ["device", "host", "bf16"])
def test_flat_index_sharded_matches_jax(monkeypatch, tmp_path, dp, store):
    """FlatIndex at dp > 1 built by `add` and loaded from a reference
    `.npz` into shards: int8 codes padded to chunk x dp with the artifact's
    global scale, K1 once a shard with the device re-score or the host
    refine; bf16 rows padded to a dp multiple through `sharded_topk`."""
    from rag_inference_pipeline_tpu.index.base import BaseIndex
    from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
    from rag_inference_pipeline_tpu_torch.index.base import load_index
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex

    _no_jax_native(monkeypatch)
    rng = np.random.default_rng(dp + len(store))
    n, d, k = 1001, 32, 6
    x = _unit_vectors(rng, n, d)
    q = x[:5] + 0.05 * _unit_vectors(rng, 5, d)
    dtype = "bfloat16" if store == "bf16" else "int8"
    rstore = "host" if store == "host" else "device"
    jm, tm = _meshes(dp)
    jidx = JFlatIndex(d, dtype=dtype, nbins=128, chunk=128, mesh=jm, rescore_store=rstore)
    jidx.add(x)
    tidx = FlatIndex(d, dtype=dtype, nbins=128, chunk=128, mesh=tm, rescore_store=rstore)
    tidx.add(x)
    assert len(tidx._db_i8 if dtype == "int8" else tidx._db) == dp
    _same(tidx.search(q, k), jidx.search(q, k))
    # the reference's artifact (saved unsharded) loaded into shards
    solo = JFlatIndex(d, dtype=dtype, rescore_store=rstore)
    solo.add(x)
    path = str(tmp_path / "flat.npz")
    solo.save(path)
    jl = BaseIndex.load(path, jm, rescore_store=rstore)
    tl = load_index(path, mesh=tm, rescore_store=rstore)
    assert tl.ntotal == n and len(tl._db_i8 if dtype == "int8" else tl._db) == dp
    if dtype == "int8":
        assert sum(s.shape[0] for s in tl._db_i8) % (tl._chunk_i8 * dp) == 0
        assert tl._front_scale().item() == np.float32(solo._db_gscale)
    _same(tl.search(q, k), jl.search(q, k))
    back = str(tmp_path / "back.npz")
    tl.save(back)  # the shards join again into the reference's layout
    with np.load(back) as zb, np.load(path) as zp:
        for name in zp.files:
            np.testing.assert_array_equal(zb[name], zp[name])


@pytest.mark.parametrize("dp", [2, 4])
def test_ivf_flat_index_sharded_matches_jax(tmp_path, dp):
    """A reference IVF-Flat artifact loaded into dp shards (nlist 16):
    the sharded search at the default and a narrow nprobe_local."""
    from rag_inference_pipeline_tpu.index.base import BaseIndex
    from rag_inference_pipeline_tpu.index.ivf_flat import IVFFlatIndex as JIVFFlatIndex
    from rag_inference_pipeline_tpu_torch.index.base import load_index
    from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex

    rng = np.random.default_rng(dp)
    x = _unit_vectors(rng, 800, 32)
    q = x[:6] + 0.05 * _unit_vectors(rng, 6, 32)
    solo = JIVFFlatIndex(32, 16, nprobe=6)
    solo.train_add(x, iters=4)
    path = str(tmp_path / "ivf.npz")
    solo.save(path)
    jm, tm = _meshes(dp)
    jidx = BaseIndex.load(path, jm)
    tidx = load_index(path, mesh=tm)
    assert isinstance(tidx, IVFFlatIndex) and len(tidx._shards) == dp
    for nprobe_local in (0, 1):
        jidx.nprobe_local = tidx.nprobe_local = nprobe_local
        _same(tidx.search(q, 8), jidx.search(q, 8))
    assert tidx.imbalance == pytest.approx(solo.imbalance)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("ksub", [16, 256])
def test_ivfpq_index_sharded_matches_jax(tmp_path, dp, ksub):
    """A reference IVF-PQ artifact (exact re-score store) loaded into dp
    shards: K6 (PQ4) or the gather ADC (PQ8) once a shard, the merged
    shortlist re-scored from the one store on the front device."""
    from rag_inference_pipeline_tpu.index.base import BaseIndex
    from rag_inference_pipeline_tpu.index.ivf_pq import IVFPQIndex as JIVFPQIndex
    from rag_inference_pipeline_tpu_torch.index.base import load_index

    rng = np.random.default_rng(dp * ksub)
    x = _unit_vectors(rng, 900, 32)
    q = x[:6] + 0.05 * _unit_vectors(rng, 6, 32)
    solo = JIVFPQIndex(32, 8, 8, nprobe=4, rescore_k=20, ksub=ksub)
    solo.train_add(x, kmeans_iters=4, pq_iters=3)
    path = str(tmp_path / "pq.npz")
    solo.save(path)
    jm, tm = _meshes(dp)
    jidx = BaseIndex.load(path, jm)
    tidx = load_index(path, mesh=tm)
    assert len(tidx._shards) == dp and tidx._vectors.shape == (900, 32)
    _same(tidx.search(q, 7), jidx.search(q, 7))
    tidx.rescore_k = jidx.rescore_k = 0  # the merged ADC list itself
    _same(tidx.search(q, 7), jidx.search(q, 7))


@pytest.mark.parametrize("dp,lanes,want", [(1, 8, (1, 2, 4, 8)), (2, 8, (2, 4, 8)),
                                           (4, 5, (4, 8)), (2, 0, (2, 4, 8, 16, 32, 64))])
def test_fused_executor_buckets_are_dp_multiples(dp, lanes, want):
    """The reference's rounding (`fused_executor.py:126-130, 227-236`): each
    shape bucket and the chunk lanes up to a dp multiple; warm-up covers
    the buckets a chunk can be padded to."""
    from rag_inference_pipeline_tpu_torch.core.config import Settings
    from rag_inference_pipeline_tpu_torch.engine.fused_executor import FusedExecutor

    s = Settings(fused_chunk_lanes=lanes, use_fused_pipeline=True)
    mesh = make_mesh(dp=dp, devices=force_host_devices(dp))
    ex = FusedExecutor(s, device=mesh.front, embedder=None, index=None, llm=None, mesh=mesh)
    assert ex._buckets() == tuple(sorted({-(-b // dp) * dp for b in s.shape_buckets}))
    assert ex.dispatched_buckets() == want
