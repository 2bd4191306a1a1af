"""Port parity for the slice as a whole: the fused RAG step and the fused
executor against the JAX package, on the same tiny corpus and the same
(converted) weights, float32 on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core import make_mesh
from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.engine.device_pipeline import (
    DeviceRAGPipeline as JPipeline,
)
from rag_inference_pipeline_tpu.engine.fused_executor import (
    FusedExecutor as JFusedExecutor,
)
from rag_inference_pipeline_tpu.index.flat import FlatIndex as JFlatIndex
from rag_inference_pipeline_tpu.models import components as jcomp
from rag_inference_pipeline_tpu.models.bert import BertConfig as JBertConfig
from rag_inference_pipeline_tpu.models.bert import init_bert_params
from rag_inference_pipeline_tpu.models.qwen import QwenConfig as JQwenConfig
from rag_inference_pipeline_tpu.models.qwen import init_qwen_params
from rag_inference_pipeline_tpu_torch.core.config import Settings as TSettings
from rag_inference_pipeline_tpu_torch.engine.device_pipeline import (
    DeviceRAGPipeline as TPipeline,
)
from rag_inference_pipeline_tpu_torch.engine.fused_executor import (
    FusedExecutor as TFusedExecutor,
)
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models.bert import BertConfig as TBertConfig
from rag_inference_pipeline_tpu_torch.models.qwen import QwenConfig as TQwenConfig
from rag_inference_pipeline_tpu_torch.models.weights import (
    bert_params_from_jax,
    qwen_params_from_jax,
)

CPU = torch.device("cpu")


def _corpus(rng, n, d, doc_len, vocab):
    db = rng.standard_normal((n, d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    toks = rng.integers(1, vocab, (n, doc_len)).astype(np.int32)
    # per-doc padding holes exercise the stable prompt compaction
    toks[:, doc_len - 3 :] *= (rng.random((n, 3)) > 0.5).astype(np.int32)
    return db, toks


@pytest.mark.parametrize("n", [700, 1])
@pytest.mark.parametrize("from_index", [False, True])
def test_fused_step_matches_jax(n, from_index):
    """Identical doc ids and tokens. n=1 leaves fewer hits than context
    docs (ids of -1 must not attend to doc 0); from_index takes the fast
    path over a loaded index's chunk-padded arrays."""
    rng = np.random.default_rng(n)
    bcfg, qcfg = JBertConfig.tiny(), JQwenConfig.tiny()
    jb = init_bert_params(jax.random.key(1), bcfg)
    jq = init_qwen_params(jax.random.key(2), qcfg)
    db, toks = _corpus(rng, n, bcfg.hidden, 8, 400)
    kw = dict(k=5, ctx_docs=2, max_new_tokens=4, rescore_k=64)
    jpipe = JPipeline(mesh=make_mesh(dp=1, tp=1), bert_cfg=bcfg,
                      qwen_cfg=qcfg, index_dtype="int8", doc_tok_len=8, **kw)
    tpipe = TPipeline(device=CPU, bert_cfg=TBertConfig.tiny(),
                      qwen_cfg=TQwenConfig.tiny(), **kw)
    tb = bert_params_from_jax(jax.device_get(jb), TBertConfig.tiny())
    tq = qwen_params_from_jax(jax.device_get(jq), TQwenConfig.tiny())
    if from_index:
        jidx = JFlatIndex(bcfg.hidden, dtype="int8")
        jidx.add(db)
        jpipe.build(jb, jq, None, toks, db_i8=jidx._db_i8,
                    db_scale=jidx._db_gscale, db_rescore=jidx._db, ntotal=n)
        tpipe.build(
            tb, tq, None, toks,
            db_i8=torch.from_numpy(np.array(jidx._db_i8)),
            db_scale=torch.tensor(float(jidx._db_gscale)),
            db_rescore=torch.from_numpy(
                np.array(jidx._db, np.float32)).to(torch.bfloat16),
            ntotal=n,
        )
        assert tpipe.db_i8.shape[0] > n  # chunk-padded: ntotal masks
    else:
        jpipe.build(jb, jq, db, toks)
        tpipe.build(tb, tq, db, toks)
    q = rng.integers(1, 400, (8, 10)).astype(np.int32)
    qm = (np.arange(10)[None] < rng.integers(1, 11, (8, 1))).astype(np.int32)
    q *= qm
    jout = jpipe.step(q, qm)
    tout = tpipe.step(q, qm)
    np.testing.assert_array_equal(tout.doc_ids.numpy(), np.asarray(jout.doc_ids))
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_allclose(
        tout.scores.numpy(), np.asarray(jout.scores), rtol=1e-5, atol=1e-5
    )
    if n == 1:
        assert (tout.doc_ids.numpy()[:, 1:] == -1).all()


_TINY = dict(
    embedding_model="tiny-embed", llm_model="tiny-llm",
    sentiment_model="tiny-sentiment", toxicity_model="tiny-toxicity",
    batch_shape_buckets="1,2,4,8", max_tokens=4, truncate_length=64,
    retrieval_k=5, llm_context_docs=2, param_dtype="float32",
    use_fused_pipeline=True, index_dtype="int8",
)


def test_fused_executor_matches_jax(tmp_path):
    """process_batch over 11 requests (chunks of 8 + 3, padded to buckets
    8 and 4): identical responses, sentiment labels and toxicity flags."""
    rng = np.random.default_rng(42)
    n, doc_len = 300, 8
    db, toks = _corpus(rng, n, 64, doc_len, 1000)
    tok_path = str(tmp_path / "doc_tokens.npy")
    np.save(tok_path, toks)
    np.save(tok_path.replace(".npy", "_mask.npy"), (toks > 0).astype(np.int32))
    jidx = JFlatIndex(64, dtype="int8")
    jidx.add(db)
    idx_path = str(tmp_path / "index.npz")
    jidx.save(idx_path)

    js = JSettings(**_TINY, doc_tokens_path=tok_path)
    ts = TSettings(**_TINY, device_platform="cpu", doc_tokens_path=tok_path)
    jparts = [jcomp.EmbedderComponent(js), jcomp.LLMComponent(js),
              jcomp.SentimentComponent(js), jcomp.ToxicityComponent(js)]
    tparts = [tcomp.EmbedderComponent(ts, CPU), tcomp.LLMComponent(ts, CPU),
              tcomp.SentimentComponent(ts, CPU), tcomp.ToxicityComponent(ts, CPU)]
    for jc, tc in zip(jparts, tparts):
        jc.load()
        tc.load()
    # the hash tokenizer's word ids start at 1000, past the tiny decoder's
    # 512-row vocabulary: widen the decoder on both sides so every id is
    # a real embedding row
    jllm, tllm = jparts[1], tparts[1]
    jllm.cfg = dataclasses.replace(jllm.cfg, vocab_size=1024)
    tllm.cfg = dataclasses.replace(tllm.cfg, vocab_size=1024)
    jllm.params = init_qwen_params(jax.random.key(7), jllm.cfg)
    for jc, tc in zip(jparts, tparts):
        tree = jax.device_get(jc.params)
        tc.params = (
            qwen_params_from_jax(tree, tc.cfg) if tc is tllm
            else bert_params_from_jax(tree, tc.cfg)
        )
    jex = JFusedExecutor(js, mesh_ctx=make_mesh(dp=1, tp=1), embedder=jparts[0],
                         index=jidx, llm=jllm, sentiment=jparts[2],
                         toxicity=jparts[3])
    tex = TFusedExecutor(ts, device=CPU, embedder=tparts[0],
                         index=load_index(idx_path, CPU), llm=tllm,
                         sentiment=tparts[2], toxicity=tparts[3])
    jex.load()
    tex.load()
    items = [{"query": f"what does document {i} say about topic {i * 7}?"}
             for i in range(11)]
    jout = jex.process_batch(items)
    tout = tex.process_batch(items)
    assert tout == jout
    # random toxicity heads flag every text: lower their bias on both
    # sides so the decoded texts themselves are compared too
    jparts[3].params["classifier"]["b"] = jax.numpy.full((6,), -5.0)
    tparts[3].params.classifier.b.fill_(-5.0)
    jout = jex.process_batch(items)
    tout = tex.process_batch(items)
    assert tout == jout
    assert not any(o["is_toxic"] for o in tout)
