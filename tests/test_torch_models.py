"""Port parity: layers, the BERT encoder, the Qwen decoder and the hash
tokenizer against the JAX package, on the same inputs and the same weights
(carried across by models/weights.py). float32 unless a test says so."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu.models.tokenizer import (
    HashTokenizer as JHashTokenizer,
)
from rag_inference_pipeline_tpu.models.tokenizer import (
    make_tokenizer as j_make_tokenizer,
)
from rag_inference_pipeline_tpu_torch.models import bert as tbert
from rag_inference_pipeline_tpu_torch.models import layers as tlayers
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.tokenizer import (
    HashTokenizer as THashTokenizer,
)
from rag_inference_pipeline_tpu_torch.models.tokenizer import (
    make_tokenizer as t_make_tokenizer,
)
from rag_inference_pipeline_tpu_torch.models.weights import (
    bert_params_from_jax,
    qwen_params_from_jax,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _jit_prefill(cfg):
    return jax.jit(partial(jqwen.qwen_prefill, cfg=cfg))


def _jit_greedy(cfg, n):
    return jax.jit(partial(jqwen.greedy_generate, cfg=cfg, max_new_tokens=n))


def _ids_mask(rng, b, t, vocab, lengths):
    ids = rng.integers(1, vocab, (b, t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


class TestLayers:
    def test_layer_norm_and_gelu(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32)
        w = rng.standard_normal(64).astype(np.float32)
        b = rng.standard_normal(64).astype(np.float32)
        np.testing.assert_allclose(
            _np(tlayers.layer_norm(_t(x), _t(w), _t(b))),
            np.asarray(jlayers.layer_norm(x, w, b)), atol=1e-5, rtol=0,
        )
        np.testing.assert_allclose(
            _np(tlayers.gelu(_t(x))), np.asarray(jlayers.gelu(x)),
            atol=1e-5, rtol=0,
        )

    def test_gqa_attention_with_fully_masked_row(self):
        rng = np.random.default_rng(1)
        q = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
        k = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
        mask = rng.random((2, 1, 4, 6)) > 0.4
        mask[1, 0, 2, :] = False  # fully masked row: uniform, not NaN
        ref = np.asarray(jlayers.attention(q, k, v, jnp.asarray(mask)))
        out = _np(tlayers.attention(_t(q), _t(k), _t(v), torch.from_numpy(mask)))
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def bert_pair():
    cfg = jbert.BertConfig.tiny(num_labels=5)
    jp = jax.jit(partial(jbert.init_bert_params, cfg=cfg))(jax.random.key(3))
    tcfg = tbert.BertConfig.tiny(num_labels=5)
    tp = bert_params_from_jax(jax.device_get(jp), tcfg)
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def qwen_pair():
    cfg = jqwen.QwenConfig.tiny()
    jp = jax.jit(partial(jqwen.init_qwen_params, cfg=cfg))(jax.random.key(4))
    tcfg = tqwen.QwenConfig.tiny()
    tp = qwen_params_from_jax(jax.device_get(jp), tcfg)
    return cfg, jp, tcfg, tp


class TestBert:
    def test_state_dict_keys_follow_jax_tree(self, bert_pair):
        _, _, _, tp = bert_pair
        keys = tp.state_dict().keys()
        assert "embeddings.word" in keys and "layers.1.q_w" in keys
        assert "classifier.w" in keys

    def test_embed_and_classify(self, bert_pair):
        cfg, jp, tcfg, tp = bert_pair
        rng = np.random.default_rng(5)
        ids, mask = _ids_mask(rng, 4, 16, cfg.vocab_size, [16, 9, 3, 1])
        je = np.asarray(jax.jit(partial(jbert.bert_embed, cfg=cfg))(
            jp, input_ids=ids, attn_mask=mask))
        jc = np.asarray(jax.jit(partial(jbert.bert_classify, cfg=cfg))(
            jp, input_ids=ids, attn_mask=mask))
        with torch.inference_mode():
            te = _np(tbert.bert_embed(tp, tcfg, _t(ids), _t(mask)))
            tc = _np(tbert.bert_classify(tp, tcfg, _t(ids), _t(mask)))
        np.testing.assert_allclose(te, je, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=0)

    def test_embed_bf16(self, bert_pair):
        """bf16 weights and activations: both sides round every matmul
        output and residual add to 8 mantissa bits (2^-8 = 0.4% relative),
        XLA and PyTorch at different places, over 2 layers; the embedding
        is unit-norm, so 0.05 absolute bounds a few bf16 ulps of drift."""
        cfg, jp, tcfg, _ = bert_pair
        jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp16 = bert_params_from_jax(
            jax.device_get(jp16), tcfg, dtype=torch.bfloat16
        )
        rng = np.random.default_rng(6)
        ids, mask = _ids_mask(rng, 3, 16, cfg.vocab_size, [16, 8, 2])
        je = np.asarray(jax.jit(partial(jbert.bert_embed, cfg=cfg))(
            jp16, input_ids=ids, attn_mask=mask))
        with torch.inference_mode():
            te = _np(tbert.bert_embed(tp16, tcfg, _t(ids), _t(mask)))
        np.testing.assert_allclose(te, je, atol=5e-2, rtol=0)
        cos = (te * je).sum(-1)
        assert (cos > 0.99).all()


class TestQwen:
    def _prompt(self, rng, cfg):
        return _ids_mask(rng, 3, 12, cfg.vocab_size, [12, 7, 1])

    def test_prefill_logits(self, qwen_pair):
        cfg, jp, tcfg, tp = qwen_pair
        rng = np.random.default_rng(7)
        ids, mask = self._prompt(rng, cfg)
        jcache = jlayers.KVCache.zeros(
            cfg.layers, 3, 20, cfg.kv_heads, cfg.head_dim, dtype=jnp.float32
        )
        jl, _ = _jit_prefill(cfg)(jp, input_ids=ids, attn_mask=mask, cache=jcache)
        tcache = tqwen.KVCache.zeros(
            tcfg.layers, 3, 20, tcfg.kv_heads, tcfg.head_dim, dtype=torch.float32
        )
        with torch.inference_mode():
            tl, tc = tqwen.qwen_prefill(tp, tcfg, _t(ids), _t(mask), tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tc.length.numpy(), mask.sum(1))

    def test_decode_insert_clamps_to_last_slot(self, qwen_pair):
        """A lane whose position is past the cache writes slot S-1, as the
        reference's one-hot insert does."""
        cfg, jp, tcfg, tp = qwen_pair
        s = 6
        tcache = tqwen.KVCache.zeros(
            tcfg.layers, 2, s, tcfg.kv_heads, tcfg.head_dim, dtype=torch.float32
        )
        tcache.length = torch.tensor([2, s + 3], dtype=torch.int32)
        jcache = jlayers.KVCache(
            k=jnp.zeros(tcache.k.shape), v=jnp.zeros(tcache.v.shape),
            length=jnp.asarray([2, s + 3], jnp.int32),
        )
        toks = np.array([5, 9], np.int32)
        jl, jc = jax.jit(partial(jqwen.qwen_decode_step, cfg=cfg))(
            jp, tokens=toks, cache=jcache)
        with torch.inference_mode():
            tl, tc = tqwen.qwen_decode_step(tp, tcfg, _t(toks), tcache)
        np.testing.assert_allclose(_np(tc.k), np.asarray(jc.k), atol=1e-5, rtol=0)
        assert np.abs(_np(tc.k)[:, 1, s - 1]).sum() > 0
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)

    def test_greedy_tokens_identical(self, qwen_pair):
        cfg, jp, tcfg, tp = qwen_pair
        rng = np.random.default_rng(8)
        ids, mask = self._prompt(rng, cfg)
        jt = np.asarray(_jit_greedy(cfg, 8)(jp, input_ids=ids, attn_mask=mask))
        tt = tqwen.greedy_generate(tp, tcfg, _t(ids), _t(mask), 8).numpy()
        np.testing.assert_array_equal(tt, jt)

    def test_greedy_bf16(self, qwen_pair):
        """bf16 weights, activations and KV cache: the two frameworks round
        at different places, so logits drift by bf16 ulps; greedy tokens
        agree wherever the top two logits are apart by more than that.
        Checked: the first token of every lane (from prefill logits that
        agree within 0.05, a few ulps of values ~O(1)), and at least 80% of
        all tokens (a near-tie may flip one step and the rest follow it)."""
        cfg, jp, tcfg, _ = qwen_pair
        jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp16 = qwen_params_from_jax(
            jax.device_get(jp16), tcfg, dtype=torch.bfloat16
        )
        rng = np.random.default_rng(9)
        ids, mask = self._prompt(rng, cfg)
        jcache = jlayers.KVCache.zeros(
            cfg.layers, 3, 20, cfg.kv_heads, cfg.head_dim, dtype=jnp.bfloat16
        )
        jl, _ = _jit_prefill(cfg)(jp16, input_ids=ids, attn_mask=mask, cache=jcache)
        tcache = tqwen.KVCache.zeros(
            tcfg.layers, 3, 20, tcfg.kv_heads, tcfg.head_dim,
            dtype=torch.bfloat16,
        )
        with torch.inference_mode():
            tl, _ = tqwen.qwen_prefill(tp16, tcfg, _t(ids), _t(mask), tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=5e-2, rtol=0)
        jt = np.asarray(_jit_greedy(cfg, 6)(jp16, input_ids=ids, attn_mask=mask))
        tt = tqwen.greedy_generate(tp16, tcfg, _t(ids), _t(mask), 6).numpy()
        np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
        assert (tt == jt).mean() >= 0.8


def test_hash_tokenizer_identical():
    texts = ["What is retrieval-augmented generation?", "", "x" * 40,
             "Numbers 12, 3.5 and ünïcode!"]
    for kw in ({}, {"vocab_size": 151936, "pad_id": 0, "eos_id": 2}):
        j, t = JHashTokenizer(**kw), THashTokenizer(**kw)
        for max_len in (8, 64):
            ji, jm = j.encode_batch(texts, max_len)
            ti, tm = t.encode_batch(texts, max_len)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
        assert t.decode(ti[0]) == j.decode(ji[0])


def test_hf_tokenizer_identical():
    """A local tokenizer.json (the repo's tiny fixture) is picked the same
    way and gives the same ids, masks, eos id and decoded text."""
    import os

    wdir = os.path.join(os.path.dirname(__file__), "fixtures", "weights")
    kw = dict(vocab_size=1000, pad_id=0, eos_id=2, eos_token="<|im_end|>")
    j = j_make_tokenizer("tiny-qwen", wdir, **kw)
    t = t_make_tokenizer("tiny-qwen", wdir, **kw)
    assert type(t).__name__ == "HFTokenizer" and t.eos_id == j.eos_id
    texts = ["Retrieval-augmented generation, explained.", "", "a b c " * 30]
    ji, jm = j.encode_batch(texts, 24)
    ti, tm = t.encode_batch(texts, 24)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    assert t.decode(ti[0][tm[0] > 0]) == j.decode(ji[0][jm[0] > 0])
