"""Port parity for n-gram speculation: `qwen_extend`, `bigram_draft` and
`ngram_speculative_generate` against the JAX package on the same inputs
and the same (converted) weights, float32 on the CPU. Tokens and
`mean_tokens_per_call` exact; logits within 1e-5.

Two tiny decoders (vocabulary widened to 1024 on both sides): at the init
scale the decoder echoes the last token, so a prompt that ends in a run of
one token accepts every draft (the verify, commit and rollback paths at
full acceptance); with its layer weights scaled by 20 it answers in varied
tokens, which the drafts rarely match (rejection and eos paths)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.weights import qwen_params_from_jax

JCFG = dataclasses.replace(jqwen.QwenConfig.tiny(), vocab_size=1024)
TCFG = dataclasses.replace(tqwen.QwenConfig.tiny(), vocab_size=1024)


def _pair(scale: float):
    jp = jax.jit(partial(jqwen.init_qwen_params, cfg=JCFG))(jax.random.key(5))
    if scale != 1.0:
        for lp in jp["layers"]:
            for key in [k for k in lp if k.endswith("_w")]:
                lp[key] = scale * lp[key]
    return jp, qwen_params_from_jax(jax.device_get(jp), TCFG)


@pytest.fixture(scope="module")
def echo():
    return _pair(1.0)


@pytest.fixture(scope="module")
def varied():
    return _pair(20.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_spec(jp, ids, mask, max_new, **kw):
    fn = jax.jit(partial(jqwen.ngram_speculative_generate, cfg=JCFG,
                         max_new_tokens=max_new, **kw))
    toks, mean = fn(jp, input_ids=jnp.asarray(ids), attn_mask=jnp.asarray(mask))
    return np.asarray(toks), float(mean)


def _port_spec(tp, ids, mask, max_new, **kw):
    toks, mean = tqwen.ngram_speculative_generate(tp, TCFG, _t(ids), _t(mask),
                                                  max_new, **kw)
    return toks.numpy(), float(mean)


def _port_greedy(tp, ids, mask, max_new, **kw):
    return tqwen.greedy_generate(tp, TCFG, _t(ids), _t(mask), max_new, **kw).numpy()


def _prompts(rng, b, t, min_len=8):
    ids = rng.integers(1, TCFG.vocab_size, (b, t)).astype(np.int32)
    lens = rng.integers(min_len, t + 1, b)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _echo_batch(rng, t=20, run=10):
    """Row 0 ends in a run of one token with no padding (every draft is
    accepted: the window is the prompt's clamped tail), row 1 is padded
    after such a run (its clamped window reads padding), row 2 random (no
    bigram match: the draft repeats the last token, which the echoing
    decoder accepts)."""
    ids = rng.integers(1, TCFG.vocab_size, (3, t)).astype(np.int32)
    ids[0, t - run:] = 7
    ids[1, t - 4 - run : t - 4] = 9
    mask = np.ones((3, t), np.int32)
    mask[1, t - 4:] = 0
    return ids * mask, mask


class TestQwenExtend:
    @pytest.mark.parametrize("lengths", [[4, 9], [17, 6], [20, 15]])
    def test_logits_and_cache_rows_match_jax(self, echo, lengths):
        """From one seeded cache on both sides: the logits of every window
        position and every cache row. A lane whose window would pass the
        end (length + T > S) writes at S - T, where the reference's
        dynamic_update_slice clamps it."""
        jp, tp = echo
        b, s, t = 2, 20, 5
        rng = np.random.default_rng(sum(lengths))
        shape = (TCFG.layers, b, s, TCFG.kv_heads, TCFG.head_dim)
        k0 = rng.standard_normal(shape).astype(np.float32)
        v0 = rng.standard_normal(shape).astype(np.float32)
        length = np.asarray(lengths, np.int32)
        toks = rng.integers(1, TCFG.vocab_size, (b, t)).astype(np.int32)
        jl, jc = jax.jit(partial(jqwen.qwen_extend, cfg=JCFG))(
            jp, tokens=toks, cache=jlayers.KVCache(
                k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(length)))
        with torch.inference_mode():
            tl, tc = tqwen.qwen_extend(tp, TCFG, _t(toks),
                                       tqwen.KVCache(_t(k0), _t(v0), _t(length)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
        for got, ref, before in ((tc.k, jc.k, k0), (tc.v, jc.v, v0)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
            changed = (got.numpy() != before).any(axis=(0, 3, 4))  # [B, S]
            for lane, n in enumerate(lengths):
                start = min(n, s - t)
                want = np.zeros(s, bool)
                want[start : start + t] = True
                np.testing.assert_array_equal(changed[lane], want)
        np.testing.assert_array_equal(tc.length.numpy(), length + t)

    def test_matches_sequential_decode_steps(self, varied):
        """One extend call scores a window as the decode steps one by one
        do, and leaves the same cache length."""
        _, tp = varied
        rng = np.random.default_rng(3)
        ids, mask = _prompts(rng, 2, 12)
        toks = _t(rng.integers(1, TCFG.vocab_size, (2, 4)).astype(np.int32))
        with torch.inference_mode():
            def prefilled():
                cache = tqwen.KVCache.zeros(TCFG.layers, 2, 20, TCFG.kv_heads,
                                            TCFG.head_dim, dtype=torch.float32)
                return tqwen.qwen_prefill(tp, TCFG, _t(ids), _t(mask), cache)[1]

            seq = prefilled()
            steps = [tqwen.qwen_decode_step(tp, TCFG, toks[:, j], seq)[0]
                     for j in range(4)]
            ext, c2 = tqwen.qwen_extend(tp, TCFG, toks, prefilled())
        for j in range(4):
            torch.testing.assert_close(ext[:, j], steps[j], atol=2e-4, rtol=2e-4)
        assert torch.equal(c2.length, seq.length)


class TestBigramDraft:
    @pytest.mark.parametrize("case", ["middle", "clamped_tail", "no_match",
                                      "beyond_plen", "gamma_over_row"])
    def test_matches_jax(self, case):
        """Batched rows against the reference's per-row function (vmapped).
        `clamped_tail`: the match sits at the prompt's end, so the window's
        start is clamped to TT - gamma, as dynamic_slice_in_dim clamps it."""
        tt, gamma = 16, 5
        rng = np.random.default_rng(1)
        ctx = rng.integers(20, 60, (3, tt)).astype(np.int32)
        plen = np.full(3, tt, np.int32)
        last2 = np.array([[3, 4]] * 3, np.int32)
        if case == "middle":
            ctx[:, 6:8] = [3, 4]
        elif case == "clamped_tail":
            ctx[:, tt - 2 :] = [3, 4]
            ctx[1, 2:4] = [3, 4]  # an earlier match loses to the last one
        elif case == "beyond_plen":
            ctx[:, 9:11] = [3, 4]
            ctx[:, 3:5] = [3, 4]
            plen[:] = [10, 11, 16]  # the pair at 9:11 counts from plen 11
        elif case == "gamma_over_row":
            tt, gamma = 4, 6
            ctx = np.array([[3, 4, 8, 9], [1, 3, 4, 2], [5, 5, 5, 5]], np.int32)
            plen = np.full(3, tt, np.int32)
        want = np.asarray(jax.vmap(partial(jqwen.bigram_draft, gamma=gamma))(
            jnp.asarray(ctx), jnp.asarray(plen), jnp.asarray(last2)))
        got = tqwen.bigram_draft(_t(ctx), _t(plen), _t(last2), gamma=gamma).numpy()
        np.testing.assert_array_equal(got, want)
        one = tqwen.bigram_draft(_t(ctx[0]), _t(plen[0]), _t(last2[0]), gamma=gamma)
        np.testing.assert_array_equal(one.numpy(), want[0])


class TestSpeculativeParity:
    @pytest.mark.parametrize("gamma", [1, 4, 8])
    def test_full_acceptance_rows_match_jax(self, echo, gamma):
        """Tokens and mean tokens per call equal the JAX package's, with
        rows that accept every draft beside rows that accept none; the
        budget cuts the last commit."""
        jp, tp = echo
        ids, mask = _echo_batch(np.random.default_rng(gamma))
        kw = dict(gamma=gamma, eos_token_id=-1, cache_len=20 + 13)
        means = []
        for rows in (slice(None), slice(0, 1)):  # the batch; the accepting row
            jt, jm = _jax_spec(jp, ids[rows], mask[rows], 13, **kw)
            tt, tm = _port_spec(tp, ids[rows], mask[rows], 13, **kw)
            np.testing.assert_array_equal(tt, jt)
            assert tm == jm
            np.testing.assert_array_equal(
                tt, _port_greedy(tp, ids[rows], mask[rows], 13, cache_len=33))
            means.append(tm)
        # the batch takes as many rounds as its slowest row (row 1 reads
        # padding: it accepts nothing for gamma <= 4, four drafts for 8);
        # alone, row 0 commits gamma + 1 a round up to the budget's cut
        assert means[0] == (1.0 if gamma <= 4 else 12 / 3)
        assert means[1] == 12 / -(-12 // (gamma + 1))

    @pytest.mark.parametrize("gamma", [2, 4, 7])
    def test_token_identity_vs_jax_and_greedy(self, varied, gamma):
        jp, tp = varied
        ids, mask = _prompts(np.random.default_rng(10 + gamma), 3, 24)
        jt, jm = _jax_spec(jp, ids, mask, 18, gamma=gamma, eos_token_id=5)
        tt, tm = _port_spec(tp, ids, mask, 18, gamma=gamma, eos_token_id=5)
        np.testing.assert_array_equal(tt, jt)
        assert tm == jm and tm >= 1.0
        np.testing.assert_array_equal(tt, _port_greedy(tp, ids, mask, 18, eos_token_id=5))

    def test_eos_truncation(self, varied):
        """eos = the most common greedy token, so lanes finish early."""
        jp, tp = varied
        ids, mask = _prompts(np.random.default_rng(4), 4, 16)
        probe = _port_greedy(tp, ids, mask, 12)
        eos = int(np.bincount(probe.ravel()).argmax())
        jt, jm = _jax_spec(jp, ids, mask, 12, gamma=4, eos_token_id=eos)
        tt, tm = _port_spec(tp, ids, mask, 12, gamma=4, eos_token_id=eos)
        np.testing.assert_array_equal(tt, jt)
        assert tm == jm
        np.testing.assert_array_equal(tt, _port_greedy(tp, ids, mask, 12, eos_token_id=eos))
        assert (tt == eos).any()

    @pytest.mark.parametrize("max_new,gamma", [(4, 9), (1, 4)])
    def test_short_budgets(self, echo, max_new, gamma):
        """gamma > max_new (the windows overhang the budget), and a single
        token (one round that commits nothing, as in the reference)."""
        jp, tp = echo
        ids, mask = _echo_batch(np.random.default_rng(2), t=12, run=6)
        kw = dict(gamma=gamma, eos_token_id=-1, cache_len=16)
        jt, jm = _jax_spec(jp, ids, mask, max_new, **kw)
        tt, tm = _port_spec(tp, ids, mask, max_new, **kw)
        np.testing.assert_array_equal(tt, jt)
        assert tm == jm
        np.testing.assert_array_equal(tt, _port_greedy(tp, ids, mask, max_new, cache_len=16))


class TestAcceptanceInjection:
    """The benchmark-only Bernoulli acceptance draws from a torch
    generator, which cannot give jax.random's bits: properties only."""

    def test_p0_token_identical_to_greedy(self, varied):
        _, tp = varied
        ids, mask = _prompts(np.random.default_rng(6), 2, 16, min_len=16)
        got, mean = _port_spec(tp, ids, mask, 16, gamma=4, inject_accept_p=0.0)
        np.testing.assert_array_equal(got, _port_greedy(tp, ids, mask, 16))
        assert mean == pytest.approx(1.0)

    def test_commits_per_call_grow_with_p(self, varied):
        _, tp = varied
        ids, mask = _prompts(np.random.default_rng(7), 2, 16, min_len=16)
        means = {}
        for p in (0.0, 0.5, 0.9):
            toks, means[p] = _port_spec(
                tp, ids, mask, 24, gamma=4, inject_accept_p=p,
                inject_generator=torch.Generator().manual_seed(3))
            assert toks.shape == (2, 24)
        assert means[0.0] == pytest.approx(1.0)
        assert means[0.0] < means[0.5] < means[0.9]
        assert means[0.9] > 2.0


def test_component_speculation_matches_greedy(monkeypatch):
    """USE_SPECULATIVE_DECODING serves the staged LLM component: the same
    answers as greedy."""
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(lambda: TCFG))
    base = dict(llm_model="tiny", max_tokens=12, batch_shape_buckets="2",
                prefill_buckets="32", device_platform="cpu", model_weights_dir="")
    outs = []
    for spec in (False, True):
        comp = tcomp.LLMComponent(
            Settings(**base, use_speculative_decoding=spec, speculative_gamma=4),
            torch.device("cpu"))
        comp.load()
        for lp in comp.params.layers:
            for name, w in lp.named_parameters():
                if name.endswith("_w"):
                    w.mul_(20)
        outs.append(comp.generate_batch(
            ["what is jax?", "tell me about gpus"],
            [[{"content": "jax is an array library"}],
             [{"content": "gpus multiply matrices"}]]))
    assert outs[0] == outs[1]
    assert any(outs[0])


def test_fused_step_speculation_matches_jax():
    """The fused step's speculative branch: doc ids and tokens equal the
    JAX package's speculative step, and the tokens equal the greedy step's."""
    from rag_inference_pipeline_tpu.core import make_mesh
    from rag_inference_pipeline_tpu.engine.device_pipeline import (
        DeviceRAGPipeline as JPipeline,
    )
    from rag_inference_pipeline_tpu.models.bert import BertConfig as JBertConfig
    from rag_inference_pipeline_tpu.models.bert import init_bert_params
    from rag_inference_pipeline_tpu_torch.engine.device_pipeline import (
        DeviceRAGPipeline as TPipeline,
    )
    from rag_inference_pipeline_tpu_torch.models.bert import BertConfig as TBertConfig
    from rag_inference_pipeline_tpu_torch.models.weights import bert_params_from_jax

    rng = np.random.default_rng(11)
    bcfg = JBertConfig.tiny()
    jb = init_bert_params(jax.random.key(1), bcfg)
    jq, tq = _pair(20.0)
    db = rng.standard_normal((300, bcfg.hidden)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    toks = rng.integers(1, 1000, (300, 8)).astype(np.int32)
    kw = dict(k=5, ctx_docs=2, max_new_tokens=6, rescore_k=64)
    tb = bert_params_from_jax(jax.device_get(jb), TBertConfig.tiny())
    q = rng.integers(1, 400, (4, 10)).astype(np.int32)
    qm = np.ones_like(q)
    outs = {}
    for spec in (False, True):
        jpipe = JPipeline(mesh=make_mesh(dp=1, tp=1), bert_cfg=bcfg, qwen_cfg=JCFG,
                          index_dtype="int8", doc_tok_len=8, speculative=spec,
                          spec_gamma=3, **kw)
        tpipe = TPipeline(device=torch.device("cpu"), bert_cfg=TBertConfig.tiny(),
                          qwen_cfg=TCFG, speculative=spec, spec_gamma=3, **kw)
        jpipe.build(jb, jq, db, toks)
        tpipe.build(tb, tq, db, toks)
        jout, tout = jpipe.step(q, qm), tpipe.step(q, qm)
        np.testing.assert_array_equal(tout.doc_ids.numpy(), np.asarray(jout.doc_ids))
        np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
        outs[spec] = tout.tokens.numpy()
    np.testing.assert_array_equal(outs[True], outs[False])
