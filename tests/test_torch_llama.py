"""The Llama family in the port against the JAX package, on the CPU.

- the four presets (Llama-3.2-1B and Llama-3.1-8B, base and Instruct)
  field for field as both LLM components resolve them, names matched
  without regard to case, an unknown name refused by both;
- the parameter counts of the port's `meta` skeleton against the
  reference's tree shapes (`jax.eval_shape`, nothing drawn) and the
  published 1.236e9 and 8.03e9 within 2%;
- the rope tables at both presets' published head_dim, theta, max_len and
  llama3 scaling, within ROPE_ATOL;
- 2-layer decoders with the 8B's attention layout (head_dim 128, 4 query
  heads a kv head, an untied head, llama3 rope at theta 5e5, hidden 512)
  and the 1B's (head_dim 64, tied): prefill logits within 1e-4 and greedy
  tokens equal to the JAX package's in f32, and over W8A8 weights against
  the JAX functions run op by op (a jitted JAX divides the int8 scales by
  a reciprocal multiply: ROADMAP, Queue 3); a token may leave the
  reference's only at a step whose top two logits lie within NEAR_TIE
  (each such step printed);
- the chat template, the instruct flag and the end-of-sequence token of
  instruct and base names against the reference's `LLMComponent`;
- the ladder clamp (`utils/hbm.py`): the bytes a lane and the clamped
  ladder against the reference's `utils/hbm.py` at the same free bytes,
  the component's ladder on a faked card, and the fused executor's
  buckets within it;
- the fused executor refusing a document token store of another
  decoder's vocabulary;
- the W8A8 route and launch plans at the 8B's and the 1B's shapes (host
  arithmetic for an H100's 132 SMs).
"""

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.models import components as jcomp
from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu.utils import hbm as jhbm
from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import layers as tlayers
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.weights import qwen_params_from_jax
from rag_inference_pipeline_tpu_torch.ops import w8a8
from rag_inference_pipeline_tpu_torch.serve import runtime
from rag_inference_pipeline_tpu_torch.utils import hbm as thbm

CPU = torch.device("cpu")
NEAR_TIE = 1e-4  # f32 logits, as the other decoder tests hold tokens
# the two libraries' f32 cos and sin of the same f32 angles (up to 4,095
# rad): within an ulp of 1 (5.96e-8 measured on both presets)
ROPE_ATOL = 1.2e-7
H100_SMS = 132
# W8A8 logits against the reference run op by op: the int8 sums are exact
# and a row whose quantized activations agree is bit for bit, but the
# attention's and the norms' f32 sums run in another order, and an element
# of x / s within an ulp of a half-integer then rounds to the other int8
# step, which moved one logit of one row by 2.1e-2 here (hidden 512, the
# layers at 4x the init's scale; every other row bit for bit or within 3e-7)
W8A8_ATOL = 5e-2

NAMES = {
    "meta-llama/Llama-3.2-1B-Instruct": "llama32_1b",
    "meta-llama/Llama-3.2-1B": "llama32_1b",
    "meta-llama/Llama-3.1-8B-Instruct": "llama31_8b",
    "meta-llama/Llama-3.1-8B": "llama31_8b",
}
PUBLISHED = {"llama32_1b": 1.236e9, "llama31_8b": 8.03e9}


def _spell(name: str, how: str) -> str:
    return {"as is": name, "lower": name.lower(), "upper": name.upper()}[how]


# ---------------------------------------------------------------------------
# Presets, parameter counts, rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["as is", "lower", "upper"])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_presets_resolve_field_for_field(name, how):
    """Both components resolve the name (in any case) to the same preset,
    and the preset equals the port's QwenConfig classmethod."""
    spelled = _spell(name, how)
    ref = jcomp.LLMComponent(JSettings(llm_model=spelled)).cfg
    got = tcomp.LLMComponent(Settings(llm_model=spelled), CPU).cfg
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got == getattr(tqwen.QwenConfig, NAMES[name])()


@pytest.mark.parametrize("name", ["mistral/mistral-7b", "meta-llama/Llama-3.1-70B",
                                  "meta-llama/Llama-3.2-1B-chat"])
def test_unknown_llm_names_are_refused_by_both(name):
    with pytest.raises(ValueError, match="unknown llm model"):
        jcomp.LLMComponent(JSettings(llm_model=name))
    with pytest.raises(ValueError, match="unknown llm model"):
        tcomp.LLMComponent(Settings(llm_model=name), CPU)


def _count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("preset", sorted(PUBLISHED))
def test_parameter_counts_match_the_reference_and_published(preset):
    """The port's skeleton (nothing drawn) holds the reference's tree's
    parameters, leaf for leaf in number, within 2% of the published count
    (as tests/test_llama_family.py:163-180 holds the reference's)."""
    tcfg = getattr(tqwen.QwenConfig, preset)()
    jcfg = getattr(jqwen.QwenConfig, preset)()
    skel = tqwen.init_qwen_params(tcfg, generator=None, device="meta")
    got = sum(t.numel() for t in skel.state_dict().values())
    shapes = jax.eval_shape(partial(jqwen.init_qwen_params, cfg=jcfg), jax.random.key(0))
    assert got == _count(shapes)
    assert abs(got / PUBLISHED[preset] - 1) < 0.02
    assert ("lm_head" in skel.to_tree()) == (not tcfg.tie_embeddings)
    assert "q_b" not in skel.layers[0].to_tree()


@pytest.mark.parametrize("preset", sorted(PUBLISHED))
def test_rope_tables_at_the_published_scaling(preset):
    """cos/sin [max_len, head_dim / 2] at the preset's head_dim, theta,
    max_len and llama3 scaling, within ROPE_ATOL of the reference's; the
    scaling moves the low frequencies (the unscaled table differs)."""
    cfg = getattr(tqwen.QwenConfig, preset)()
    args = (cfg.head_dim, cfg.max_len, cfg.rope_theta, cfg.rope_scaling)
    tc, ts = tlayers.rope_frequencies(*args)
    jc, js = jlayers.rope_frequencies(*args)
    assert tc.shape == (cfg.max_len, cfg.head_dim // 2) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ROPE_ATOL, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ROPE_ATOL, rtol=0)
    plain, _ = tlayers.rope_frequencies(*args[:3], None)
    assert not torch.allclose(plain, tc, atol=1e-3)
    assert torch.equal(plain[:, 0], tc[:, 0])  # the highest frequency is kept


# ---------------------------------------------------------------------------
# 2-layer decoders with the 8B's and the 1B's attention layout
# ---------------------------------------------------------------------------


def _layout(tied: bool) -> dict:
    """hidden 512, 2 layers, 4 query heads a kv head; the 8B's head_dim 128
    with an untied head, or the 1B's head_dim 64 with a tied one; llama3
    rope at theta 5e5 with the preset's scaling; a 1,024-row vocabulary."""
    base = tqwen.QwenConfig.llama32_1b() if tied else tqwen.QwenConfig.llama31_8b()
    hd = base.head_dim
    return dict(vocab_size=1024, hidden=512, layers=2, heads=512 // hd,
                kv_heads=512 // hd // 4, head_dim=hd, intermediate=1792,
                rope_theta=base.rope_theta, eps=base.eps, qkv_bias=False,
                tie_embeddings=tied, max_len=256, rope_scaling=base.rope_scaling)


# the layers' weights at this many times the init's std: at the init's
# scale the tied decoder echoes its prompt's last token at every step
LAYER_SCALE = 4.0


@pytest.fixture(scope="module")
def decoders():
    """Each layout drawn by the JAX package (f32; the layers' weights times
    LAYER_SCALE) and quantized by it, and the port's trees carried from
    both."""
    out = {}
    for tied in (False, True):
        kw = _layout(tied)
        jcfg, tcfg = jqwen.QwenConfig(**kw), tqwen.QwenConfig(**kw)
        jp = jax.jit(partial(jqwen.init_qwen_params, cfg=jcfg))(jax.random.key(11 + tied))
        jp = {**jp, "layers": [{k: v * LAYER_SCALE if k.endswith("_w") else v
                                for k, v in lp.items()} for lp in jp["layers"]]}
        jq = jqwen.quantize_qwen_params(jp)
        out[tied] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq,
                         tp=qwen_params_from_jax(jax.device_get(jp), tcfg),
                         tq=qwen_params_from_jax(jax.device_get(jq), tcfg))
    return out


def _prompts(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (3, 14)).astype(np.int32)
    mask = (np.arange(14)[None] < np.array([[14], [9], [2]])).astype(np.int32)
    return ids * mask, mask


def _gaps(params, cfg, ids, mask, n):
    """The port's eager greedy loop -> its tokens and the top-two logit gap
    of every step, [B, n] each."""
    b, t = ids.shape
    cache = tqwen.KVCache.zeros(cfg.layers, b, t + n, cfg.kv_heads, cfg.head_dim,
                                dtype=torch.float32)
    toks, gaps = [], []
    with torch.inference_mode():
        logits, _ = tqwen.qwen_prefill(params, cfg, ids, mask, cache)
        for i in range(n):
            top = logits.topk(2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
            if i < n - 1:
                logits, _ = tqwen.qwen_decode_step(params, cfg, toks[-1], cache)
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def _hold(name, got, ref, gaps):
    """Rows equal, or first differing at a step whose top two logits lie
    within NEAR_TIE (printed)."""
    ties = []
    for i, (a, r) in enumerate(zip(np.asarray(got).tolist(), np.asarray(ref).tolist())):
        if a == r:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, r)) if x != y)
        gap = float(gaps[i, j])
        assert gap <= NEAR_TIE, f"{name}: row {i} differs at step {j}, gap {gap:.3g}"
        ties.append((i, j, gap))
    print(f"{name}: near-ties {ties}")


def _jax_greedy_op_by_op(params, cfg, ids, mask, n):
    """The reference's prefill and decode steps called one by one outside
    jit (each op dispatched alone, the int8 scales divided as written),
    greedy's argmax between them -> [B, n]."""
    b, t = ids.shape
    cache = jlayers.KVCache.zeros(cfg.layers, b, t + n, cfg.kv_heads, cfg.head_dim,
                                  dtype=jnp.float32)
    logits, cache = jqwen.qwen_prefill(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                       cache)
    toks = []
    for i in range(n):
        toks.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
        if i < n - 1:
            logits, cache = jqwen.qwen_decode_step(params, cfg, toks[-1], cache)
    return np.stack([np.asarray(x) for x in toks], 1)


@pytest.mark.parametrize("tied", [False, True], ids=["8b_layout", "1b_layout"])
def test_decoder_f32_against_jax(decoders, tied):
    """f32: the prefill logits within 1e-4 of the reference's, and greedy
    tokens those of its jitted greedy_generate but for printed near-ties."""
    d = decoders[tied]
    jcfg, tcfg = d["jcfg"], d["tcfg"]
    ids, mask = _prompts(5, jcfg.vocab_size)
    jcache = jlayers.KVCache.zeros(jcfg.layers, 3, 24, jcfg.kv_heads, jcfg.head_dim,
                                   dtype=jnp.float32)
    jl, _ = jqwen.qwen_prefill(d["jp"], jcfg, jnp.asarray(ids), jnp.asarray(mask), jcache)
    tcache = tqwen.KVCache.zeros(tcfg.layers, 3, 24, tcfg.kv_heads, tcfg.head_dim,
                                 dtype=torch.float32)
    tid, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        tl, _ = tqwen.qwen_prefill(d["tp"], tcfg, tid, tmask, tcache)
    assert tl.shape == (3, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    n = 10
    jt = np.asarray(jax.jit(partial(jqwen.greedy_generate, cfg=jcfg, max_new_tokens=n))(
        d["jp"], input_ids=ids, attn_mask=mask))
    tt = tqwen.greedy_generate(d["tp"], tcfg, tid, tmask, n)
    _, gaps = _gaps(d["tp"], tcfg, tid, tmask, n)
    _hold(f"f32 tied={tied}", tt, jt, gaps)


@pytest.mark.parametrize("tied", [False, True], ids=["8b_layout", "1b_layout"])
def test_decoder_w8a8_against_jax_op_by_op(decoders, tied):
    """W8A8 (f32 activations): the int8 head's type and layout (untied: a
    QuantizedLinear [V, H]; tied: the QuantizedEmbed table), the prefill
    logits within W8A8_ATOL of the reference's run op by op, and greedy
    tokens its op-by-op loop's but for printed near-ties."""
    d = decoders[tied]
    jcfg, tcfg, tq = d["jcfg"], d["tcfg"], d["tq"]
    head = tq.embed if tied else tq.lm_head
    assert isinstance(head, tlayers.QuantizedEmbed if tied else tlayers.QuantizedLinear)
    assert head.q.shape == (jcfg.vocab_size, jcfg.hidden) and head.q.dtype == torch.int8
    ids, mask = _prompts(6, jcfg.vocab_size)
    n = 10
    jt = _jax_greedy_op_by_op(d["jq"], jcfg, ids, mask, n)
    tid, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    jcache = jlayers.KVCache.zeros(jcfg.layers, 3, 14 + n, jcfg.kv_heads, jcfg.head_dim,
                                   dtype=jnp.float32)
    jl, _ = jqwen.qwen_prefill(d["jq"], jcfg, jnp.asarray(ids), jnp.asarray(mask), jcache)
    tcache = tqwen.KVCache.zeros(tcfg.layers, 3, 14 + n, tcfg.kv_heads, tcfg.head_dim,
                                 dtype=torch.float32)
    with torch.inference_mode():
        tl, _ = tqwen.qwen_prefill(tq, tcfg, tid, tmask, tcache)
    print(f"w8a8 tied={tied}: prefill logits' largest difference a row",
          np.abs(tl.numpy() - np.asarray(jl)).max(axis=1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=W8A8_ATOL, rtol=0)
    eager, gaps = _gaps(tq, tcfg, tid, tmask, n)
    tt = tqwen.greedy_generate(tq, tcfg, tid, tmask, n)
    assert torch.equal(tt, eager)
    _hold(f"w8a8 tied={tied}", tt, jt, gaps)


# ---------------------------------------------------------------------------
# The LLM component: prompt, instruct flag, end-of-sequence token
# ---------------------------------------------------------------------------


def _loaded_pair(monkeypatch, name):
    """Both components loaded with no weights drawn: the reference's init
    returns an empty tree, the port's the meta skeleton (the load's prompt,
    tokenizer and eos come after the weights)."""
    monkeypatch.setattr(jcomp, "init_qwen_params", lambda key, cfg, dtype: {})
    monkeypatch.setattr(
        tcomp, "init_qwen_params",
        lambda cfg, **kw: tqwen.init_qwen_params(cfg, generator=None, device="meta"))
    ref = jcomp.LLMComponent(JSettings(llm_model=name, allow_random_weights=True))
    got = tcomp.LLMComponent(Settings(llm_model=name, device_platform="cpu"), CPU)
    ref.load()
    got.load()
    return ref, got


DOCS = [{"content": "alpha " * 60}, {"content": "beta"}, {"content": "gamma"},
        {"content": "delta"}]


@pytest.mark.parametrize("name", sorted(NAMES) + ["Qwen/Qwen2.5-0.5B-Instruct"])
def test_llm_component_prompt_and_eos_match_the_reference(monkeypatch, name):
    """Instruct Llama names take the Llama-3 header template and stop at
    <|eot_id|>; base names a plain completion prompt ending "Answer:" and
    <|end_of_text|> (tests/test_round4_fixes.py:143-180,
    tests/test_llama_family.py:256); the Qwen name the im_start template.
    Prompt text, the instruct flag and the eos token and id as the
    reference's."""
    ref, got = _loaded_pair(monkeypatch, name)
    try:
        assert got.is_instruct == ref.is_instruct == ("instruct" in name.lower())
        prompt = got.build_prompt("why?", DOCS)
        assert prompt == ref.build_prompt("why?", DOCS)
        assert got.tokenizer.eos_token == ref.tokenizer.eos_token
        assert got.tokenizer.eos_id == ref.tokenizer.eos_id
        llama = name.startswith("meta-llama")
        if got.is_instruct and llama:
            assert got.tokenizer.eos_token == "<|eot_id|>"
            assert prompt.startswith("<|begin_of_text|><|start_header_id|>system")
            assert prompt.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")
            assert "<|im_start|>" not in prompt
        elif llama:
            assert got.tokenizer.eos_token == "<|end_of_text|>"
            assert "<|start_header_id|>" not in prompt and prompt.endswith("Answer:")
        else:
            assert got.tokenizer.eos_token == "<|im_end|>" and "<|im_start|>" in prompt
    finally:
        ref.unload()


# ---------------------------------------------------------------------------
# The ladder clamp
# ---------------------------------------------------------------------------


@pytest.fixture()
def ledger():
    jhbm.reset()
    yield jhbm
    jhbm.reset()


LADDER = (1, 2, 4, 8, 16, 32, 64)


def _both_settings(budget_gb: float = 16.0):
    common = dict(truncate_length=512, max_tokens=64,
                  batch_shape_buckets=",".join(map(str, LADDER)))
    return JSettings(**common, hbm_budget_gb=budget_gb), Settings(**common)


@pytest.mark.parametrize("preset", ["llama31_8b", "llama32_1b", "qwen25_05b"])
@pytest.mark.parametrize("plen,slen", [(512, 576), (128, 256), (3968, 4096)])
def test_lane_bytes_equal_the_reference(preset, plen, slen):
    jcfg = getattr(jqwen.QwenConfig, preset)()
    tcfg = getattr(tqwen.QwenConfig, preset)()
    assert thbm.llm_lane_bytes(tcfg, plen, slen) == jhbm.llm_lane_bytes(jcfg, plen, slen)


def _reference_free(settings, param_bytes) -> int:
    """The free bytes the reference's clamp computes from its budget."""
    return (int(settings.hbm_budget_gb * 2**30) - int(0.75 * 2**30)
            - jhbm.reserved_bytes() - param_bytes)


@pytest.mark.parametrize("case", ["8b_int8_with_index", "05b_bf16", "8b_crowded", "8b_on_80gb"])
def test_ladder_clamp_matches_the_reference_at_the_same_free_bytes(ledger, case):
    """The reference's cases (tests/test_round4_fixes.py:62-100): 8B int8
    beside a 3.5 GB index and 1.3 GB of encoders on 16 GB clamps to <= 8
    lanes; 0.5B bf16 keeps 64; a crowded card keeps the smallest bucket;
    and the 8B int8 on an 80 GB card. The port, handed the free bytes the
    reference computes, gives its ladder."""
    model, quant, budget, reserved = {
        "8b_int8_with_index": ("llama31_8b", "int8", 16.0, (3.5, 1.3)),
        "05b_bf16": ("qwen25_05b", "none", 16.0, (3.5, 1.5)),
        "8b_crowded": ("llama31_8b", "int8", 16.0, (14.0,)),
        "8b_on_80gb": ("llama31_8b", "int8", 80.0, (3.5, 1.3)),
    }[case]
    jcfg, tcfg = getattr(jqwen.QwenConfig, model)(), getattr(tqwen.QwenConfig, model)()
    js, ts = _both_settings(budget)
    for i, gb in enumerate(reserved):
        jhbm.reserve(f"r{i}", int(gb * 2**30))
    pbytes = jhbm.llm_param_bytes(jcfg, quant)
    ladder = LADDER if case != "8b_crowded" else (4, 8, 16)
    want = jhbm.derive_llm_bucket_ladder(jcfg, js, pbytes, ladder)
    got = thbm.derive_llm_bucket_ladder(tcfg, ts, _reference_free(js, pbytes), ladder)
    assert got == want
    expect = {"8b_int8_with_index": lambda x: max(x) <= 8 and x[0] == 1,
              "05b_bf16": lambda x: x == LADDER, "8b_crowded": lambda x: x == (4,),
              "8b_on_80gb": lambda x: x == LADDER}[case]
    assert expect(got), got


def test_ladder_without_a_card_is_the_configured_one():
    _, ts = _both_settings()
    assert thbm.free_device_bytes(CPU) is None
    assert thbm.derive_llm_bucket_ladder(tqwen.QwenConfig.llama31_8b(), ts, None,
                                         LADDER) == LADDER


def test_free_device_bytes_adds_the_allocators_unused_cache(monkeypatch):
    """On a card: what it reports free plus what PyTorch's allocator holds
    reserved but unallocated there (faked: no card here)."""
    gb = 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (50 * gb, 80 * gb))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 12 * gb)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 9 * gb)
    assert thbm.free_device_bytes(torch.device("cuda", 0)) == 53 * gb


def test_llm_component_takes_the_clamped_ladder(monkeypatch):
    """With the free bytes of a crowded card (faked: 2.5 lanes of the 8B
    layout's cost), the loaded component's ladder is cut, and generation,
    warm-up and the engine's admission take it; without a card the
    configured ladder stays; /health reports it."""
    cfg = tqwen.QwenConfig.tiny()
    s = Settings(llm_model="tiny-qwen", device_platform="cpu", batch_shape_buckets="1,2,4,8",
                 generation_batch_size=8, max_tokens=4, truncate_length=64)
    plain = tcomp.LLMComponent(s, CPU)
    plain.load()
    assert plain.ladder == (1, 2, 4, 8)
    lane = thbm.llm_lane_bytes(cfg, 64, 68)
    monkeypatch.setattr(tcomp, "free_device_bytes", lambda dev: int(2.5 * lane / 0.85))
    comp = tcomp.LLMComponent(s, CPU)
    comp.load()
    assert comp.ladder == (1, 2)
    assert comp.dispatched_buckets() == (1, 2)
    seen = []
    monkeypatch.setattr(comp, "_decode", lambda ids, mask, n, max_new: (
        seen.append(ids.shape[0]) or ["x"] * n))
    assert comp.generate_batch(["q"] * 5, [[{"content": "d"}]] * 5) == ["x"] * 5
    assert seen == [2, 2, 1]
    # /health reports the LLM's ladder (a fused app over this LLM)
    ex = SimpleNamespace(settings=s, device=CPU, mesh=None, embedder=None, index=None,
                         llm=comp, sentiment=None, toxicity=None, is_loaded=True)
    assert runtime.FusedApp(ex).health()[1]["llm_ladder"] == [1, 2]


@pytest.mark.parametrize("dp,ladder,want", [(1, (1, 2), (1, 2)), (1, (1, 2, 4, 8, 16), (1, 2, 4, 8)),
                                            (2, (1, 2), (2,))])
def test_fused_executor_takes_the_llms_clamped_ladder(dp, ladder, want):
    """The fused executor pads chunks to the LLM's ladder, as /health
    reports it, not to the configured buckets the clamp cut: the buckets it
    dispatches and warms, and its largest chunk, stay within the ladder."""
    from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
    from rag_inference_pipeline_tpu_torch.engine.fused_executor import FusedExecutor

    s = Settings(fused_chunk_lanes=8, use_fused_pipeline=True)
    mesh = make_mesh(dp=dp, devices=force_host_devices(dp))
    ex = FusedExecutor(s, device=mesh.front, embedder=None, index=None,
                       llm=SimpleNamespace(ladder=ladder), mesh=mesh)
    assert ex.dispatched_buckets() == want
    assert ex._max_chunk() == max(want)


@pytest.mark.parametrize("store,llm", [("qwen", "meta-llama/Llama-3.1-8B-Instruct"),
                                       ("llama", "meta-llama/Llama-3.1-8B-Instruct"),
                                       ("qwen", "Qwen/Qwen2.5-0.5B-Instruct")])
def test_fused_executor_refuses_a_doc_store_of_another_vocabulary(tmp_path, store, llm):
    """A document token store tokenized for Qwen (151,936 ids) beside a
    Llama decoder (128,256): the step would embed ids past the decoder's
    table (on the card, a device-side assert that poisons the process's
    CUDA context), so the load refuses it by name; a store within the
    vocabulary gets past the check (to the index's, absent here)."""
    from rag_inference_pipeline_tpu_torch.engine.fused_executor import FusedExecutor

    vocab = {"qwen": 151936, "llama": 128256}[store]
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 1000, (16, 12)).astype(np.int32)
    toks[3, 5] = vocab - 1  # the store's last id
    path = tmp_path / "doc_tokens.npy"
    np.save(path, toks)
    s = Settings(llm_model=llm, doc_tokens_path=str(path), use_fused_pipeline=True)
    cfg = tcomp.LLMComponent(s, CPU).cfg
    ex = FusedExecutor(s, device=CPU, embedder=None, index=None,
                       llm=SimpleNamespace(cfg=cfg, ladder=s.shape_buckets))
    if vocab > cfg.vocab_size:
        with pytest.raises(ValueError, match="outside the vocabulary of "
                           "meta-llama/Llama-3.1-8B-Instruct .128256 ids."):
            ex.load()
        # what the check keeps the step from: an embedding past the table
        with pytest.raises(IndexError):
            torch.zeros(cfg.vocab_size, 2)[torch.from_numpy(toks).long()]
    else:
        with pytest.raises(ValueError, match="requires a loaded int8 flat index"):
            ex.load()


# ---------------------------------------------------------------------------
# The W8A8 route and plans at the Llama shapes (host arithmetic)
# ---------------------------------------------------------------------------

# (name, M, K, the N of each weight sharing x) of the 8B (H 4,096, kv 8 x
# 128, I 14,336, V 128,256; the engine's verify round: 32 lanes x 9) and
# the 1B (H 2,048, kv 8 x 64, I 8,192, a tied head)
LLAMA_PRODUCTS = [
    ("decode_qkv", 8, 4096, (4096, 1024, 1024)), ("decode_o", 8, 4096, (4096,)),
    ("decode_gate_up", 8, 4096, (14336, 14336)), ("decode_down", 8, 14336, (4096,)),
    ("decode_head", 8, 4096, (128256,)), ("decode_head_b1", 1, 4096, (128256,)),
    ("engine_down", 32, 14336, (4096,)), ("engine_qkv", 32, 4096, (4096, 1024, 1024)),
    ("engine_o", 32, 4096, (4096,)), ("engine_gate_up", 32, 4096, (14336, 14336)),
    ("engine_head", 32, 4096, (128256,)), ("verify_qkv", 72, 4096, (4096, 1024, 1024)), ("verify_o", 72, 4096, (4096,)),
    ("verify_gate_up", 72, 4096, (14336, 14336)), ("verify_down", 72, 14336, (4096,)),
    ("verify_head", 72, 4096, (128256,)),
    ("prefill_gate_up", 4096, 4096, (14336, 14336)), ("prefill_down", 4096, 14336, (4096,)),
    ("engine_verify_qkv", 288, 4096, (4096, 1024, 1024)),
    ("engine_verify_down", 288, 14336, (4096,)),
    ("1b_decode_head", 8, 2048, (128256,)),
    ("1b_decode_qkv", 8, 2048, (2048, 512, 512)), ("1b_decode_o", 8, 2048, (2048,)),
    ("1b_decode_gate_up", 8, 2048, (8192, 8192)), ("1b_decode_down", 8, 8192, (2048,)),
    ("1b_prefill_qkv", 4096, 2048, (2048, 512, 512)), ("1b_prefill_o", 4096, 2048, (2048,)),
    ("1b_prefill_gate_up", 4096, 2048, (8192, 8192)),
    ("1b_prefill_down", 4096, 8192, (2048,)),
    # the engine's step at 17 and 24 live lanes, and the 1B's at 32
    *((f"engine_{name}_m{m}", m, k, ns) for m in (17, 24)
      for name, k, ns in (("qkv", 4096, (4096, 1024, 1024)), ("o", 4096, (4096,)),
                          ("gate_up", 4096, (14336, 14336)), ("head", 4096, (128256,)))),
    ("1b_engine_gate_up", 32, 2048, (8192, 8192)), ("1b_engine_head", 32, 2048, (128256,)),
]
# route, then the small-row plan (mt, kc, depth, grid, cluster) or the
# wgmma plan (bm, bn, split, share, band, deep, blocks). From 17 rows (the
# engine's step) every product takes the wgmma route: q/k/v, o (and down)
# the few-row plan (128 weight rows by 32 token rows, K split over a
# cluster), gate/up and the head 64 x 128 tiles over all of K
LLAMA_PLANS = {
    "decode_qkv": ("qgemm", (8, 256, 2, 132, 2)),
    "decode_o": ("qgemm", (8, 256, 2, 132, 2)),
    "decode_gate_up": ("qgemm", (8, 256, 2, 132, 2)),
    "decode_down": ("qgemm", (8, 256, 2, 120, 8)),
    "decode_head": ("qgemm", (8, 256, 2, 132, 2)),
    "decode_head_b1": ("qgemm", (8, 256, 2, 132, 2)),
    "engine_down": ("wgmma", (32, 128, 3, 1, 32, True, 96)),
    **{f"engine_{name}{tag}": plan for tag in ("", "_m17", "_m24") for name, plan in (
        ("qkv", ("wgmma", (32, 128, 2, 1, 48, True, 96))),
        ("o", ("wgmma", (32, 128, 3, 1, 32, True, 96))),
        ("gate_up", ("wgmma", (64, 128, 1, 1, 224, False, 224))),
        ("head", ("wgmma", (64, 128, 1, 1, 1002, False, 1002))))},
    "1b_engine_gate_up": ("wgmma", (64, 128, 1, 1, 128, False, 128)),
    "1b_engine_head": ("wgmma", (64, 128, 1, 1, 1002, False, 1002)),
    "verify_qkv": ("wgmma", (80, 128, 2, 1, 48, True, 96)),
    "verify_o": ("wgmma", (80, 128, 3, 1, 32, True, 96)),
    "verify_gate_up": ("wgmma", (128, 128, 1, 1, 224, False, 224)),
    "verify_down": ("wgmma", (80, 128, 3, 1, 32, True, 96)),
    "verify_head": ("wgmma", (128, 128, 1, 1, 1002, False, 1002)),
    "prefill_gate_up": ("wgmma", (128, 128, 1, 2, 8, False, 7168)),
    "prefill_down": ("wgmma", (128, 128, 1, 2, 32, False, 1024)),
    "engine_verify_qkv": ("wgmma", (128, 128, 1, 3, 48, False, 144)),
    "engine_verify_down": ("wgmma", (128, 128, 1, 3, 32, True, 96)),
    "1b_decode_head": ("qgemm", (8, 256, 2, 132, 2)),
    "1b_decode_qkv": ("qgemm", (8, 512, 1, 132, 2)),
    "1b_decode_o": ("qgemm", (8, 512, 1, 132, 2)),
    "1b_decode_gate_up": ("qgemm", (8, 256, 2, 132, 2)),
    "1b_decode_down": ("qgemm", (8, 256, 2, 120, 8)),
    "1b_prefill_qkv": ("wgmma", (128, 128, 1, 1, 24, False, 768)),
    "1b_prefill_o": ("wgmma", (128, 128, 1, 1, 16, False, 512)),
    "1b_prefill_gate_up": ("wgmma", (128, 128, 1, 2, 8, False, 4096)),
    "1b_prefill_down": ("wgmma", (128, 128, 1, 2, 16, False, 512)),
}


@pytest.mark.parametrize("name,m,k,ns", LLAMA_PRODUCTS, ids=[p[0] for p in LLAMA_PRODUCTS])
def test_w8a8_route_and_plan_at_llama_shapes(name, m, k, ns):
    """Every 8B product has a kernel: K = 14,336 leaves the small-row
    kernel an 8-row m tile only (a quantized row takes 14 KB of a block's
    shared memory), so from 9 rows down takes the wgmma route below M*,
    as every product does from 17 rows (past M*); the plans are
    pinned for an H100's 132 SMs, and each small-row plan's shared memory
    fits a block."""
    route, plan = LLAMA_PLANS[name]
    assert w8a8._route(m, k, True) == route
    if route == "qgemm":
        got = w8a8._qgemm_plan(m, k, ns, H100_SMS)
        assert w8a8._qgemm_plan_smem(m, k, ns, got) <= w8a8._BLOCK_SMEM
    else:
        got = w8a8._gemm_plan(m, k, ns, H100_SMS)
    assert got == plan


@pytest.mark.parametrize("m,want", [(1, 8), (8, 8), (9, None), (16, None), (32, None)])
def test_small_row_tile_at_the_8b_down(m, want):
    assert w8a8._qgemm_rows(m, 14336) == want
    assert w8a8._route(m, 14336, True) == ("qgemm" if want else "wgmma")


def test_8b_down_with_unaligned_weights_is_refused_by_name():
    """Off the 16-byte alignment the wgmma route needs, 9 to 32 rows of the
    8B's down have no kernel: the route raises, never the plain version."""
    assert w8a8._route(8, 14336, False) == "qgemm"
    with pytest.raises(ValueError, match="no kernel takes K = 14336"):
        w8a8._route(16, 14336, False)
