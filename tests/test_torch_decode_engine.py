"""The port's continuous-batching decode engine on the CPU: every sequence
equals solo greedy decoding (interleaving lanes must not change any
tokens), plain and speculative, pipelined and not; the engine's outputs
equal the JAX package's engine on the same weights; and the engine serves
the staged path (`GenerationService.process_batch_async`, the
orchestrator's engine branch, `StagedApp`'s start and stop).

Tiny decoder, vocabulary widened to 1024 on both sides, float32. `echo`
keeps the init scale, where the decoder repeats the last token and
speculation accepts whole windows; `varied` scales the layer weights by
20, so the tokens vary and drafts are mostly rejected."""

import asyncio
import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.engine.decode_engine import DecodeEngine as JEngine
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
from rag_inference_pipeline_tpu_torch.engine.orchestrator import Orchestrator
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.weights import qwen_params_from_jax
from rag_inference_pipeline_tpu_torch.serve.services import GenerationService

JCFG = dataclasses.replace(jqwen.QwenConfig.tiny(), vocab_size=1024)
TCFG = dataclasses.replace(tqwen.QwenConfig.tiny(), vocab_size=1024)
EOS = TCFG.vocab_size - 1  # rarely emitted by these decoders


def _pair(scale: float):
    jp = jax.jit(partial(jqwen.init_qwen_params, cfg=JCFG))(jax.random.key(0))
    if scale != 1.0:
        for lp in jp["layers"]:
            for key in [k for k in lp if k.endswith("_w")]:
                lp[key] = scale * lp[key]
    return jp, qwen_params_from_jax(jax.device_get(jp), TCFG)


@pytest.fixture(scope="module")
def models():
    return {"echo": _pair(1.0), "varied": _pair(20.0)}


def solo(tp, prompt: np.ndarray, max_new: int, eos: int = EOS) -> list[int]:
    ids = torch.from_numpy(prompt[None].astype(np.int32))
    out = tqwen.greedy_generate(tp, TCFG, ids, torch.ones_like(ids), max_new,
                                eos_token_id=eos,
                                cache_len=len(prompt) + max_new)[0].tolist()
    return out[: out.index(eos)] if eos in out else out


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


MODES = {
    "plain": {},
    "spec": dict(speculative=True, gamma=4, spec_rounds=2),
}


def engine(tp, mode="plain", lanes=3, cache_len=64, segment_steps=4, **kw):
    kw = {**MODES[mode], **kw}
    kw.setdefault("admit_buckets", (1, 2, 4))
    kw.setdefault("prefill_buckets", (8, 16))
    return DecodeEngine(tp, TCFG, lanes=lanes, cache_len=cache_len,
                        segment_steps=segment_steps, eos_token_id=kw.pop("eos", EOS),
                        **kw)


def serve(eng, jobs, delays=None):
    """Submit (prompt, max_new) jobs, optionally each after a delay."""
    async def main():
        await eng.start()
        try:
            async def one(i):
                if delays is not None:
                    await asyncio.sleep(delays[i])
                return await eng.submit(*jobs[i])

            return await asyncio.gather(*(one(i) for i in range(len(jobs))))
        finally:
            await eng.stop()

    return run(main())


def _prompts(rng, lengths, hi=TCFG.vocab_size - 1):
    return [rng.integers(1, hi, int(n)).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("mode", ["plain", "spec"])
@pytest.mark.parametrize("weights", ["echo", "varied"])
class TestMatchesSolo:
    def test_single(self, models, mode, weights):
        tp = models[weights][1]
        (p,) = _prompts(np.random.default_rng(1), [7])
        assert serve(engine(tp, mode), [(p, 10)]) == [solo(tp, p, 10)]

    def test_concurrent_with_queueing(self, models, mode, weights):
        """More requests than lanes, mixed prompt lengths and budgets."""
        tp = models[weights][1]
        prompts = _prompts(np.random.default_rng(2), (3, 5, 7, 4, 6, 8))
        max_new = [6, 10, 4, 8, 5, 7]
        outs = serve(engine(tp, mode, lanes=2), list(zip(prompts, max_new)))
        for p, m, o in zip(prompts, max_new, outs):
            assert o == solo(tp, p, m), f"prompt of {len(p)} diverged"

    def test_staggered_admission(self, models, mode, weights):
        """A late request joins while an early one is mid-decode."""
        tp = models[weights][1]
        p1, p2 = _prompts(np.random.default_rng(3), (5, 6))
        o1, o2 = serve(engine(tp, mode, lanes=2, segment_steps=2),
                       [(p1, 12), (p2, 6)], delays=[0.0, 0.05])
        assert o1 == solo(tp, p1, 12) and o2 == solo(tp, p2, 6)

    def test_cache_boundary(self, models, mode, weights):
        """A generation up to the cache's end: the plain segment's last
        write overruns by up to steps - 1 columns (the buffer's headroom);
        the speculative guard may stop up to a window early, never later."""
        tp = models[weights][1]
        (p,) = _prompts(np.random.default_rng(4), [3])
        (out,) = serve(engine(tp, mode, lanes=2, cache_len=32, segment_steps=8),
                       [(p, 28)])
        ref = solo(tp, p, 28)
        if mode == "plain":
            assert out == ref
        else:
            assert out == ref[: len(out)] and len(out) >= 28 - 5

    def test_pipelined_lagged_completion_still_exact(self, models, mode, weights):
        """Completions read one segment late from the snapshot ring while
        the next segment rewrites the buffers: no overrun tokens, no
        tokens of the segment that follows."""
        tp = models[weights][1]
        prompts = _prompts(np.random.default_rng(5), (6, 6, 6, 6))
        eng = engine(tp, mode, lanes=2, cache_len=48, segment_steps=8,
                     admit_buckets=(1, 2), prefill_buckets=(8,),
                     pipeline_segments=True)
        outs = serve(eng, [(p, 5) for p in prompts])
        for p, o in zip(prompts, outs):
            assert o == solo(tp, p, 5)
        assert eng.segments >= 2 and eng.lanes_active == 0
        assert eng.tokens_generated == sum(len(o) for o in outs)


@pytest.mark.parametrize("mode,pipelined", [("plain", True), ("plain", False),
                                            ("spec", True)])
def test_storm_of_submits_matches_solo(models, mode, pipelined):
    """Many more requests than lanes, submit times racing segment
    boundaries, eos = a token the decoder emits often."""
    tp = models["varied"][1]
    rng = np.random.default_rng(6)
    prompts = _prompts(rng, rng.integers(4, 14, 13))
    max_news = [int(rng.integers(1, 12)) for _ in prompts]
    probe = np.concatenate([solo(tp, p, m, eos=-1) for p, m in zip(prompts, max_news)])
    eos = int(np.bincount(probe).argmax())
    eng = engine(tp, mode, admit_buckets=(1, 2), pipeline_segments=pipelined, eos=eos)
    outs = serve(eng, list(zip(prompts, max_news)),
                 delays=[float(x) * 0.03 for x in rng.random(len(prompts))])
    refs = [solo(tp, p, m, eos=eos) for p, m in zip(prompts, max_news)]
    assert outs == refs
    assert any(len(r) < m for r, m in zip(refs, max_news))  # eos ended some


@pytest.mark.parametrize("mode", ["plain", "spec"])
def test_engine_matches_jax_engine(models, mode):
    """The same requests through both packages' engines, same weights."""
    jp, tp = models["varied"]
    prompts = _prompts(np.random.default_rng(7), (3, 6, 8, 5, 7))
    max_new = [6, 12, 4, 9, 7]
    kw = dict(lanes=2, cache_len=64, segment_steps=3, eos_token_id=EOS,
              admit_buckets=(1, 2), prefill_buckets=(8, 16), **MODES[mode])
    want = serve(JEngine(jp, JCFG, **kw), list(zip(prompts, max_new)))
    got = serve(DecodeEngine(tp, TCFG, **kw), list(zip(prompts, max_new)))
    assert got == want


def test_positions_past_the_rope_table_clamp_as_the_reference(models):
    """A finished engine lane keeps counting positions, past the rope
    table's max_len; the reference's gather clamps there (the port's
    indexing raised). One decode step at [max_len + 5, 3] and one extend
    window over the table's end, against the JAX package."""
    import jax.numpy as jnp

    from rag_inference_pipeline_tpu.models import layers as jlayers

    jp, tp = models["echo"]
    rng = np.random.default_rng(12)
    s = 8
    shape = (TCFG.layers, 2, s, TCFG.kv_heads, TCFG.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for fn, toks, lengths in (
        ("qwen_decode_step", np.array([5, 9], np.int32), [TCFG.max_len + 5, 3]),
        ("qwen_extend", np.array([[5, 9, 11], [1, 2, 3]], np.int32), [TCFG.max_len - 1, 2]),
    ):
        length = np.asarray(lengths, np.int32)
        jl, jc = jax.jit(partial(getattr(jqwen, fn), cfg=JCFG))(
            jp, tokens=toks, cache=jlayers.KVCache(
                k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(length)))
        with torch.inference_mode():
            tl, tc = getattr(tqwen, fn)(
                tp, TCFG, torch.from_numpy(toks), tqwen.KVCache(
                    torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
                    torch.from_numpy(length.copy())))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5, rtol=0)


def test_invalid_max_new_rejected_and_stop_drains(models):
    tp = models["varied"][1]
    (p,) = _prompts(np.random.default_rng(8), [4])
    eng = engine(tp, cache_len=32)

    async def main():
        await eng.start()
        for bad in (31, 0):  # past cache_len - 2; empty
            with pytest.raises(ValueError, match="max_new_tokens"):
                await eng.submit(p, bad)
        out = await eng.submit(p, 4)  # still serving
        await eng.stop()
        return out

    assert run(main()) == solo(tp, p, 4)
    assert eng.active_lanes == 0


def test_inject_mode_respects_limits(models):
    """Benchmark-only acceptance injection: commits grow, counts never pass
    max_new, every request resolves."""
    tp = models["varied"][1]
    prompts = _prompts(np.random.default_rng(9), (6, 6, 6, 6))
    eng = engine(tp, "spec", lanes=2, gamma=8, inject_accept_p=0.9)
    for out in serve(eng, [(p, 10) for p in prompts]):
        assert 0 < len(out) <= 10


# ---------------------------------------------------------------------------
# The staged path with the engine
# ---------------------------------------------------------------------------

_TINY = dict(llm_model="tiny-llm", max_tokens=6, truncate_length=64,
             batch_shape_buckets="1,2,4", prefill_buckets="32,64",
             kv_cache_max_len=128, decode_max_concurrency=4,
             decode_segment_steps=4, device_platform="cpu", model_weights_dir="")


def _llm(models, monkeypatch, **over):
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(lambda: TCFG))
    comp = tcomp.LLMComponent(Settings(**{**_TINY, **over}), torch.device("cpu"))
    comp.load()
    comp.params = models["varied"][1]
    return comp


_QUERIES = ["what is a kernel?", "how do lanes work", "tell me about gpus"]
_DOCS = [[{"content": "a kernel runs on the card"}], [],
         [{"content": "gpus multiply matrices"}, {"content": "fast memory"}]]


@pytest.mark.parametrize("spec", [False, True])
def test_component_engine_matches_batch_path(models, monkeypatch, spec):
    """`generate_batch_engine` through the started engine gives the batch
    path's answers (greedy, or speculation on both sides)."""
    comp = _llm(models, monkeypatch, use_continuous_batching=True,
                use_speculative_decoding=spec, speculative_gamma=4)

    async def main():
        await comp.start()
        try:
            assert comp.engine is not None and comp.engine.speculative == spec
            return await comp.generate_batch_engine(_QUERIES, _DOCS)
        finally:
            await comp.stop()

    assert run(main()) == comp.generate_batch(_QUERIES, _DOCS)
    assert comp.engine is None


def test_services_and_orchestrator_take_the_engine_branch(models, monkeypatch):
    """With USE_CONTINUOUS_BATCHING the orchestrator hands generation to
    `process_batch_async`, which submits to the engine and answers as the
    batch path does; with the engine not running it raises rather than
    falling back to the batch path."""
    settings = Settings(**_TINY, use_continuous_batching=True)
    comp = _llm(models, monkeypatch, use_continuous_batching=True)
    svc = GenerationService(settings, llm=comp)
    items = [{"query": q, "documents": d} for q, d in zip(_QUERIES, _DOCS)]

    class Retrieval:
        def process_batch(self, payload):
            return [{"documents": d} for d in _DOCS[: len(payload)]]

    async def main():
        with pytest.raises(RuntimeError, match="not running"):
            await svc.process_batch_async(items)
        await comp.start()
        orch = Orchestrator(settings, retrieval_executor=Retrieval(),
                            generation_service=svc)
        calls = []
        real = svc.process_batch_async

        async def spy(payload):
            calls.append(len(payload))
            return await real(payload)

        svc.process_batch_async = spy
        try:
            direct = await real(items)
            via = await orch._do_generation([{"query": q} for q in _QUERIES],
                                            [{"documents": d} for d in _DOCS])
        finally:
            await comp.stop()
        return direct, via, calls

    direct, via, calls = run(main())
    assert direct == svc.process_batch(items) == via
    assert calls == [len(_QUERIES)]
