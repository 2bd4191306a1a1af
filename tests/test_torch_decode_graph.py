"""The decode loops as CUDA graphs (`models/decode_graph.py`), without the
JAX package: on the CPU nothing is captured; on a card the replayed graphs
give the eager loops' tokens bit for bit (greedy, a speculative verify
round, one engine segment of each kind), the engine's snapshot ring
returns exact tokens with pipelining on, a capture that fails raises, and
the decode probe counts only the K7 launches that really ran.
This file imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_graph.py
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
from rag_inference_pipeline_tpu_torch.models import decode_graph
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen

CFG = dataclasses.replace(tqwen.QwenConfig.tiny(), vocab_size=1024)
EOS = CFG.vocab_size - 1


def _params(device, dtype=torch.float32, scale=20.0):
    """Tiny decoder, seeded; layer weights scaled so the tokens vary."""
    g = torch.Generator(device=device).manual_seed(0)
    params = tqwen.init_qwen_params(CFG, generator=g, dtype=dtype, device=device)
    with torch.no_grad():
        for lp in params.layers:
            for name, w in lp.named_parameters():
                if name.endswith("_w"):
                    w.mul_(scale)
    return params


def _batch(device, b=3, t=12, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG.vocab_size - 1, (b, t)).astype(np.int32)
    lens = rng.integers(3, t + 1, b)
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    return (torch.from_numpy(ids * mask).to(device), torch.from_numpy(mask).to(device))


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured on the card only")
    return torch.device("cuda")


def _serve(eng, jobs):
    async def main():
        await eng.start()
        try:
            return await asyncio.gather(*(eng.submit(p, m) for p, m in jobs))
        finally:
            await eng.stop()

    return asyncio.new_event_loop().run_until_complete(main())


def test_cpu_captures_nothing():
    """On the CPU the loops run eagerly: the tree's graph cache stays
    empty, and the dispatching functions give the eager ones' tokens."""
    cpu = torch.device("cpu")
    params = _params(cpu)
    ids, mask = _batch(cpu)
    g = tqwen.greedy_generate(params, CFG, ids, mask, 6, eos_token_id=EOS)
    assert torch.equal(g, tqwen.greedy_generate_eager(params, CFG, ids, mask, 6,
                                                      eos_token_id=EOS))
    s, mean = tqwen.ngram_speculative_generate(params, CFG, ids, mask, 6, gamma=3)
    se, mean_e = tqwen.ngram_speculative_generate_eager(params, CFG, ids, mask, 6,
                                                        gamma=3)
    assert torch.equal(s, se) and float(mean) == float(mean_e)
    assert len(decode_graph.graphs_of(params)) == 0
    assert DecodeEngine(params, CFG, lanes=2, cache_len=32).graph is None


def test_graph_cache_is_per_tree_and_builds_once():
    a, b = _params(torch.device("cpu")), _params(torch.device("cpu"))
    ca = decode_graph.graphs_of(a)
    assert ca is decode_graph.graphs_of(a) and ca is not decode_graph.graphs_of(b)
    built = []
    for _ in range(3):
        ca.get(("k", 1), lambda: built.append(1) or "entry")
    assert built == [1] and len(ca) == 1


class _EagerCapture:
    """Stands in for a CUDA graph on the CPU: the body runs once when built
    (as the real capture's warm-up does) and again on each replay."""

    def __init__(self, body, device, pool=None):
        body()
        self.body = body
        self.pool_bytes, self.capture_s = 0, 0.0

    def replay(self):
        self.body()


@pytest.fixture()
def graph_paths_on_cpu(monkeypatch):
    """The CUDA code paths (static state, reuse by key, the host-read loop
    condition, the engine's warm-up and reset) on the CPU."""
    monkeypatch.setattr(decode_graph, "uses_graphs", lambda device: True)
    monkeypatch.setattr(decode_graph, "CapturedGraph", _EagerCapture)
    monkeypatch.setattr(decode_graph.GraphCache, "pool", lambda self: None)


def test_graph_paths_reuse_state_across_calls(graph_paths_on_cpu):
    """Three calls of one key reuse one entry's static buffers and give the
    eager functions' tokens and mean commits every time."""
    cpu = torch.device("cpu")
    params = _params(cpu)
    for seed in (1, 2, 3):
        ids, mask = _batch(cpu, seed=seed)
        got = tqwen.greedy_generate(params, CFG, ids, mask, 7, eos_token_id=EOS)
        assert torch.equal(got, tqwen.greedy_generate_eager(
            params, CFG, ids, mask, 7, eos_token_id=EOS))
        s, mean = tqwen.ngram_speculative_generate(params, CFG, ids, mask, 7, gamma=3)
        se, mean_e = tqwen.ngram_speculative_generate_eager(params, CFG, ids, mask, 7,
                                                            gamma=3)
        assert torch.equal(s, se) and float(mean) == float(mean_e)
    assert len(decode_graph.graphs_of(params)) == 2


@pytest.mark.parametrize("spec", [False, True])
def test_engine_captured_segments_match_solo(graph_paths_on_cpu, spec):
    """The engine's capture-time warm-up mutates its state; the reset after
    it leaves every lane free, and the replayed segments give solo greedy's
    tokens."""
    cpu = torch.device("cpu")
    params = _params(cpu)
    eng = DecodeEngine(params, CFG, lanes=2, cache_len=48, segment_steps=3,
                       eos_token_id=EOS, admit_buckets=(1, 2),
                       prefill_buckets=(8, 16), speculative=spec, gamma=4)
    assert isinstance(eng.graph, _EagerCapture)
    assert bool(eng.done.all()) and not eng.cache.length.any()
    rng = np.random.default_rng(6)
    jobs = [(rng.integers(1, CFG.vocab_size - 1, int(n)).astype(np.int32), int(m))
            for n, m in zip((6, 9, 4, 12), (5, 11, 3, 8))]
    for (p, m), out in zip(jobs, _serve(eng, jobs)):
        ids = torch.from_numpy(p[None])
        ref = tqwen.greedy_generate_eager(params, CFG, ids, torch.ones_like(ids), m,
                                          eos_token_id=EOS)[0].tolist()
        assert out == (ref[: ref.index(EOS)] if EOS in ref else ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_graph_matches_eager(dtype):
    """Bit-identical tokens: the graph replays the eager step's kernels on
    the same shapes. A second call of the same key reuses the graph and
    its static buffers with other inputs."""
    dev = _cuda()
    params = _params(dev, dtype)
    for seed in (1, 2):
        ids, mask = _batch(dev, seed=seed)
        got = tqwen.greedy_generate(params, CFG, ids, mask, 10, eos_token_id=EOS)
        want = tqwen.greedy_generate_eager(params, CFG, ids, mask, 10, eos_token_id=EOS)
        assert torch.equal(got, want)
    cache = decode_graph.graphs_of(params)
    assert len(cache) == 1 and cache.pool_bytes >= 0 and cache.capture_s > 0


def _w8a8_counts(rows: int, head_rows: int) -> tuple[int, int, int]:
    """(small-row, wgmma, quantize) launches of one forward pass of the tiny
    decoder over `rows` token rows whose head sees `head_rows`, by the
    route rule: a product of the small-row route is one launch a group
    (q/k/v, o, gate/up, down); one of the wgmma route quantizes once and
    launches one GEMM for the group."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    small = wgmma = quant = 0
    products = [(rows, CFG.hidden), (rows, CFG.heads * CFG.head_dim),
                (rows, CFG.hidden), (rows, CFG.intermediate)] * CFG.layers
    for m, k in products + [(head_rows, CFG.hidden)]:
        if w8a8._route(m, k, True) == "wgmma":
            wgmma, quant = wgmma + 1, quant + 1
        else:
            small += 1
    return small, wgmma, quant


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_greedy_graph_matches_eager(dtype):
    """W8A8 weights: the step graph replays the W8A8 kernels the eager step
    launches, tokens bit for bit; the wrappers count the eager launches
    (prefill, the capture's warm-up), none of the replays, route by route.
    Prefill takes the small-row route at 2 x 12 rows and the wgmma route at
    8 x 12, one GEMM launch a group; a step (2 or 8 rows) and the head the
    small-row route."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    dev = _cuda()
    params = tqwen.quantize_qwen_params(_params(dev, dtype))
    for b in (2, 8):
        ids, mask = _batch(dev, b=b, seed=6)
        w8a8.w8a8_qgemm.launches = w8a8.w8a8_gemm.launches = 0
        w8a8.quantize_rows.launches = 0
        got = tqwen.greedy_generate(params, CFG, ids, mask, 10, eos_token_id=EOS)
        # prefill and the warm-up step before the capture, none of 9 replays
        want = [p + s for p, s in zip(_w8a8_counts(b * ids.shape[1], b),
                                      _w8a8_counts(b, b))]
        assert [w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
                w8a8.quantize_rows.launches] == want
        assert want[1] == (4 * CFG.layers if b == 8 else 0)
        eager = tqwen.greedy_generate_eager(params, CFG, ids, mask, 10, eos_token_id=EOS)
        assert torch.equal(got, eager)
    assert len(decode_graph.graphs_of(params)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [None, 0.8])
def test_speculative_graph_matches_eager(inject):
    """The verify round replayed as a graph, its loop condition read on the
    host between rounds: the eager loop's tokens and mean commits."""
    dev = _cuda()
    params = _params(dev, scale=1.0 if inject is None else 20.0)
    ids, mask = _batch(dev, seed=3)
    ids[0, -6:] = 7  # a run the echoing decoder accepts in whole windows
    mask[0] = 1
    kw = dict(gamma=4, eos_token_id=EOS, inject_accept_p=inject)
    got, mean = tqwen.ngram_speculative_generate(params, CFG, ids, mask, 12, **kw)
    want, mean_e = tqwen.ngram_speculative_generate_eager(params, CFG, ids, mask, 12, **kw)
    assert torch.equal(got, want) and float(mean) == float(mean_e)
    if inject is None:
        assert torch.equal(got, tqwen.greedy_generate(params, CFG, ids, mask, 12,
                                                      eos_token_id=EOS))


@pytest.mark.cuda
def test_int8_speculation_and_engine_match_greedy():
    """Over W8A8 weights on the card: the speculative verify-round graph
    gives the eager loop's tokens and greedy's; the engine (its segment a
    graph) gives every request's solo greedy tokens."""
    dev = _cuda()
    params = tqwen.quantize_qwen_params(_params(dev, scale=1.0))
    ids, mask = _batch(dev, seed=7)
    ids[0, -6:] = 7
    mask[0] = 1
    kw = dict(gamma=4, eos_token_id=EOS)
    got, mean = tqwen.ngram_speculative_generate(params, CFG, ids, mask, 12, **kw)
    want, mean_e = tqwen.ngram_speculative_generate_eager(params, CFG, ids, mask, 12, **kw)
    assert torch.equal(got, want) and float(mean) == float(mean_e)
    assert torch.equal(got, tqwen.greedy_generate(params, CFG, ids, mask, 12,
                                                  eos_token_id=EOS))
    rng = np.random.default_rng(8)
    jobs = [(rng.integers(1, CFG.vocab_size - 1, n).astype(np.int32), m)
            for n, m in ((6, 9), (11, 4), (3, 12))]
    eng = DecodeEngine(params, CFG, lanes=4, cache_len=64, segment_steps=4,
                       eos_token_id=EOS, admit_buckets=(1, 2, 4), prefill_buckets=(8, 16))
    for (p, m), out in zip(jobs, _serve(eng, jobs)):
        t = torch.from_numpy(p[None]).to(dev)
        ref = tqwen.greedy_generate(params, CFG, t, torch.ones_like(t), m,
                                    eos_token_id=EOS)[0]
        assert list(out) == ref[: len(out)].tolist() and len(out) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_engine_segment_graph_matches_eager(spec):
    """One segment replayed as the engine's graph against the same body run
    eagerly from the same state: every state tensor bit for bit."""
    dev = _cuda()
    params = _params(dev)
    eng = DecodeEngine(params, CFG, lanes=4, cache_len=64, segment_steps=4,
                       eos_token_id=EOS, admit_buckets=(1, 2, 4),
                       prefill_buckets=(8, 16), speculative=spec, gamma=4)
    assert eng.graph is not None
    rng = np.random.default_rng(4)
    ids = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.int32)
    reqs = []
    for j, n in enumerate((5, 9, 16)):
        ids[j, :n] = rng.integers(1, CFG.vocab_size - 1, n)
        mask[j, :n] = 1
        reqs.append(type("R", (), {"lane": j, "max_new_tokens": 20})())
    mask[3, 0] = ids[3, 0] = 1
    with torch.inference_mode():
        eng._admit(ids, mask, reqs)
    state = [eng.cache.k, eng.cache.v, eng.cache.length, eng.tokens, eng.done,
             eng.emit_buf, eng.counts, eng.limits]
    before = [t.clone() for t in state]
    eng.graph.replay()
    replayed = [t.clone() for t in state]
    with torch.inference_mode():
        for t, b in zip(state, before):
            t.copy_(b)
        eng._segment_body()
    torch.cuda.synchronize()
    for got, want in zip(replayed, state):
        assert torch.equal(got, want)
    assert not torch.equal(replayed[5], before[5])  # it emitted tokens


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True])
def test_engine_snapshot_ring_exact_when_pipelined(spec):
    """Completions read from the ring one segment late, while the next
    segment rewrites done, counts and the emission buffer: the tokens of
    the unpipelined engine, and of solo greedy decoding."""
    dev = _cuda()
    params = _params(dev)
    rng = np.random.default_rng(5)
    jobs = [(rng.integers(1, CFG.vocab_size - 1, int(n)).astype(np.int32), int(m))
            for n, m in zip((6, 9, 4, 12, 7, 5), (5, 11, 3, 8, 9, 2))]
    outs = []
    for pipelined in (True, False):
        eng = DecodeEngine(params, CFG, lanes=2, cache_len=48, segment_steps=3,
                           eos_token_id=EOS, admit_buckets=(1, 2),
                           prefill_buckets=(8, 16), pipeline_segments=pipelined,
                           speculative=spec, gamma=4)
        outs.append(_serve(eng, jobs))
    assert outs[0] == outs[1]
    for (p, m), out in zip(jobs, outs[0]):
        ids = torch.from_numpy(p[None]).to(dev)
        ref = tqwen.greedy_generate(params, CFG, ids, torch.ones_like(ids), m,
                                    eos_token_id=EOS)[0].tolist()
        assert out == (ref[: ref.index(EOS)] if EOS in ref else ref)


@pytest.mark.cuda
def test_capture_failure_raises(monkeypatch):
    """A body that syncs the host cannot be captured: the capture raises,
    and greedy_generate raises with it instead of running eagerly."""
    dev = _cuda()
    x = torch.ones(2, device=dev)
    with pytest.raises(RuntimeError, match="capture failed"):
        decode_graph.CapturedGraph(lambda: x.add_(float(x.sum().item())), dev)
    params = _params(dev)
    step = tqwen._greedy_step

    def syncing_step(params, cfg, st, eos):
        step(params, cfg, st, eos)
        st.tok.add_(int(st.tok.sum().item()) * 0)

    monkeypatch.setattr(tqwen, "_greedy_step", syncing_step)
    ids, mask = _batch(dev)
    with pytest.raises(RuntimeError, match="capture failed"):
        tqwen.greedy_generate(params, CFG, ids, mask, 4, eos_token_id=EOS)


@pytest.mark.cuda
def test_probe_counts_only_real_k7_launches():
    """The decode probe's `kernel` variant, eager and as a graph: the K7
    pair's count holds the wrapper's real launches only (the eager calls
    and the capture's warm-up; a capture records, its replays bypass the
    wrapper), and one replay runs layers x length K7 launches by the
    device's trace."""
    dev = _cuda()
    from rag_inference_pipeline_tpu_torch.ops import kv
    from rag_inference_pipeline_tpu_torch.tools import bench_decode_anatomy as anatomy

    params = _params(dev)
    length, reps, batches = 3, 1, (2, 3)
    k7: dict = {}
    before = kv.kv_row_insert_pair.launches
    with torch.inference_mode():
        anatomy.probe(params, CFG, batches, length, reps, cache_len=32, t_prompt=8,
                      graphs=True, k7_graph=k7)
    eager_calls = 1 + reps + 1
    assert kv.kv_row_insert_pair.launches - before == (
        CFG.layers * length * eager_calls * len(batches))
    assert k7 == {b: CFG.layers * length for b in batches}
