"""The Llama family's shapes on the card: every W8A8 kernel at the
Llama-3.1-8B's and the Llama-3.2-1B's products against its plain twin, bit
for bit, on the route `ops/w8a8.py::_route` gives them, and the decode
graphs against the eager loops on a 2-layer decoder at the 8B's full
widths (hidden 4,096, 32 x 128 query and 8 kv heads, MLP 14,336, an untied
128,256-row head), bf16 and W8A8. Imports no jax; needs a CUDA card
(skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_llama_card.py
"""

import dataclasses

import pytest
import torch

from rag_inference_pipeline_tpu_torch.models import decode_graph
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.ops import w8a8

# (name, M, K, the N of each weight sharing x): the 8B's decode step at 8
# and 1 lanes, its engine's 32 (its head's ring one stage deep; and 17
# rows: an m tile of 32 half full) and the engine's verify round (32 x 9
# rows), a verify round's 72 rows (B 8, gamma 8), a prefill of 8 x 512
# tokens; the 1B's decode step at 8 lanes, its prefill and its tied head
LLAMA_PRODUCTS = [
    ("decode_qkv", 8, 4096, (4096, 1024, 1024)), ("decode_o", 8, 4096, (4096,)),
    ("decode_gate_up", 8, 4096, (14336, 14336)), ("decode_down", 8, 14336, (4096,)),
    ("decode_head", 8, 4096, (128256,)), ("decode_head_b1", 1, 4096, (128256,)),
    ("decode_down_b1", 1, 14336, (4096,)), ("engine_qkv", 32, 4096, (4096, 1024, 1024)),
    ("engine_o", 32, 4096, (4096,)), ("engine_gate_up", 32, 4096, (14336, 14336)),
    ("engine_head", 32, 4096, (128256,)), ("decode_qkv_b1", 1, 4096, (4096, 1024, 1024)), ("decode_o_b1", 1, 4096, (4096,)),
    ("decode_gate_up_b1", 1, 4096, (14336, 14336)), ("engine_qkv_m17", 17, 4096, (4096,)),
    ("engine_down", 32, 14336, (4096,)), ("verify_qkv", 72, 4096, (4096, 1024, 1024)),
    ("verify_o", 72, 4096, (4096,)), ("verify_gate_up", 72, 4096, (14336, 14336)),
    ("verify_down", 72, 14336, (4096,)), ("verify_head", 72, 4096, (128256,)),
    ("prefill_qkv", 4096, 4096, (4096, 1024, 1024)),
    ("prefill_gate_up", 4096, 4096, (14336, 14336)), ("prefill_down", 4096, 14336, (4096,)),
    ("engine_verify_qkv", 288, 4096, (4096, 1024, 1024)),
    ("engine_verify_down", 288, 14336, (4096,)),
    ("1b_decode_head", 8, 2048, (128256,)),
    ("1b_decode_qkv", 8, 2048, (2048, 512, 512)), ("1b_decode_o", 8, 2048, (2048,)),
    ("1b_decode_gate_up", 8, 2048, (8192, 8192)), ("1b_decode_down", 8, 8192, (2048,)),
    ("1b_prefill_qkv", 4096, 2048, (2048, 512, 512)), ("1b_prefill_o", 4096, 2048, (2048,)),
    ("1b_prefill_gate_up", 4096, 2048, (8192, 8192)),
    ("1b_prefill_down", 4096, 8192, (2048,)),
]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _group(card, seed, m, k, ns, head):
    g = torch.Generator(device=card).manual_seed(seed)
    out_dtype = torch.float32 if head else torch.bfloat16
    x = (torch.randn(m, k, generator=g, device=card) * 2).to(torch.bfloat16)
    weights = [(torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
                torch.rand(n, generator=g, device=card) * 1e-3) for n in ns]
    return x, weights, out_dtype


@pytest.mark.cuda
@pytest.mark.parametrize("name,m,k,ns", LLAMA_PRODUCTS, ids=[p[0] for p in LLAMA_PRODUCTS])
def test_w8a8_at_llama_shapes_matches_plain(card, name, m, k, ns):
    """`w8a8_dense` (the models' entry) one launch for the group on its
    route; on the wgmma route also `quantize_rows` (on the long-row kernel
    at the 8B's down, K 14,336) and the GEMM a weight, each bit for bit
    against its plain twin."""
    x, weights, out_dtype = _group(card, len(name) * 131 + m, m, k, ns, "head" in name)
    want = w8a8.w8a8_dense_plain(x, weights, out_dtype=out_dtype)
    route = w8a8._route(m, k, True)
    long = int(k == 14336)
    counters = (w8a8.w8a8_qgemm, w8a8.w8a8_gemm, w8a8.quantize_rows)
    before = [f.launches for f in counters] + [w8a8.quantize_rows.long_row_launches]
    got = w8a8.w8a8_dense(x, weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    after = [f.launches for f in counters] + [w8a8.quantize_rows.long_row_launches]
    assert [a - b for a, b in zip(after, before)] == ([1, 0, 0, 0] if route == "qgemm"
                                                      else [0, 1, 1, long])
    for a, b in zip(got, want):
        assert a.dtype == out_dtype and torch.equal(a, b)
    if route == "wgmma":
        xq, xs = w8a8.quantize_rows(x)
        pq, ps = w8a8.quantize_rows_plain(x)
        assert torch.equal(xq, pq) and torch.equal(xs, ps)
        for (wq, ws), b in zip(weights, want):
            assert torch.equal(w8a8.w8a8_gemm(xq, xs, wq, ws, out_dtype=out_dtype), b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["decode_down", "verify_down", "engine_down",
                                  "engine_verify_down"])
def test_w8a8_at_the_8b_down_replays_in_a_graph(card, name):
    """The 8B's down (K 14,336) captured in a CUDA graph and replayed on
    new rows: the plain twin's output each time."""
    _, m, k, ns = next(p for p in LLAMA_PRODUCTS if p[0] == name)
    x, weights, out_dtype = _group(card, 7, m, k, ns, False)
    w8a8.w8a8_dense(x, weights, out_dtype=out_dtype)  # the build and the warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = w8a8.w8a8_dense(x, weights, out_dtype=out_dtype)[0]
    for seed in (1, 2):
        g = torch.Generator(device=card).manual_seed(seed)
        x.copy_(torch.randn(m, k, generator=g, device=card).to(torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, w8a8.w8a8_dense_plain(x, weights, out_dtype=out_dtype)[0])


# the 8B's products whose plans move off the 0.5B's: the verify round's
# down and o on 128 weight rows by 80 token rows (the swapped product) with
# K split over a cluster of 3, the engine's verify down on a weight tile
# shared by its three row tiles, the prefill's gate/up group in bands of 8
# column tiles with pairs of row tiles sharing each weight tile
LLAMA_PLAN_PRODUCTS = {"verify_down": (80, 128, 3, 1, 32, True),
                       "verify_o": (80, 128, 3, 1, 32, True),
                       "engine_verify_down": (128, 128, 1, 3, 32, True),
                       "prefill_gate_up": (128, 128, 1, 2, 8, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LLAMA_PLAN_PRODUCTS))
def test_w8a8_8b_plans_match_plain_eager_and_in_a_graph(card, name):
    """Each of those products on its plan (`_gemm_plan` on the card's SMs,
    the plan pinned for 132): the wgmma GEMM's launch for the group bit for
    bit against the plain version, eagerly and captured in a CUDA graph
    replayed on new rows, in bf16 and in the s32 kind."""
    _, m, k, ns = next(p for p in LLAMA_PRODUCTS if p[0] == name)
    assert tuple(w8a8._gemm_plan(m, k, ns, 132)[:6]) == LLAMA_PLAN_PRODUCTS[name]
    x, weights, out_dtype = _group(card, 11, m, k, ns, False)
    xq, xs = w8a8.quantize_rows(x)
    s32 = [(wq, None) for wq, _ in weights]
    nones = [None] * len(ns)

    def run():
        return (w8a8._gemm_launch(xq, xs, weights, nones, out_dtype),
                w8a8._gemm_launch(xq, None, s32, nones, torch.int32))

    def check(got):
        want = w8a8.w8a8_dense_plain(x, weights, out_dtype=out_dtype)
        assert all(torch.equal(a, b) for a, b in zip(got[0], want))
        assert all(torch.equal(a, w8a8.w8a8_acc_plain(xq, wq))
                   for a, (wq, _) in zip(got[1], s32))

    before = w8a8.w8a8_gemm.few_tile_launches
    check(run())
    torch.cuda.synchronize()
    assert w8a8.w8a8_gemm.few_tile_launches - before == int(
        w8a8._few_rows(LLAMA_PLAN_PRODUCTS[name]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for seed in (1, 2):
        g = torch.Generator(device=card).manual_seed(seed)
        x.copy_((torch.randn(m, k, generator=g, device=card) * seed).to(torch.bfloat16))
        q, sc = w8a8.quantize_rows_plain(x)
        xq.copy_(q)
        xs.copy_(sc)
        graph.replay()
        torch.cuda.synchronize()
        check(outs)


def _wide_2layer():
    """The 8B at its full widths, cut to 2 layers."""
    return dataclasses.replace(tqwen.QwenConfig.llama31_8b(), layers=2)


def _prompts(card, b, t, vocab, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(1000, vocab - 1, (b, t), generator=g, device=card, dtype=torch.int32)
    lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=card)
    mask = (torch.arange(t, device=card)[None] < lens[:, None]).to(torch.int32)
    return ids * mask, mask


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "w8a8"])
def test_decode_graphs_at_8b_width_match_eager(card, quantize):
    """Greedy at B 8 and 1 and speculation at B 8, gamma 8 (the verify
    round's 72 rows), each replayed graph against its eager loop: tokens
    bit for bit (and the mean commits). The bf16 head casts the
    128,256-row table to f32 inside the step graph; W8A8 runs the untied
    int8 head on the small-row kernel."""
    cfg = _wide_2layer()
    params = tqwen.init_qwen_params(cfg, generator=torch.Generator(device=card).manual_seed(3),
                                    dtype=torch.bfloat16, device=card, quantize=quantize)
    for b in (8, 1):
        ids, mask = _prompts(card, b, 64, cfg.vocab_size, seed=b)
        got = tqwen.greedy_generate(params, cfg, ids, mask, 16)
        want = tqwen.greedy_generate_eager(params, cfg, ids, mask, 16)
        assert torch.equal(got, want)
    ids, mask = _prompts(card, 8, 64, cfg.vocab_size, seed=9)
    ids[0, 20:40] = ids[0, :20]  # a repeat the bigram drafts can hit
    mask[0] = 1
    got, mean = tqwen.ngram_speculative_generate(params, cfg, ids, mask, 16, gamma=8)
    want, mean_e = tqwen.ngram_speculative_generate_eager(params, cfg, ids, mask, 16, gamma=8)
    assert torch.equal(got, want) and float(mean) == float(mean_e)
    assert len(decode_graph.graphs_of(params)) == 3
