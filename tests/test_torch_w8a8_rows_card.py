"""The W8A8 products at 17 to 32 token rows (the decode engine's step of
32 lanes) on the card: both small-row kernels (`w8a8_qgemm`: the short-K
kernel and the streaming one) and the route (`w8a8_dense`, the wgmma route
there: past `M_STAR`'s 16 rows) bit for bit against the plain twin; the
s32 kind of both small-row kernels and `w8a8_row_dense` at tp = 2; the
int8 step graph at 32 lanes against its eager loop. Imports no jax; needs a
CUDA card (skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_w8a8_rows_card.py
"""

import dataclasses

import pytest
import torch

from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.ops import w8a8

ROWS = (17, 24, 32)
# (K, N of each weight): groups of 1, 2 and 3 weights on the short-K kernel
# (K at most 1,024, a few MB: Qwen2.5-0.5B's o, gate/up, q/k/v, BERT's
# classifier, 4-byte copies at K = 36) and on the streaming kernel (the
# 0.5B's down, the 1B's q/k/v, the 8B's o with a second weight), N past a
# tile's 8, 16 or 64 rows in most
GROUPS = [(896, (896,)), (896, (4864, 4864)), (896, (896, 128, 128)), (768, (5,)),
          (36, (3, 200, 17)), (4864, (900,)), (2048, (2048, 520, 520)),
          (4096, (4096, 1000))]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W8A8 kernels have no CPU mode")
    return torch.device("cuda", 0)


def _weights(g, card, k, ns):
    return [(torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
             torch.rand(n, generator=g, device=card) * 1e-2) for n in ns]


@pytest.mark.cuda
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,ns", GROUPS)
def test_small_row_kernels_and_route_match_plain(card, m, k, ns):
    """bf16 and f32 rows, f32 and bf16 outputs, with and without biases:
    the small-row kernel `_qgemm_short` picks launches once for the group,
    `w8a8_dense` once on its route (and `quantize_rows` before the wgmma
    GEMM), each output equal to the plain twin's."""
    g = torch.Generator(device=card).manual_seed(m * 1000 + k + len(ns))
    weights = _weights(g, card, k, ns)
    short = w8a8._qgemm_short(k, ns)
    route = w8a8._route(m, k, True)
    for in_dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn(m, k, generator=g, device=card) * 3).to(in_dtype)
        for out_dtype in (torch.float32, torch.bfloat16):
            for biased in (False, True):
                biases = [torch.randn(n, generator=g, device=card).to(out_dtype)
                          if biased and i % 2 == 0 else None for i, n in enumerate(ns)]
                want = w8a8.w8a8_dense_plain(x, weights, biases, out_dtype=out_dtype)
                before = (w8a8.w8a8_qgemm.launches, w8a8.w8a8_qgemm.short_launches)
                got = w8a8.w8a8_qgemm(x, weights, biases, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert (w8a8.w8a8_qgemm.launches - before[0],
                        w8a8.w8a8_qgemm.short_launches - before[1]) == (1, int(short))
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    "qgemm", in_dtype, out_dtype, biased)
                counters = (w8a8.w8a8_qgemm, w8a8.w8a8_gemm, w8a8.quantize_rows)
                before = [f.launches for f in counters]
                got = w8a8.w8a8_dense(x, weights, biases, out_dtype=out_dtype)
                torch.cuda.synchronize()
                assert [f.launches - b for f, b in zip(counters, before)] == (
                    [1, 0, 0] if route == "qgemm" else [0, 1, 1])
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                    route, in_dtype, out_dtype, biased)


@pytest.mark.cuda
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k", [448, 2432])
def test_s32_kind_and_row_dense_at_tp2(card, m, k):
    """Qwen2.5-0.5B's row shards at tp = 2 (o: K 448 a shard, on the short-K
    kernel; down: K 2,432, on the streaming one): each small-row kernel's
    s32 kind equals the exact sums, and `w8a8_row_dense` over the two
    shards equals the unsplit product."""
    g = torch.Generator(device=card).manual_seed(m * 7 + k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    wq = torch.randint(-127, 128, (896, k), generator=g, device=card, dtype=torch.int8)
    before = (w8a8.w8a8_gemm_s32.launches, w8a8.w8a8_gemm_s32.short_launches)
    got = w8a8._qgemm_launch(xq, [(wq, None)], [None], torch.int32)[0]
    torch.cuda.synchronize()
    assert (w8a8.w8a8_gemm_s32.launches - before[0],
            w8a8.w8a8_gemm_s32.short_launches - before[1]) == (1, int(k <= 1024))
    assert torch.equal(got, w8a8.w8a8_acc_plain(xq, wq))
    x = (torch.randn(m, 2 * k, generator=g, device=card) * 2).to(torch.bfloat16)
    whole = torch.randint(-127, 128, (896, 2 * k), generator=g, device=card, dtype=torch.int8)
    ws = torch.rand(896, generator=g, device=card) * 1e-2
    bias = torch.randn(896, generator=g, device=card).to(torch.bfloat16)
    shards = [whole[:, :k].contiguous(), whole[:, k:].contiguous()]
    got = w8a8.w8a8_row_dense([x[:, :k].contiguous(), x[:, k:].contiguous()], shards, ws,
                              bias, out_dtype=torch.bfloat16)
    want = w8a8.w8a8_dense_plain(x, [(whole, ws)], [bias], out_dtype=torch.bfloat16)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["qwen25_05b", "llama31_8b"])
def test_int8_step_graph_at_32_lanes_matches_eager(card, model):
    """Greedy at 32 lanes over a W8A8 decoder at the model's full widths
    cut to 2 layers (every product of the step at 32 rows, the head's
    too): the replayed step graph's tokens equal the eager loop's."""
    cfg = dataclasses.replace(getattr(tqwen.QwenConfig, model)(), layers=2)
    params = tqwen.init_qwen_params(cfg, generator=torch.Generator(device=card).manual_seed(5),
                                    dtype=torch.bfloat16, device=card, quantize=True)
    g = torch.Generator(device=card).manual_seed(32)
    ids = torch.randint(1000, cfg.vocab_size - 1, (32, 64), generator=g, device=card,
                        dtype=torch.int32)
    lens = torch.randint(32, 65, (32,), generator=g, device=card)
    mask = (torch.arange(64, device=card)[None] < lens[:, None]).to(torch.int32)
    ids = ids * mask
    got = tqwen.greedy_generate(params, cfg, ids, mask, 16)
    want = tqwen.greedy_generate_eager(params, cfg, ids, mask, 16)
    assert torch.equal(got, want)
