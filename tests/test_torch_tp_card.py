"""Tensor parallelism on the card: the s32 kind of both W8A8 kernels
against its plain twin, bit for bit, the attention over a shard's heads
against those heads of the whole call, and the tp = 2 decode step graph
against the eager loop, at tp positions that repeat `cuda:0`. Imports no
jax; needs a CUDA card (skipped without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tp_card.py
"""

import pytest
import torch

from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.models import decode_graph
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.layers import attention, dense, row_dense
from rag_inference_pipeline_tpu_torch.ops import w8a8
from rag_inference_pipeline_tpu_torch.parallel.sharding import place_params


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 33, 72, 300])
@pytest.mark.parametrize("k", [448, 2432])
def test_s32_kind_matches_plain_on_both_routes(card, m, k):
    g = torch.Generator(device=card).manual_seed(m * 7 + k)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    wq = torch.randint(-127, 128, (896, k), generator=g, device=card, dtype=torch.int8)
    before = (w8a8.w8a8_gemm_s32.launches, w8a8.w8a8_gemm_s32.wgmma_launches)
    got = w8a8.w8a8_gemm_s32(xq, wq)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, w8a8.w8a8_acc_plain(xq, wq))
    wgmma = w8a8._route(m, k, True) == "wgmma"
    assert (w8a8.w8a8_gemm_s32.launches - before[0],
            w8a8.w8a8_gemm_s32.wgmma_launches - before[1]) == (1, int(wgmma))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 4096])
def test_row_parallel_w8a8_is_the_unsplit_product(card, m):
    """Down at Qwen2.5-0.5B width, tp = 2: the s32 partials summed, then
    the epilogue, equal the unsplit W8A8 dense bit for bit."""
    from rag_inference_pipeline_tpu_torch.models.layers import quantize_linear

    g = torch.Generator(device=card).manual_seed(m)
    w = quantize_linear(torch.randn(4864, 896, generator=g, device=card) * 0.02)
    x = torch.randn(m, 4864, generator=g, device=card).to(torch.bfloat16)
    shards = [type(w)(w.q[:, j * 2432:(j + 1) * 2432].contiguous(), w.s) for j in range(2)]
    got = row_dense([x[:, :2432].contiguous(), x[:, 2432:].contiguous()], shards)
    assert torch.equal(got, dense(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 9, 512], ids=["decode", "verify", "prefill"])
def test_attention_of_a_shards_heads_is_the_whole_calls(card, t):
    """Qwen2.5-0.5B's 14 query heads over 2 kv heads against a tp = 2
    shard's 7 over 1, B = 8 over 640 cached keys: bit for bit (cuBLAS may
    sum a batch of 7 heads otherwise than one of 14, so each kv head's
    group is its own product at any tp)."""
    g = torch.Generator(device=card).manual_seed(t)
    q = torch.randn(8, t, 14, 64, generator=g, device=card).to(torch.bfloat16)
    k, v = (torch.randn(8, 640, 2, 64, generator=g, device=card).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(t, device=card)[None, :] + 512
    mask = (torch.arange(640, device=card)[None, None, :] <= pos[:, :, None])[:, None]
    whole = attention(q, k, v, mask)
    half = torch.cat([attention(q[:, :, j * 7:(j + 1) * 7], k[:, :, j:j + 1],
                                v[:, :, j:j + 1], mask) for j in range(2)], dim=2)
    assert torch.equal(whole, half)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "w8a8"])
def test_tp2_step_graph_matches_eager(card, quantize):
    cfg = tqwen.QwenConfig(vocab_size=4096, hidden=256, layers=2, heads=4, kv_heads=2,
                           head_dim=64, intermediate=512, max_len=256)
    params = tqwen.init_qwen_params(cfg, generator=torch.Generator(device=card).manual_seed(0),
                                    dtype=torch.bfloat16, device=card, quantize=quantize)
    mesh = make_mesh(dp=1, tp=2, devices=force_host_devices(2, "cuda:0"))
    (tree,) = place_params(mesh, params, cfg)
    assert decode_graph.uses_graphs(tqwen.tree_all_devices(tree))
    g = torch.Generator(device=card).manual_seed(1)
    ids = torch.randint(1, 4000, (4, 32), generator=g, device=card, dtype=torch.int32)
    mask = torch.ones_like(ids)
    graph = tqwen.greedy_generate(tree, cfg, ids, mask, 16, eos_token_id=-1)
    assert len(decode_graph.graphs_of(tree)) == 1
    eager = tqwen.greedy_generate_eager(tree, cfg, ids, mask, 16, eos_token_id=-1)
    assert torch.equal(graph, eager)
