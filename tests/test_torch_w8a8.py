"""Port parity for W8A8-dynamic int8 weights (LLM_WEIGHT_QUANT and
ENCODER_WEIGHT_QUANT) on the CPU, where the wrappers of `ops/w8a8.py` run
their plain versions.

Bit for bit against the JAX package's functions run op by op (as its own
quantization tests call them): the weight and activation quantizers, the
W8A8 `dense`, the int8 heads and every quantized leaf carried by the
weights functions. Under `jax.jit`, XLA rewrites the division by the
constant 127 into a multiply by its f32 reciprocal, which moves a scale
by an ulp now and then; the port keeps the program's IEEE division (the
reference's `layers.py:64-89` as written). So the model-level cases, whose
JAX side is jitted, hold logits to a stated tolerance and tokens
identical, a token allowed to differ only at a step whose top two logits
lie within NEAR_TIE (each such step printed).
"""

import asyncio
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu.core import make_mesh
from rag_inference_pipeline_tpu.engine.device_pipeline import (
    DeviceRAGPipeline as JPipeline,
)
from rag_inference_pipeline_tpu.models import bert as jbert
from rag_inference_pipeline_tpu.models import layers as jlayers
from rag_inference_pipeline_tpu.models import qwen as jqwen
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
from rag_inference_pipeline_tpu_torch.engine.device_pipeline import (
    DeviceRAGPipeline as TPipeline,
)
from rag_inference_pipeline_tpu_torch.models import bert as tbert
from rag_inference_pipeline_tpu_torch.models import components as tcomp
from rag_inference_pipeline_tpu_torch.models import layers as tlayers
from rag_inference_pipeline_tpu_torch.models import qwen as tqwen
from rag_inference_pipeline_tpu_torch.models.weights import (
    bert_params_from_jax,
    qwen_params_from_jax,
)
from rag_inference_pipeline_tpu_torch.ops import w8a8

CPU = torch.device("cpu")
NEAR_TIE = 1e-4  # f32 logits, as the decode tests hold speculation and the engine
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pair(a: np.ndarray, jdt, tdt):
    """The same values as a JAX array of `jdt` and a tensor of `tdt`."""
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(t):
    return t.detach().float().numpy()


def _tied_values(rng, rows, cols, axis):
    """Random values with planted cases along `axis` (the reduction axis of
    the scale): an all-zero line (scale 1e-8/127), and a line whose
    abs-max is 127 (scale exactly 1) holding k + 0.5 values, which the
    division leaves exactly on a tie (rounds half to even)."""
    a = rng.standard_normal((rows, cols)).astype(np.float32)
    line = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 125.5, -126.5], np.float32)
    if axis == 0:
        a[:, 1] = 0.0
        a[: len(line), 2] = line
        a[len(line):, 2] = 3.0
    else:
        a[1, :] = 0.0
        a[2, : len(line)] = line
        a[2, len(line):] = 3.0
    return a


# --- bit for bit: the quantizers, dense and the heads -----------------------


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantize_linear_and_embed_bit_for_bit(jdt, tdt):
    rng = np.random.default_rng(0)
    wj, wt = _pair(_tied_values(rng, 40, 24, axis=0), jdt, tdt)
    jq, tq = jlayers.quantize_linear(wj), tlayers.quantize_linear(wt)
    assert tq.q.dtype == torch.int8 and tq.q.shape == (24, 40)  # [out, in]
    np.testing.assert_array_equal(tq.q.T.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    assert tq.s[1] == np.float32(1e-8) / np.float32(127) and not tq.q[1].any()
    assert tq.s[2] == 1.0 and tq.q[2, :8].tolist() == [127, 0, 2, 2, -2, 0, 126, -126]
    ej, et = _pair(_tied_values(rng, 30, 40, axis=1), jdt, tdt)
    je, te = jlayers.quantize_embed(ej), tlayers.quantize_embed(et)
    np.testing.assert_array_equal(te.q.numpy(), np.asarray(je.q))
    np.testing.assert_array_equal(te.s.numpy(), np.asarray(je.s))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantize_act_rows_bit_for_bit(jdt, tdt):
    rng = np.random.default_rng(1)
    a = _tied_values(rng, 12, 64, axis=1).reshape(3, 4, 64)
    xj, xt = _pair(a, jdt, tdt)
    jq, js = jlayers.quantize_act_rows(xj)
    pq, ps = w8a8.quantize_rows_plain(xt)
    for tq, ts in (tlayers.quantize_act_rows(xt), (pq, ps[..., None])):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert ts.shape == (3, 4, 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _near_tie_rows(rng, m, k):
    """Rows whose every x / s lies within a few ulps of a half-integer (and
    some exactly on one): each row's abs-max is 127 s for an awkward s, the
    others (j + 0.5) s nudged by a relative 0, +-2^-23 or +-2^-22."""
    s = (rng.random((m, 1)) * 10 + 1e-3).astype(np.float32)
    j = rng.integers(-127, 127, (m, k)).astype(np.float32)
    nudge = np.array([0.0, 2.0**-23, -(2.0**-23), 2.0**-22, -(2.0**-22)], np.float32)
    x = (j + np.float32(0.5)) * s * (np.float32(1) + nudge[rng.integers(0, 5, (m, k))])
    x[:, 0] = np.float32(127) * s[:, 0]
    return x


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("k", [14336, 16392])
def test_quantize_act_rows_long_rows_bit_for_bit(k, jdt, tdt):
    """Rows past the short-row kernel's 8,192 bf16: Llama-3.1-8B's down (K
    14,336) and a K of 2,049 16-byte pieces (no whole warp's), built on
    near-ties, with a zero row and a row of exact ties: the plain version
    equals the JAX `quantize_act_rows` run op by op, q and s."""
    rng = np.random.default_rng(k)
    a = _near_tie_rows(rng, 6, k)
    a[1] = 0.0
    a[2] = np.resize(np.array([127.0, 0.5, 1.5, -2.5, 125.5], np.float32), k)
    xj, xt = _pair(a, jdt, tdt)
    jq, js = jlayers.quantize_act_rows(xj)
    pq, ps = w8a8.quantize_rows_plain(xt)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js)[:, 0])
    if tdt == torch.float32:  # the near-ties survive in f32
        assert (np.abs(a[3:] / ps.numpy()[3:, None] - pq.numpy()[3:]) > 0.49).mean() > 0.5


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_dense_plain_bit_for_bit(jdt, tdt, bias):
    """`dense` over a QuantizedLinear: quantized rows, the exact s8 sum,
    (f32(acc) * xs) * s cast to x's dtype, then the bias in that dtype."""
    rng = np.random.default_rng(2)
    wj, wt = _pair(rng.standard_normal((48, 20)).astype(np.float32) * 0.05, jdt, tdt)
    xj, xt = _pair(rng.standard_normal((2, 7, 48)).astype(np.float32), jdt, tdt)
    bj, bt = _pair(rng.standard_normal(20).astype(np.float32), jdt, tdt)
    jw, tw = jlayers.quantize_linear(wj), tlayers.quantize_linear(wt)
    yj = jlayers.dense(xj, jw, bj if bias else None)
    yt = tlayers.dense(xt, tw, bt if bias else None)
    assert yt.dtype == tdt and yt.shape == (2, 7, 20)
    np.testing.assert_array_equal(_np(yt), np.asarray(yj.astype(jnp.float32)))
    # the same as the first member of a group that shares x
    other = tlayers.quantize_linear(wt * 2)
    got = tlayers.dense_group(xt, (tw, other), (bt if bias else None, None))
    assert torch.equal(got[0], yt)
    assert torch.equal(got[1], tlayers.dense(xt, other))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("k", [2432, 4864])
@pytest.mark.parametrize("m", [72, 288])
def test_plain_twin_at_verify_rows_bit_for_bit(m, k, jdt, tdt):
    """At the verify round's 72 rows and the engine's 288, with down's K
    (4,864) and its row shard at tp = 2 (2,432): the plain twin equals the
    JAX `_qdense` (with a bias) and the tied int8 head (f32 logits), both
    run op by op, and its s32 sums the reference's int32 dot."""
    rng = np.random.default_rng(m + k)
    xj, xt = _pair(rng.standard_normal((m, k)).astype(np.float32), jdt, tdt)
    wj, wt = _pair(rng.standard_normal((k, 96)).astype(np.float32) * 0.05, jdt, tdt)
    bj, bt = _pair(rng.standard_normal(96).astype(np.float32), jdt, tdt)
    jw, tw = jlayers.quantize_linear(wj), tlayers.quantize_linear(wt)
    (y,) = w8a8.w8a8_dense_plain(xt, [(tw.q, tw.s)], [bt], out_dtype=tdt)
    np.testing.assert_array_equal(_np(y), np.asarray(jlayers.dense(xj, jw, bj)
                                                     .astype(jnp.float32)))
    ej, et = _pair(rng.standard_normal((80, k)).astype(np.float32), jdt, tdt)
    je, te = jlayers.quantize_embed(ej), tlayers.quantize_embed(et)
    yq, ys = jlayers.quantize_act_rows(xj)
    acc = jax.lax.dot_general(yq, je.q, (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
    (logits,) = w8a8.w8a8_dense_plain(xt, [(te.q, te.s)], out_dtype=torch.float32)
    np.testing.assert_array_equal(logits.numpy(),
                                  np.asarray(acc.astype(jnp.float32) * ys * je.s))
    xq, _ = w8a8.quantize_rows_plain(xt)
    np.testing.assert_array_equal(w8a8.w8a8_acc_plain(xq, te.q).numpy(), np.asarray(acc))


def test_gemm_plain_is_exact_past_f32():
    """K * 127^2 far past 2^24: the float64 product of the int8 values is
    the exact s32 sum (an f32 product would not be)."""
    k = 4864
    xq = torch.full((2, k), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((3, k), 127, dtype=torch.int8)
    wq[2, 1] = 126
    one = torch.ones(2), torch.ones(3)
    out = w8a8.w8a8_gemm_plain(xq, one[0], wq, one[1], out_dtype=torch.float32)
    want = (xq.long() @ wq.long().T).float()
    assert torch.equal(out, want)
    assert out[0, 0] == 127 * 127 * k and out[0, 2] == 127 * 127 * k - 127


# --- the route, the small-row plan and the grouped entry ---------------------


@pytest.mark.parametrize("m,k,aligned,want", [
    (1, 896, True, "qgemm"), (8, 896, True, "qgemm"),
    (w8a8.M_STAR, 896, True, "qgemm"), (w8a8.M_STAR + 1, 896, True, "wgmma"),
    (72, 896, True, "wgmma"), (4096, 4864, True, "wgmma"),
    (4096, 36, True, "qgemm"),  # K % 16 != 0: only the small-row kernel takes it
    (4096, 896, False, "qgemm"),  # weights off a 16-byte boundary: no TMA
    (8, 14336, True, "qgemm"),  # Llama-3.1-8B's down: 8 rows fit a block
    (17, 14336, True, "wgmma"),  # 16 rows of it do not: any M takes the wgmma
    # M* = 16: decode steps of 8 and 16 lanes stay on the small-row kernel;
    # from 17 rows (the engine's 32 lanes) a product takes the wgmma route
    # at any K it can take, as do the verify round's 36 to 72 rows and a
    # B = 1 prefill
    (8, 4864, True, "qgemm"), (16, 896, True, "qgemm"), (32, 4864, True, "wgmma"),
    (17, 896, True, "wgmma"), (24, 448, True, "wgmma"), (32, 432, True, "wgmma"),
    (36, 896, True, "wgmma"), (33, 64, True, "wgmma"), (72, 2432, True, "wgmma"),
    (128, 4864, True, "wgmma"),
])
def test_route_rule(m, k, aligned, want):
    assert w8a8._route(m, k, aligned) == want


@pytest.mark.parametrize("m,k", [(5, 38), (17, 14340), (4096, 4866)])
def test_route_refuses_what_no_kernel_takes(m, k):
    with pytest.raises(ValueError, match="no kernel takes"):
        w8a8._route(m, k, True)


# Qwen2.5-0.5B's decode groups at B = 8 on 132 SMs, and the row tiles that
# K leaves room for: (M, K, N of each weight) -> the kernel and its plan.
# Rows of at most 1,024 elements under 16 MB of weights take the short-K
# kernel: (mt, nt8, grid_x, cluster), clusters of 8 sharing the quantize
# where each block takes two tiles at most. The rest take the streaming
# kernel: (mt, kc, depth, grid, cluster), one block an SM, rows of at most
# 1,024 quantized whole by each block (no cluster), else pairs that split
# K, or clusters of 8 where a pair's slice of a row gives a thread more
# than two units of 16 elements (down, K 4,864); where not even 128-byte
# units give each of the 16 warps two (a few MB: latency) 512-byte units,
# else units of 512 bytes where each warp gets two, else 256 or 128, and
# the deepest ring that fits
@pytest.mark.parametrize("m,k,ns,short,want", [
    (8, 896, (896, 128, 128), True, (8, 1, 144, 8)),  # q/k/v: 144 tiles of 8 rows
    (8, 896, (896,), True, (8, 1, 112, 8)),  # o: 112 tiles of 8, K split 8 ways
    (8, 896, (4864, 4864), True, (8, 8, 152, 8)),  # gate/up: 152 tiles of 64 rows
    (8, 4864, (896,), False, (8, 512, 1, 120, 8)),  # down: 15 clusters of 8
    (8, 896, (151936,), False, (8, 256, 2, 132, 1)),  # the tied head: 9,496 tiles
    (1, 768, (5,), True, (8, 1, 8, 8)),  # a classifier: one tile, one cluster
    (17, 896, (896,), True, (32, 1, 112, 8)),
    (64, 896, (896,), True, (64, 1, 112, 8)),
    (64, 896, (896, 128, 128), True, (64, 1, 128, 8)),  # one block an SM: 144 tiles
    (64, 4864, (896,), False, (32, 512, 1, 120, 8)),  # K holds 32 rows a block
])
def test_qgemm_plan(m, k, ns, short, want):
    assert w8a8._qgemm_short(k, ns) == short
    mt = want[0]
    assert w8a8._qgemm_smem(mt, k) <= w8a8._BLOCK_SMEM  # the route's rule: all of K
    assert w8a8._qgemm_stride(k) % 128 == 64 and w8a8._qgemm_stride(k) >= k
    if short:
        assert w8a8._qshort_plan(m, k, ns, 132) == want
        assert w8a8._qshort_smem(mt, k) <= w8a8._BLOCK_SMEM
    else:
        plan = w8a8._qgemm_plan(m, k, ns, 132)
        assert plan == want
        assert w8a8._qgemm_plan_smem(m, k, ns, plan) <= w8a8._BLOCK_SMEM


# Qwen2.5-0.5B's products at the engine's 17 to 32 live lanes, BERT's
# classifier and the 0.5B's row shards at tp = 2 (the s32 kind): (K, N of
# each weight) -> the wgmma route's plan, the same at 17, 24 and 32 rows:
# q/k/v, o, the classifier and the shards 64 x 64 tiles, down the same
# with K split over 8 blocks, gate/up and the head 64 x 128 tiles
_ENGINE_ROWS = [
    (896, (896, 128, 128), (64, 64, 1, 1, 18, False, 18)),
    (896, (896,), (64, 64, 1, 1, 14, False, 14)),
    (896, (4864, 4864), (64, 128, 1, 1, 76, False, 76)),
    (4864, (896,), (64, 64, 8, 1, 14, False, 112)),
    (896, (151936,), (64, 128, 1, 1, 1187, False, 1187)),
    (448, (896,), (64, 64, 1, 1, 14, False, 14)),
    (2432, (896,), (64, 64, 4, 1, 14, False, 56)),
    (768, (5,), (64, 64, 1, 1, 1, False, 1)),
]


@pytest.mark.parametrize("m", [17, 24, 32])
@pytest.mark.parametrize("k,ns,want", _ENGINE_ROWS)
def test_route_and_plan_at_the_engine_rows(m, k, ns, want):
    assert w8a8._route(m, k, True) == "wgmma"
    assert tuple(w8a8._gemm_plan(m, k, ns, 132)) == want
    # the same shape at 16 rows (a decode step of 16 lanes) keeps the
    # small-row kernel
    assert w8a8._route(16, k, True) == "qgemm"


# every small-row product of the port's models at their decode shapes:
# Qwen2.5-0.5B (B 8 and 1, a classifier, and the s32 kind's row shards at
# tp 2), Llama-3.2-1B (B 8) and Llama-3.1-8B (B 8 and 1, its engine's 32
# lanes), and the heads at 32 lanes: (M, K, N of each weight)
_SMALL_SHAPES = [
    (8, 896, (896, 128, 128)), (8, 896, (896,)), (8, 896, (4864, 4864)),
    (8, 4864, (896,)), (8, 896, (151936,)), (1, 896, (151936,)), (1, 896, (896,)),
    (8, 768, (5,)), (8, 448, (896,)), (8, 2432, (896,)),
    (8, 2048, (2048, 512, 512)), (8, 2048, (2048,)), (8, 2048, (8192, 8192)),
    (8, 8192, (2048,)), (8, 2048, (128256,)),
    (8, 4096, (4096, 1024, 1024)), (8, 4096, (4096,)), (8, 4096, (14336, 14336)),
    (8, 14336, (4096,)), (8, 4096, (128256,)), (1, 4096, (4096, 1024, 1024)),
    (1, 14336, (4096,)), (1, 4096, (128256,)),
    (32, 4096, (4096, 1024, 1024)), (32, 4096, (4096,)), (32, 4096, (14336, 14336)),
    (32, 896, (151936,)), (32, 4096, (128256,)),
]


@pytest.mark.parametrize("k,ns", sorted({(k, ns) for _, k, ns in _SMALL_SHAPES}))
def test_small_row_plans_fit_a_block_at_1_to_32_rows(k, ns):
    """Each small-row product's plan, on the kernel `_qgemm_short` picks,
    fits a block's shared memory at every row count from 1 to 32 (rows
    past 16 reach the small-row kernels through `w8a8_qgemm`, and where
    the wgmma route cannot take a shape), its m tile the rows rounded up
    to 8 or a multiple of 16, or fewer rows (several m tiles) at long K."""
    for m in range(1, 33):
        mt = w8a8._qgemm_rows(m, k)
        if mt is None:  # a long row past 8 rows: the wgmma route only
            assert m > 8 and w8a8._route(m, k, True) == "wgmma"
            continue
        assert mt == 8 if m <= 8 else 16 <= mt <= -(-m // 16) * 16  # fewer where K is long
        if w8a8._qgemm_short(k, ns):
            plan = w8a8._qshort_plan(m, k, ns, 132)
            assert plan[0] == mt and w8a8._qshort_smem(mt, k) <= w8a8._BLOCK_SMEM
        else:
            plan = w8a8._qgemm_plan(m, k, ns, 132)
            assert plan.mt == mt and plan.depth >= 1
            assert w8a8._qgemm_plan_smem(m, k, ns, plan) <= w8a8._BLOCK_SMEM


@pytest.mark.parametrize("m,k,ns", _SMALL_SHAPES)
def test_qgemm_tiles_cover_each_tile_once_in_one_wave(m, k, ns):
    """The twin of the streaming small-row kernel's block -> unit map on
    `_qgemm_plan`'s plan: each tile of 16 weight rows of each weight
    is one cluster's, its K covered once by its blocks' chunks of at most
    kc bytes in order; a cluster's tiles are contiguous and no cluster
    holds more than one tile past the mean; a block's warps' runs of units
    differ by one at most; the grid is one block an SM and its clusters fit
    one wave on a 132-SM H100 under the recorded active-cluster counts."""
    plan = w8a8._qgemm_plan(m, k, ns, 132)
    mt, kc, depth, grid, cluster = plan
    rows = w8a8._QG_TILE_ROWS
    assert w8a8._qgemm_plan_smem(m, k, ns, plan) <= w8a8._BLOCK_SMEM
    assert grid <= 132 and grid % cluster == 0
    assert grid // cluster <= w8a8._QG_WAVE[cluster]
    tiles = [-(-n // rows) for n in ns]
    seen, blocks, warps = {}, {}, {}
    for b, w, mem, n0, k0, k1 in w8a8._qgemm_tiles(m, k, ns, plan):
        assert 0 <= b < grid and 0 <= w < w8a8._QG_WARPS
        assert 0 <= mem < len(ns) and n0 % rows == 0 and 0 <= n0 < ns[mem]
        assert k0 % 64 == 0 and 0 < k1 - k0 <= kc and (k1 % 64 == 0 or k1 == k)
        seen.setdefault((mem, n0), []).append((k0, k1, b // cluster))
        blocks.setdefault(b // cluster, set()).add(sum(tiles[:mem]) + n0 // rows)
        warps[(b, w)] = warps.get((b, w), 0) + 1
    assert len(seen) == sum(tiles)
    for ranges in seen.values():
        ranges.sort()
        assert len({c for _, _, c in ranges}) == 1  # one cluster's
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
    most = -(-sum(tiles) // (grid // cluster))
    for ts in blocks.values():
        assert len(ts) <= most and max(ts) - min(ts) + 1 == len(ts)
    for b in range(grid):
        counts = [warps.get((b, w), 0) for w in range(w8a8._QG_WARPS)]
        assert max(counts) - min(counts) <= 1


# Qwen2.5-0.5B's products on the wgmma route on 132 SMs: (M, K, N of each
# weight) -> (bm, bn, split, share, band, deep, blocks). 128-column tiles
# over all of K where they give half as many blocks as SMs (bands of 8
# column tiles at prefill's gate/up, whose weights are wider than its
# rows; no weight tile shared: the weights stay under 16 MB); else 64 x 64
# tiles (the 0.5B's weights are too narrow for 128 columns split over a
# cluster to fill half the card), K split over a cluster where a block
# keeps four 128-byte chunks at least
@pytest.mark.parametrize("m,k,ns,want", [
    (72, 896, (896,), (64, 64, 1, 1, 14, False, 28)),  # the verify round's q/o
    (72, 896, (896, 128, 128), (64, 64, 1, 1, 18, False, 36)),  # q/k/v: one launch
    (72, 896, (4864, 4864), (128, 128, 1, 1, 76, False, 76)),  # gate/up: wide tiles
    (72, 4864, (896,), (64, 64, 4, 1, 14, False, 112)),  # down: 7 wide tiles, 112 blocks
    (72, 2432, (896,), (64, 64, 4, 1, 14, False, 112)),  # down's row shard at tp = 2
    (72, 896, (151936,), (128, 128, 1, 1, 1187, False, 1187)),  # the tied head
    (33, 896, (896,), (64, 64, 1, 1, 14, False, 14)),
    (48, 4864, (896,), (64, 64, 8, 1, 14, False, 112)),  # one row tile: 8 splits
    (128, 4864, (896,), (64, 64, 4, 1, 14, False, 112)),  # a B = 1 prefill, bucket 128
    (288, 896, (896, 128, 128), (64, 64, 1, 1, 18, False, 90)),  # the engine's 32 x 9
    (288, 4864, (896,), (64, 64, 1, 1, 14, False, 70)),  # a split would pass an SM a block
    (288, 896, (4864, 4864), (128, 128, 1, 1, 76, False, 228)),
    (4096, 896, (4864, 4864), (128, 128, 1, 1, 8, False, 2432)),  # prefill: bands of 8
])
def test_gemm_plan(m, k, ns, want):
    assert w8a8._gemm_plan(m, k, ns, 132) == want


@pytest.mark.parametrize("ns", [(896,), (4864, 4864), (896, 128, 128), (4096,),
                                (14336, 14336), (4096, 1024, 1024)])
@pytest.mark.parametrize("k", [896, 2432, 4864, 14336])
@pytest.mark.parametrize("m", [33, 72, 128, 288, 512, 4096])
def test_gemm_plan_fills_the_card(m, k, ns):
    """Every plan: wide tiles where they give half as many blocks as SMs
    (64 rows where M fits them; where the weights pass 16 MB, 2 to 4 row
    tiles share each weight tile, one block an SM where the grid fits the
    card, and more row tiles share in pairs; bands of a wave's blocks under
    weights wider than the rows); else, one tile of 32, 64, 80 or 128
    token rows by 128 weight rows, K split over the most blocks of a
    cluster (2 to 8) that keep four chunks a block and one wave of clusters
    of one block an SM, where that fills half the card; else 64 x 64 tiles
    split over the most blocks (a power of two) that keep an SM a block."""
    bm, bn, split, share, band, deep, blocks = w8a8._gemm_plan(m, k, ns, 132)
    wide_bm = 64 if m <= 64 else 128
    rows = -(-m // wide_bm)
    wide = sum(-(-n // 128) for n in ns)
    most = min(8, -(-k // 128) // 4)
    if 2 * rows * wide >= 132:
        assert (bm, bn, split, blocks) == (wide_bm, 128, 1, rows * wide)
        if sum(ns) * k < 1 << 24 or rows == 1:
            assert share == 1
        else:
            assert share == (rows if wide_bm == 128 and rows <= 4 else 2)
        assert deep == (share > 1 and blocks <= 132)
        if rows > share and sum(ns) > m:
            assert band == max(1, min(wide, (1 if deep else 2) * 132 // rows))
        else:
            assert band == wide
        return
    assert share == 1
    # clusters of `split` blocks one an SM fit one wave: at most split - 1
    # idle SMs in each of the H100's 8 GPCs
    fits = [s for s in range(2, most + 1) if wide * s <= 132 - 8 * (s - 1)]
    if m <= 128 and fits and 2 * max(fits) * wide >= 132:
        assert (bm, bn, split, deep, band) == (
            next(t for t in (32, 64, 80, 128) if m <= t), 128, max(fits), True, wide)
        assert blocks == wide * split
        return
    assert (bm, bn, deep) == (64, 64, False) and split in (1, 2, 4, 8)
    tiles = -(-m // 64) * sum(-(-n // 64) for n in ns)
    assert blocks == tiles * split and blocks <= max(132, tiles)
    assert split <= max(1, most) and (2 * split > most or 2 * blocks > 132)


# the plan kinds the launch counters and chip_smoke.py's kernels line name
@pytest.mark.parametrize("m,k,ns,kind", [
    (4096, 4864, (896,), "wide"), (72, 4096, (14336, 14336), "wide"),
    (4096, 896, (4864, 4864), "bands"), (4096, 4096, (14336, 14336), "bands"),
    (288, 14336, (4096,), "shared"), (288, 4096, (4096, 1024, 1024), "shared"),
    (288, 896, (4864, 4864), "wide"),
    (4096, 14336, (4096,), "shared"),
    (72, 14336, (4096,), "few_rows"), (32, 14336, (4096,), "few_rows"),
    (72, 896, (896,), "few_tiles"), (72, 4864, (896,), "few_tiles"),
])
def test_plan_kind(m, k, ns, kind):
    plan = w8a8._gemm_plan(m, k, ns, 132)
    assert w8a8._plan_kind(plan, ns) == kind
    assert w8a8._few_rows(plan) is (kind in ("few_rows", "few_tiles"))


# every pinned shape and ragged ones: rows past a tile (M 33, 65, 129,
# 300), a ragged column tile (N 130), one to three weights; each plan kind
_TILE_SHAPES = [
    (72, 896, (896,)), (72, 4864, (896,)), (288, 896, (4864, 4864)),
    (4096, 896, (4864, 4864)), (72, 14336, (4096,)), (72, 4096, (4096, 1024, 1024)),
    (288, 14336, (4096,)), (32, 14336, (4096,)), (4096, 4096, (14336, 14336)),
    (33, 912, (130,)), (65, 912, (896, 3)), (129, 4864, (896, 128, 130)),
    (300, 48, (130,)), (300, 912, (896, 130)),
]


@pytest.mark.parametrize("m,k,ns", _TILE_SHAPES)
def test_gemm_tiles_cover_each_tile_once(m, k, ns):
    """The twin of the kernel's block -> tile mapping covers each (weight,
    row tile, column tile) once over all of K (split plans: K's chunks in
    disjoint ranges that join to all of them) and nothing else but rows
    past M in a shared weight tile's last group, on `_gemm_plan`'s plan and
    on every plan kind the kernel takes (bands of 1 to all column tiles)."""
    chunks = -(-k // 128)
    wide = sum(-(-n // 128) for n in ns)
    plans = [tuple(w8a8._gemm_plan(m, k, ns, 132))]
    for split in (1, 2, 3, 8) if m < 4096 else (1,):
        if split <= chunks:
            for band in (1, 3, wide):
                for bm in (32, 80, 128) if split > 1 else (128,):
                    plans.append((bm, 128, split, 1, band, split > 1))
                plans.append((64, 64, split, 1, band, False))
    for share in (2, 3, 4):
        for band in (1, 3, wide):
            plans.append((128, 128, 1, share, band, False))
    for plan in plans:
        bm, bn, split, share = plan[:4]
        got = w8a8._gemm_tiles(m, k, ns, plan)
        tiles = [-(-n // bn) for n in ns]
        rows = -(-m // bm)
        assert len(got) == sum(tiles) * -(-rows // share) * share * split
        seen = {}
        for mem, row, t, c0, c1 in got:
            assert 0 <= mem < len(ns) and 0 <= t < tiles[mem] and 0 <= c0 < c1 <= chunks
            if row >= rows:  # a shared weight tile's group past M
                assert share > 1 and row < -(-rows // share) * share and (c0, c1) == (0, chunks)
                continue
            seen.setdefault((mem, row, t), []).append((c0, c1))
        assert len(seen) == sum(tiles) * rows
        for ranges in seen.values():
            ranges.sort()
            assert ranges[0][0] == 0 and ranges[-1][1] == chunks and len(ranges) == split
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_gemm_tiles_walk_bands_of_column_tiles():
    """The 8B's prefill gate/up group (32 row tiles, 224 column tiles, bands
    of 8, pairs of row tiles sharing each weight tile): the first 256
    blocks take the first 8 column tiles of the gate for every row tile, so
    a wave of 264 reads 4 MB of weights, not all 117 MB; the verify down's
    plan for few rows splits each column tile's K over 3 blocks in turn."""
    plan = w8a8._gemm_plan(4096, 4096, (14336, 14336), 132)
    got = w8a8._gemm_tiles(4096, 4096, (14336, 14336), plan)
    assert {(mem, t) for mem, _, t, _, _ in got[:256]} == {(0, t) for t in range(8)}
    assert {row for _, row, _, _, _ in got[:256]} == set(range(32))
    assert got[256][:3] == (0, 0, 8)
    # band 14 holds the gate's last tiles (112 of them: 14 bands of 8)
    assert {(mem, t) for mem, _, t, _, _ in got[14 * 256:15 * 256]} == {
        (1, t) for t in range(8)}
    down = w8a8._gemm_tiles(72, 14336, (4096,), w8a8._gemm_plan(72, 14336, (4096,), 132))
    assert [b[2:] for b in down[:4]] == [(0, 0, 37), (0, 37, 74), (0, 74, 112), (1, 0, 37)]


# `quantize_rows`' plans on 132 SMs: (M, K, input dtype) -> (path, warps,
# cluster). Rows of at most 8,192 bf16 (4,096 f32) on the short-row kernel,
# the fewest warps (1, 2, 4, 8) at 4 pieces a lane; longer rows on the
# long-row kernel over the fewest blocks (a cluster of 1, 2, 4, 8) that
# hold the row, two where one would and they even the SMs' load by a tenth
# (more rows than SMs); past 8 blocks' registers, 8 blocks of 32 warps
# stream the row twice
_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,k,dtype,want", [
    (8, 896, _BF16, (1, 1, 1)), (4096, 896, _BF16, (1, 1, 1)),  # the 0.5B's hidden
    (72, 4864, _BF16, (1, 8, 1)), (4096, 4864, _F32, (2, 10, 1)),  # its MLP
    (4096, 8192, _BF16, (1, 8, 1)),  # the 1B's down: 1,024 pieces, the register cap
    (4096, 8192, _F32, (2, 16, 1)),
    # Llama-3.1-8B's down (K 14,336): 1,792 pieces bf16, 3,584 f32
    (1, 14336, _BF16, (2, 14, 1)), (8, 14336, _BF16, (2, 14, 1)),
    (32, 14336, _BF16, (2, 14, 1)), (72, 14336, _BF16, (2, 14, 1)),
    (128, 14336, _BF16, (2, 14, 1)), (133, 14336, _BF16, (2, 7, 2)),
    (288, 14336, _BF16, (2, 7, 2)), (512, 14336, _BF16, (2, 14, 1)),
    (4096, 14336, _BF16, (2, 14, 1)),
    (32, 14336, _F32, (2, 28, 1)), (72, 14336, _F32, (2, 28, 1)),
    (288, 14336, _F32, (2, 14, 2)), (4096, 14336, _F32, (2, 28, 1)),
    (4096, 65536, _BF16, (2, 32, 2)),  # 8,192 pieces: two blocks hold a row
    (72, 262_144, _BF16, (2, 32, 8)),  # the most a cluster holds
    (72, 262_272, _BF16, (3, 32, 8)), (4096, 131_136, _F32, (3, 32, 8)),  # streamed
    (72, 14338, _BF16, (0, 1, 1)), (72, 14338, _F32, (0, 1, 1)),  # no whole pieces
    (72, 36, _BF16, (0, 1, 1)), (72, 36, _F32, (1, 1, 1)),
])
def test_quant_plan(m, k, dtype, want):
    assert w8a8._quant_plan(m, k, w8a8._IN_KINDS[dtype], 132) == want
    assert w8a8._quant_plan(m, k, w8a8._IN_KINDS[dtype], 132, False)[0] == w8a8._Q_SCALAR


# every activation width the models quantize on the card: Qwen2.5-0.5B
# (hidden 896, MLP 4,864), Llama-3.2-1B (2,048, 8,192), Llama-3.1-8B
# (4,096, 14,336), BERT-base (768, 3,072); a row-parallel product at tp 2
# quantizes the whole row, so the same widths
_MODEL_KS = (896, 4864, 2048, 8192, 4096, 14336, 768, 3072)


@pytest.mark.parametrize("dtype", [_BF16, _F32])
@pytest.mark.parametrize("m", [1, 8, 17, 32, 33, 72, 128, 288, 512, 4096])
def test_quant_plan_at_every_model_shape(m, dtype):
    """No model's product reaches the scalar kernel or streams its row; each
    plan is one its kernel runs (the entry refuses the rest): the
    short-row kernel on the fewest warps that hold the row, the long-row
    kernel with its slice in registers on the fewest warps, one block a
    row, or two where the rows outnumber the SMs and that evens their
    load."""
    esz = dtype.itemsize
    for k in _MODEL_KS:
        path, warps, cluster = w8a8._quant_plan(m, k, w8a8._IN_KINDS[dtype], 132)
        pieces = k * esz // 16
        assert path != w8a8._Q_SCALAR and path != w8a8._Q_STREAMED, (m, k, dtype)
        if path == w8a8._Q_SHORT:
            assert pieces <= 8 * 128 and cluster == 1 and warps in (1, 2, 4, 8)
            assert warps * 128 >= pieces and (warps == 1 or warps * 64 < pieces)
            continue
        assert pieces > 8 * 128 and 1 <= warps <= 32
        per = -(-pieces // cluster)
        assert warps * 128 >= per > (warps - 1) * 128
        load = [-(-m * c // 132) / c for c in (1, 2)]
        assert cluster == (2 if m > 132 and load[1] <= 0.9 * load[0] else 1)


def test_quantize_rows_launches_on_its_plan(monkeypatch):
    """The wrapper hands the entry point `_quant_plan`'s plan for x's
    shape, dtype and alignment, and counts a long-row launch where the
    plan takes the long-row kernel."""
    card = _FakeCard(monkeypatch)
    for x, plan in ((torch.zeros(288, 14336, dtype=torch.bfloat16), (2, 7, 2)),
                    (torch.zeros(4096, 14336), (2, 28, 1)),
                    (torch.zeros(72, 896, dtype=torch.bfloat16), (1, 1, 1)),
                    (torch.zeros(72 * 14338), (0, 1, 1))):
        x = x.view(72, 14338) if x.dim() == 1 else x
        card.calls.clear()
        before = (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches)
        q, s = w8a8.quantize_rows(x)
        assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == (x.shape[0],)
        (name, args), = card.calls
        assert name == "ragtorch_w8a8_quantize_rows"
        kind = w8a8._IN_KINDS[x.dtype]
        assert args[3:] == (*x.shape, kind, *plan)
        assert (w8a8.quantize_rows.launches, w8a8.quantize_rows.long_row_launches) == (
            before[0] + 1, before[1] + int(plan[0] >= w8a8._Q_LONG))
    # an x off a 16-byte boundary: the scalar kernel
    card.calls.clear()
    flat = torch.zeros(32 * 14336 + 1, dtype=torch.bfloat16)
    x = flat[1:].view(32, 14336)
    w8a8.quantize_rows(x)
    assert card.calls[0][1][6:] == (w8a8._Q_SCALAR, 1, 1)


@pytest.mark.parametrize("m,k,ns,bn,want", [
    (72, 896, (896,), 64, True), (72, 4864, (896,), 64, False),  # the 0.5B's few tiles
    (4096, 768, (896,), 128, True), (4096, 896, (896,), 128, True),  # K under 4 KB
    (4096, 3072, (896,), 128, True),
    (4096, 4096, (896,), 128, False), (4096, 4864, (896,), 128, False),  # a long K
    (4096, 14336, (4096,), 128, False),  # the 8B's prefill down: two blocks an SM
    # one block an SM (deep): the 8B's verify down and o, engine down and
    # engine verify down
    (72, 14336, (4096,), 128, True), (72, 4096, (4096,), 128, True),
    (32, 14336, (4096,), 128, True), (288, 14336, (4096,), 128, True),
])
def test_pdl_rule(m, k, ns, bn, want):
    plan = w8a8._gemm_plan(m, k, ns, 132)
    assert plan[1] == bn and w8a8._pdl(k, plan) is want


def _group(rng, k, ns, jdt, tdt, bias):
    """JAX-quantized weights [in, out] and the port's [out, in] from the
    same values, with biases of the working type or None."""
    out = []
    for n in ns:
        wj, wt = _pair(rng.standard_normal((k, n)).astype(np.float32) * 0.05, jdt, tdt)
        bj, bt = _pair(rng.standard_normal(n).astype(np.float32), jdt, tdt)
        out.append((jlayers.quantize_linear(wj), tlayers.quantize_linear(wt),
                    bj if bias else None, bt if bias else None))
    return out


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("ns", [(20,), (24, 8), (16, 4, 4)])
def test_grouped_plain_bit_for_bit(ns, jdt, tdt, bias):
    """`w8a8_dense` over a group of 1-3 weights (the plain version on the
    CPU, as `w8a8_qgemm` and `dense_group` run it) equals a separate JAX
    `dense` (`_qdense`) of each weight, op by op."""
    rng = np.random.default_rng(len(ns) + 10 * bias)
    xj, xt = _pair(_tied_values(rng, 9, 48, axis=1), jdt, tdt)
    group = _group(rng, 48, ns, jdt, tdt, bias)
    weights = [(tw.q, tw.s) for _, tw, _, _ in group]
    biases = [bt for _, _, _, bt in group]
    got = w8a8.w8a8_dense(xt, weights, biases, out_dtype=tdt)
    assert [tuple(y.shape) for y in got] == [(9, n) for n in ns]
    for y, (jw, _, bj, _) in zip(got, group):
        assert y.dtype == tdt
        np.testing.assert_array_equal(_np(y), np.asarray(jlayers.dense(xj, jw, bj)
                                                         .astype(jnp.float32)))
    for other in (w8a8.w8a8_qgemm(xt, weights, biases, out_dtype=tdt),
                  w8a8.w8a8_dense_plain(xt, weights, biases, out_dtype=tdt),
                  tlayers.dense_group(xt, [tw for _, tw, _, _ in group], biases)):
        assert all(torch.equal(a, b) for a, b in zip(other, got))


def test_wrappers_refuse_mismatched_groups():
    x = torch.zeros((4, 8))
    w = (torch.zeros((3, 8), dtype=torch.int8), torch.ones(3))
    for fn in (w8a8.w8a8_dense, w8a8.w8a8_qgemm):
        with pytest.raises(ValueError, match="K = 8"):  # mismatched K
            fn(x, [w, (torch.zeros((3, 9), dtype=torch.int8), torch.ones(3))],
               out_dtype=torch.float32)
        with pytest.raises(ValueError, match="must be \\[3\\]"):  # scales' N
            fn(x, [(w[0], torch.ones(4))], out_dtype=torch.float32)
        with pytest.raises(ValueError, match="a bias \\[3\\]"):  # bias' N
            fn(x, [w], [torch.zeros(2)], out_dtype=torch.float32)
        with pytest.raises(ValueError, match="1 to 3"):
            fn(x, [w] * 4, out_dtype=torch.float32)
        with pytest.raises(ValueError, match="1 to 3"):
            fn(x, [w, w], [None], out_dtype=torch.float32)
        with pytest.raises(TypeError, match="int8 with float32"):
            fn(x, [(w[0].float(), w[1])], out_dtype=torch.float32)
        with pytest.raises(TypeError, match="int8 with float32"):
            fn(x, [(w[0], w[1].double())], out_dtype=torch.float32)
        with pytest.raises(TypeError, match="bias of that type"):
            fn(x, [w], [torch.zeros(3)], out_dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="bf16 or f32"):
            fn(x.half(), [w], out_dtype=torch.float32)
        with pytest.raises(TypeError, match="out_dtype"):
            fn(x, [w], out_dtype=torch.float16)
        with pytest.raises(ValueError, match="\\[M, K\\]"):
            fn(x[None], [w], out_dtype=torch.float32)


class _FakeCard:
    """The wrappers' card side on the CPU: `_off_card` says no, the library
    records each launch, 132 SMs, no capture."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(w8a8, "_off_card", lambda what, tensors: False)
        monkeypatch.setattr(w8a8, "_sms", lambda index: 132)
        monkeypatch.setattr(w8a8._kernels, "launch",
                            lambda name, index, *args: self.calls.append((name, args)))
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    def names(self):
        return [name for name, _ in self.calls]


def _int8_weights(ns, k, offset=0):
    out = []
    for n in ns:
        buf = torch.zeros(n * k + offset, dtype=torch.int8)
        out.append((buf[offset:].view(n, k), torch.ones(n)))
    return out


def test_dense_launches_one_kernel_per_small_group(monkeypatch):
    card = _FakeCard(monkeypatch)
    before = (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
              w8a8.quantize_rows.launches, w8a8.w8a8_qgemm.short_launches)
    weights = _int8_weights((896, 128, 128), 896)
    ys = w8a8.w8a8_dense(torch.zeros(8, 896, dtype=torch.bfloat16), weights,
                         out_dtype=torch.bfloat16)
    assert [tuple(y.shape) for y in ys] == [(8, 896), (8, 128), (8, 128)]
    assert card.names() == ["ragtorch_w8a8_qshort"]
    args = card.calls[0][1]
    assert list(args[5]) == [896, 128, 128]  # N of each member
    assert args[6:] == (3, 8, 896, 1, 1, 8, 1, 144, 8)  # nmem, M, K, kinds, plan
    assert list(args[3]) == [None, None, None]  # no biases
    # down (K 4,864): the streaming kernel, plan (mt, kc, depth, grid, cluster)
    w8a8.w8a8_dense(torch.zeros(8, 4864, dtype=torch.bfloat16), _int8_weights((896,), 4864),
                    out_dtype=torch.bfloat16)
    assert card.names() == ["ragtorch_w8a8_qshort", "ragtorch_w8a8_qgemm"]
    assert card.calls[1][1][6:] == (1, 8, 4864, 1, 1, 8, 512, 1, 120, 8)
    assert (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
            w8a8.quantize_rows.launches, w8a8.w8a8_qgemm.short_launches) == (
        before[0] + 2, before[1], before[2], before[3] + 1)


def test_dense_takes_the_wgmma_route_for_many_rows(monkeypatch):
    card = _FakeCard(monkeypatch)
    before = (w8a8.w8a8_gemm.launches, w8a8.quantize_rows.launches,
              w8a8.w8a8_gemm.few_tile_launches)
    weights = _int8_weights((4864, 4864), 896)
    m = w8a8.M_STAR + 1
    w8a8.w8a8_dense(torch.zeros(m, 896), weights, out_dtype=torch.float32)
    # the group in one launch, on the plan for its shape
    assert card.names() == ["ragtorch_w8a8_quantize_rows", "ragtorch_w8a8_gemm_wgmma"]
    args = card.calls[1][1]
    assert list(args[6]) == [4864, 4864, 0]  # N of each member (3 slots)
    plan = w8a8._gemm_plan(m, 896, (4864, 4864), 132)
    # nmem, M, K, kind, the plan (bm, bn, split, share, band, deep), pdl
    assert args[7:] == (2, m, 896, 0, *plan[:5], int(plan[5]), 1)
    assert (w8a8.w8a8_gemm.launches, w8a8.quantize_rows.launches,
            w8a8.w8a8_gemm.few_tile_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(w8a8._few_rows(plan)))
    # a weight off a 16-byte boundary, or K % 16 != 0: the small-row kernel
    card.calls.clear()
    w8a8.w8a8_dense(torch.zeros(300, 896), _int8_weights((64,), 896, offset=4),
                    out_dtype=torch.float32)
    w8a8.w8a8_dense(torch.zeros(300, 36), _int8_weights((64,), 36),
                    out_dtype=torch.float32)
    assert card.names() == ["ragtorch_w8a8_qshort"] * 2
    assert card.calls[0][1][-4:] == (64, 1, 8, 8)  # m tiles of 64 rows, one cluster


@pytest.mark.parametrize("m", [72, 288])
def test_dense_sends_each_wgmma_group_as_one_launch(monkeypatch, m):
    """The verify round's (72 rows) and the engine's (288) q/k/v and
    gate/up groups: one quantize and one GEMM launch each, carrying every
    member's weight, scales, bias and output, its N, and the plan
    `_gemm_plan` gives; a row shard's s32 product the same way, with no
    scales."""
    card = _FakeCard(monkeypatch)
    for ns, bias in (((896, 128, 128), True), ((4864, 4864), False)):
        card.calls.clear()
        weights = _int8_weights(ns, 896)
        biases = [torch.zeros(n, dtype=torch.bfloat16) if bias else None for n in ns]
        before = (w8a8.w8a8_gemm.launches, w8a8.w8a8_gemm.few_tile_launches,
                  w8a8.quantize_rows.launches)
        kinds = dict(w8a8.w8a8_gemm.plan_launches)
        ys = w8a8.w8a8_dense(torch.zeros(m, 896, dtype=torch.bfloat16), weights, biases,
                             out_dtype=torch.bfloat16)
        assert [tuple(y.shape) for y in ys] == [(m, n) for n in ns]
        assert card.names() == ["ragtorch_w8a8_quantize_rows", "ragtorch_w8a8_gemm_wgmma"]
        args = card.calls[1][1]
        plan = w8a8._gemm_plan(m, 896, ns, 132)
        pad = [None] * (3 - len(ns))
        assert list(args[2]) == [wq.data_ptr() for wq, _ in weights] + pad
        assert list(args[3]) == [ws.data_ptr() for _, ws in weights] + pad
        assert list(args[4]) == [None if b is None else b.data_ptr() for b in biases] + pad
        assert list(args[5]) == [y.data_ptr() for y in ys] + pad
        assert list(args[6]) == list(ns) + [0] * len(pad)
        # nmem, M, K, kind, plan, and PDL (every launch at K = 896)
        assert args[7:] == (len(ns), m, 896, 1, *plan[:5], int(plan[5]), 1)
        assert (w8a8.w8a8_gemm.launches, w8a8.w8a8_gemm.few_tile_launches,
                w8a8.quantize_rows.launches) == (
            before[0] + 1, before[1] + int(w8a8._few_rows(plan)), before[2] + 1)
        kinds[w8a8._plan_kind(plan, ns)] += 1
        assert w8a8.w8a8_gemm.plan_launches == kinds
    card.calls.clear()
    (wq, _), = _int8_weights((896,), 2432)
    before = (w8a8.w8a8_gemm_s32.launches, w8a8.w8a8_gemm_s32.wgmma_launches,
              w8a8.w8a8_gemm_s32.few_tile_launches)
    w8a8.w8a8_gemm_s32(torch.zeros(m, 2432, dtype=torch.int8), wq)
    assert card.names() == ["ragtorch_w8a8_gemm_wgmma"]
    args = card.calls[0][1]
    assert args[1] is None and list(args[3]) == [None] * 3
    plan = w8a8._gemm_plan(m, 2432, (896,), 132)
    assert args[7:] == (1, m, 2432, 2, *plan[:5], int(plan[5]), 1)
    assert (w8a8.w8a8_gemm_s32.launches, w8a8.w8a8_gemm_s32.wgmma_launches,
            w8a8.w8a8_gemm_s32.few_tile_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)


def test_card_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch):
    _FakeCard(monkeypatch)
    xq, xs = torch.zeros((8, 36), dtype=torch.int8), torch.ones(8)
    (wq, ws), = _int8_weights((16,), 36)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8.w8a8_gemm(xq, xs, wq, ws, out_dtype=torch.float32)
    (wq, ws), = _int8_weights((16,), 896, offset=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        w8a8.w8a8_gemm(torch.zeros((8, 896), dtype=torch.int8), xs, wq, ws,
                       out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        w8a8.w8a8_qgemm(torch.zeros(8, 38), _int8_weights((16,), 38),
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="4-byte aligned"):
        w8a8.w8a8_qgemm(torch.zeros(8, 896), _int8_weights((16,), 896, offset=2),
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="no room"):
        w8a8.w8a8_qgemm(torch.zeros(17, 14336), _int8_weights((16,), 14336),
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        w8a8.w8a8_qgemm(torch.zeros(896, 8).t(), _int8_weights((16,), 896),
                        out_dtype=torch.float32)


@pytest.fixture(scope="module")
def qwen_int8():
    """The tiny decoder, tied and untied, quantized by the JAX package, and
    the port's trees carried from it."""
    out = {}
    for tied in (True, False):
        cfg = dataclasses.replace(jqwen.QwenConfig.tiny(), tie_embeddings=tied)
        tcfg = dataclasses.replace(tqwen.QwenConfig.tiny(), tie_embeddings=tied)
        jp = jax.jit(partial(jqwen.init_qwen_params, cfg=cfg))(jax.random.key(4))
        jq = jqwen.quantize_qwen_params(jp)
        out[tied] = dict(cfg=cfg, tcfg=tcfg, jp=jp, jq=jq,
                         tp=qwen_params_from_jax(jax.device_get(jp), tcfg),
                         tq=qwen_params_from_jax(jax.device_get(jq), tcfg))
    return out


@pytest.mark.parametrize("tied", [True, False])
def test_logits_heads_bit_for_bit(qwen_int8, tied, monkeypatch):
    """The tied int8 head (contracting H against the [V, H] table) and the
    untied QuantizedLinear head on an identical y: f32 logits equal. The
    final norm is taken out on both sides (its f32 mean sums in another
    order), so y is the same input."""
    for mod in (jqwen, tqwen):
        monkeypatch.setattr(mod, "rms_norm", lambda x, w, eps: x)
    m = qwen_int8[tied]
    x = np.random.default_rng(3).standard_normal((3, 2, 64)).astype(np.float32)
    jl = np.asarray(jqwen._logits(m["jq"], m["cfg"], jnp.asarray(x)))
    with torch.inference_mode():
        tl = tqwen._logits(m["tq"], m["tcfg"], torch.from_numpy(x))
    assert tl.dtype == torch.float32 and tl.shape == (3, 2, m["cfg"].vocab_size)
    np.testing.assert_array_equal(tl.numpy(), jl)
    head = m["tq"].embed if tied else m["tq"].lm_head
    assert isinstance(head, tlayers.QuantizedEmbed if tied else tlayers.QuantizedLinear)


def test_embed_rows_dequantize_bit_for_bit(qwen_int8):
    m = qwen_int8[True]
    ids = np.array([[0, 5, 511], [7, 7, 2]], np.int32)
    je = np.asarray(jqwen._embed_rows(m["jq"], jnp.asarray(ids)))
    te = tqwen._embed_rows(m["tq"], torch.from_numpy(ids))
    np.testing.assert_array_equal(te.numpy(), je)


def _state(tree) -> dict:
    return {k: v for k, v in tree.state_dict().items()}


@pytest.mark.parametrize("tied", [True, False])
def test_qwen_leaves_carried_and_quantized_bit_for_bit(qwen_int8, tied):
    """Every leaf of the JAX package's quantize_qwen_params, carried by
    qwen_params_from_jax (q transposed to [out, in], s f32), equals the
    port's own quantize_qwen_params of the carried float tree; norms and
    biases are the float tree's own tensors, and the scales stay f32
    after `.to(torch.bfloat16)`."""
    m = qwen_int8[tied]
    tq, tp = m["tq"], m["tp"]
    mine = tqwen.quantize_qwen_params(tp)
    got, want = _state(mine), _state(tq)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    jl = m["jq"]["layers"][0]
    np.testing.assert_array_equal(tq.layers[0].down_w.q.T.numpy(), np.asarray(jl["down_w"].q))
    assert tq.layers[0].down_w.q.shape == (64, 128)
    assert isinstance(mine.embed, tlayers.QuantizedEmbed)
    if not tied:
        assert isinstance(mine.lm_head, tlayers.QuantizedLinear)
    assert mine.layers[1].in_ln is not tp.layers[1].in_ln  # a new module ...
    assert mine.layers[1].in_ln.data_ptr() == tp.layers[1].in_ln.data_ptr()  # ... same data
    assert mine.layers[1].q_b.data_ptr() == tp.layers[1].q_b.data_ptr()
    assert isinstance(tp.layers[0].q_w, torch.nn.Parameter)  # the float tree untouched
    half = mine.to(torch.bfloat16)
    assert half.final_ln.dtype == torch.bfloat16
    assert half.layers[0].q_w.s.dtype == torch.float32
    assert half.embed.s.dtype == torch.float32 and half.embed.q.dtype == torch.int8
    assert torch.equal(half.layers[0].q_w.s, tq.layers[0].q_w.s)


def test_bert_leaves_carried_and_quantized_bit_for_bit():
    cfg = jbert.BertConfig.tiny(num_labels=5)
    tcfg = tbert.BertConfig.tiny(num_labels=5)
    jp = jax.jit(partial(jbert.init_bert_params, cfg=cfg))(jax.random.key(3))
    jq = jbert.quantize_bert_params(jp)
    tq = bert_params_from_jax(jax.device_get(jq), tcfg)
    tp = bert_params_from_jax(jax.device_get(jp), tcfg)
    mine = tbert.quantize_bert_params(tp)
    got, want = _state(mine), _state(tq)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    for lp in mine.layers:
        for k in ("q_w", "k_w", "v_w", "o_w", "ffn_in_w", "ffn_out_w"):
            assert isinstance(getattr(lp, k), tlayers.QuantizedLinear)
    assert isinstance(mine.pooler.w, tlayers.QuantizedLinear)
    assert isinstance(mine.classifier.w, tlayers.QuantizedLinear)
    assert mine.classifier.w.q.shape == (5, 64)
    np.testing.assert_array_equal(mine.classifier.w.q.T.numpy(),
                                  np.asarray(jq["classifier"]["w"].q))
    # the embedding tables, LayerNorms and biases stay float, same data
    assert mine.embeddings.word.data_ptr() == tp.embeddings.word.data_ptr()
    assert mine.layers[0].attn_ln_w.data_ptr() == tp.layers[0].attn_ln_w.data_ptr()
    assert mine.embeddings.word.dtype == torch.float32


def _tiny_llama():
    """An unbiased, untied tiny decoder (the Llama family's shape)."""
    return dataclasses.replace(tqwen.QwenConfig.tiny(), qkv_bias=False,
                               tie_embeddings=False)


@pytest.mark.parametrize("cfg", [tqwen.QwenConfig.tiny(), _tiny_llama()],
                         ids=["qwen", "llama"])
def test_int8_init_at_the_source_equals_quantize_init(cfg):
    """Each leaf quantized as it is drawn == quantize_qwen_params of the
    float init from the same generator state, leaf for leaf (as the
    reference's test_llama_family.py:236 holds init_qwen_params_int8)."""
    ref = tqwen.quantize_qwen_params(tqwen.init_qwen_params(
        cfg, generator=torch.Generator().manual_seed(21), dtype=torch.bfloat16))
    inc = tqwen.init_qwen_params(cfg, generator=torch.Generator().manual_seed(21),
                                 dtype=torch.bfloat16, quantize=True)
    got, want = _state(inc), _state(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    assert ("lm_head.q" in got) == (not cfg.tie_embeddings)
    assert ("layers.0.q_b" in got) == cfg.qkv_bias


# --- within a stated tolerance, tokens identical ----------------------------


def _gaps(tp, tcfg, ids, mask, n):
    """The port's eager greedy loop -> the top-two logit gap [B, n] of
    every step."""
    b, t = ids.shape
    cache = tqwen.KVCache.zeros(tcfg.layers, b, t + n, tcfg.kv_heads,
                                tcfg.head_dim, dtype=torch.float32)
    with torch.inference_mode():
        logits, _ = tqwen.qwen_prefill(tp, tcfg, ids, mask, cache)
        gaps = []
        for i in range(n):
            top = logits.topk(2, dim=-1).values
            gaps.append(top[:, 0] - top[:, 1])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            if i < n - 1:
                logits, _ = tqwen.qwen_decode_step(tp, tcfg, tok, cache)
    return torch.stack(gaps, 1)


def _hold_tokens(name, got, ref, gaps):
    """Rows equal, or diverging first at a near-tie step (printed)."""
    ties = []
    for i, (a, r) in enumerate(zip(got.tolist(), ref.tolist())):
        if a == r:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, r)) if x != y)
        gap = float(gaps[i, j])
        assert gap <= NEAR_TIE, f"{name}: row {i} differs at step {j}, gap {gap:.3g}"
        ties.append((i, j, gap))
    print(f"{name}: near-ties {ties}")
    return ties


@pytest.mark.parametrize("tied", [True, False])
def test_decoder_int8_against_jax(qwen_int8, tied):
    """Prefill logits within 1e-4 of the JAX package's (f32; the int8 sums
    are exact on both sides, the attention and norms sum in another
    order), and greedy tokens identical to its jitted greedy_generate but
    for printed near-ties."""
    m = qwen_int8[tied]
    cfg, tcfg, jq, tq = m["cfg"], m["tcfg"], m["jq"], m["tq"]
    rng = np.random.default_rng(5)
    ids = rng.integers(1, cfg.vocab_size, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([[12], [7], [1]])).astype(np.int32)
    ids *= mask
    jcache = jlayers.KVCache.zeros(cfg.layers, 3, 20, cfg.kv_heads, cfg.head_dim,
                                   dtype=jnp.float32)
    jl, _ = jqwen.qwen_prefill(jq, cfg, jnp.asarray(ids), jnp.asarray(mask), jcache)
    tcache = tqwen.KVCache.zeros(tcfg.layers, 3, 20, tcfg.kv_heads, tcfg.head_dim,
                                 dtype=torch.float32)
    tid, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        tl, _ = tqwen.qwen_prefill(tq, tcfg, tid, tmask, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    n = 8
    jt = np.asarray(jax.jit(partial(jqwen.greedy_generate, cfg=cfg, max_new_tokens=n))(
        jq, input_ids=ids, attn_mask=mask))
    tt = tqwen.greedy_generate(tq, tcfg, tid, tmask, n)
    _hold_tokens(f"greedy tied={tied}", tt, jt, _gaps(tq, tcfg, tid, tmask, n))


def test_bert_int8_against_jax():
    """bert_embed (unit norm) within 1e-5 and the classifier's logits
    within 1e-4 of the JAX package's, int8 tiny in f32 (the int8 sums are
    exact; the attention and LayerNorms sum in another order)."""
    cfg = jbert.BertConfig.tiny(num_labels=5)
    tcfg = tbert.BertConfig.tiny(num_labels=5)
    jq = jbert.quantize_bert_params(
        jax.jit(partial(jbert.init_bert_params, cfg=cfg))(jax.random.key(6)))
    tq = bert_params_from_jax(jax.device_get(jq), tcfg)
    rng = np.random.default_rng(6)
    ids = rng.integers(1, cfg.vocab_size, (4, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array([[16], [9], [3], [1]])).astype(np.int32)
    ids *= mask
    je = np.asarray(jbert.bert_embed(jq, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    jc = np.asarray(jbert.bert_classify(jq, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        te = tbert.bert_embed(tq, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
        tc = tbert.bert_classify(tq, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(te.numpy(), je, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-4, rtol=0)


# --- the paths ---------------------------------------------------------------


def test_speculation_and_engine_match_greedy_over_int8(qwen_int8):
    """Speculation and the decode engine give greedy's tokens over the same
    int8 params (as the reference's test_quant_llm.py:117-147 holds its
    own)."""
    m = qwen_int8[True]
    tcfg, tq = m["tcfg"], m["tq"]
    eos = tcfg.vocab_size - 1
    rng = np.random.default_rng(9)
    prompts = torch.from_numpy(rng.integers(1, 400, (2, 8)).astype(np.int32))
    mask = torch.ones_like(prompts)
    solo = tqwen.greedy_generate(tq, tcfg, prompts, mask, 10, eos_token_id=eos,
                                 cache_len=18)
    spec, mean = tqwen.ngram_speculative_generate(tq, tcfg, prompts, mask, 10,
                                                  eos_token_id=eos, gamma=4)
    assert torch.equal(spec, solo) and float(mean) >= 1.0

    singles = [rng.integers(1, 400, n).astype(np.int32) for n in (5, 9)]

    async def collect():
        eng = DecodeEngine(tq, tcfg, lanes=4, cache_len=64, segment_steps=4,
                           eos_token_id=eos, admit_buckets=(1, 2, 4),
                           prefill_buckets=(8, 16))
        await eng.start()
        try:
            return await asyncio.gather(*[eng.submit(p, 10) for p in singles])
        finally:
            await eng.stop()

    for p, got in zip(singles, asyncio.run(collect())):
        ids = torch.from_numpy(p[None])
        ref = tqwen.greedy_generate(tq, tcfg, ids, torch.ones_like(ids), 10,
                                    eos_token_id=eos, cache_len=len(p) + 10)[0]
        n = min(len(got), len(ref))
        assert list(got[:n]) == ref[:n].tolist()


def test_validator_rejects_unknown_quant():
    for name in ("llm_weight_quant", "encoder_weight_quant"):
        with pytest.raises(ValueError, match=name):
            Settings(**{name: "fp4"})
        with pytest.raises(ValueError, match=name):
            load_settings({name.upper(): "int4"})
        assert getattr(Settings(**{name: "int8"}), name) == "int8"


_TINY = dict(embedding_model="tiny-embed", reranker_model="tiny-rerank",
             llm_model="tiny-llm", sentiment_model="tiny-sentiment",
             toxicity_model="tiny-toxicity", batch_shape_buckets="2",
             param_dtype="float32", device_platform="cpu", model_weights_dir="")


def test_llm_component_loads_int8_and_generates(monkeypatch):
    # the hash tokenizer's word ids start at 1000: widen the tiny vocabulary
    tiny = tqwen.QwenConfig.tiny
    monkeypatch.setattr(tqwen.QwenConfig, "tiny", staticmethod(
        lambda: dataclasses.replace(tiny(), vocab_size=1024)))
    s = Settings(**_TINY, llm_weight_quant="int8")
    comp = tcomp.LLMComponent(s, CPU)
    comp.load()
    assert isinstance(comp.params.layers[0].q_w, tlayers.QuantizedLinear)
    assert isinstance(comp.params.embed, tlayers.QuantizedEmbed)
    out = comp.generate_batch(["hello world"], [[{"content": "doc one"}]],
                              max_new_tokens=4)
    assert len(out) == 1 and isinstance(out[0], str)
    # quantized at the source: the same leaves as quantizing the float init
    ref = tcomp.LLMComponent(Settings(**_TINY), CPU)
    ref.load()
    want = _state(tqwen.quantize_qwen_params(ref.params))
    got = _state(comp.params)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_all_four_bert_components_load_quantized():
    s = Settings(**_TINY, encoder_weight_quant="int8")
    emb = tcomp.EmbedderComponent(s, CPU)
    emb.load()
    assert isinstance(emb.params.layers[0].q_w, tlayers.QuantizedLinear)
    vecs = emb.encode(["hello", "world"])
    assert vecs.shape == (2, emb.dim)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=-1), 1.0, atol=1e-5)
    rr = tcomp.RerankerComponent(s, CPU)
    rr.load()
    assert isinstance(rr.params.pooler.w, tlayers.QuantizedLinear)
    ranked = rr.rerank("q", [{"id": 1, "content": "a"}, {"id": 2, "content": "b"}])
    assert len(ranked) == 2 and "rerank_score" in ranked[0]
    for cls in (tcomp.SentimentComponent, tcomp.ToxicityComponent):
        c = cls(s, CPU)
        c.load()
        assert isinstance(c.params.classifier.w, tlayers.QuantizedLinear)
    assert tcomp.SentimentComponent(s, CPU).cfg.num_labels == 5
    c = tcomp.SentimentComponent(s, CPU)
    c.load()
    assert c.analyze_batch(["good", "bad", "fine"])


def test_fused_step_over_int8_matches_jax():
    """The fused RAG step over an int8 embedder and an int8 decoder at
    dp = 1: the JAX package's doc ids, and its tokens but for printed
    near-ties (as test_quant_llm.py:193 builds the quantized step)."""
    rng = np.random.default_rng(11)
    bcfg, qcfg = jbert.BertConfig.tiny(), jqwen.QwenConfig.tiny()
    jb = jbert.quantize_bert_params(init := jax.jit(
        partial(jbert.init_bert_params, cfg=bcfg))(jax.random.key(1)))
    del init
    jqp = jqwen.quantize_qwen_params(
        jax.jit(partial(jqwen.init_qwen_params, cfg=qcfg))(jax.random.key(2)))
    n = 300
    db = rng.standard_normal((n, bcfg.hidden)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    toks = rng.integers(1, 400, (n, 8)).astype(np.int32)
    kw = dict(k=5, ctx_docs=2, max_new_tokens=4, rescore_k=64)
    jpipe = JPipeline(mesh=make_mesh(dp=1, tp=1), bert_cfg=bcfg, qwen_cfg=qcfg,
                      index_dtype="int8", doc_tok_len=8, **kw)
    tcfg = tqwen.QwenConfig.tiny()
    tpipe = TPipeline(device=CPU, bert_cfg=tbert.BertConfig.tiny(), qwen_cfg=tcfg, **kw)
    tb = bert_params_from_jax(jax.device_get(jb), tbert.BertConfig.tiny())
    tqp = qwen_params_from_jax(jax.device_get(jqp), tcfg)
    assert isinstance(tb.layers[0].q_w, tlayers.QuantizedLinear)
    assert isinstance(tqp.embed, tlayers.QuantizedEmbed)
    jpipe.build(jb, jqp, db, toks)
    tpipe.build(tb, tqp, db, toks)
    q = rng.integers(1, 400, (8, 10)).astype(np.int32)
    qm = (np.arange(10)[None] < rng.integers(1, 11, (8, 1))).astype(np.int32)
    q *= qm
    jout = jpipe.step(q, qm)
    tout = tpipe.step(q, qm)
    np.testing.assert_array_equal(tout.doc_ids.numpy(), np.asarray(jout.doc_ids))
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores),
                               rtol=1e-5, atol=1e-5)
    jt = np.asarray(jout.tokens)
    if not np.array_equal(tout.tokens.numpy(), jt):
        # the decoder's prompt, rebuilt as _rag_step builds it, for the gaps
        ctx = toks[tout.doc_ids.numpy()[:, :2]].reshape(8, -1)
        pm = np.concatenate([(ctx > 0).astype(np.int32), qm], 1)
        order = np.argsort(1 - pm, axis=1, kind="stable")
        prompt = np.take_along_axis(np.concatenate([ctx, q], 1), order, 1)
        pm = np.take_along_axis(pm, order, 1)
        _hold_tokens("fused step", tout.tokens, jt,
                     _gaps(tqp, tcfg, torch.from_numpy(prompt), torch.from_numpy(pm), 4))


# --- the wrappers on the CPU --------------------------------------------------


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((5, 36)).astype(np.float32))
    w = tlayers.quantize_linear(torch.from_numpy(rng.standard_normal((36, 3)).astype(np.float32)))
    before = (w8a8.quantize_rows.launches, w8a8.w8a8_gemm.launches)
    q, s = w8a8.quantize_rows(x)
    pq, ps = w8a8.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    y = w8a8.w8a8_gemm(q, s, w.q, w.s, out_dtype=torch.bfloat16)
    assert torch.equal(y, w8a8.w8a8_gemm_plain(q, s, w.q, w.s, out_dtype=torch.bfloat16))
    assert (w8a8.quantize_rows.launches, w8a8.w8a8_gemm.launches) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros((4, 8), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="\\[M, K\\]"):
        w8a8.quantize_rows(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError, match="bf16 or f32"):
        w8a8.quantize_rows(torch.zeros(2, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="must be"):
        w8a8.w8a8_gemm(q, s, torch.zeros((3, 9), dtype=torch.int8), torch.ones(3),
                       out_dtype=torch.float32)
    with pytest.raises(TypeError, match="int8"):
        w8a8.w8a8_gemm(q.float(), s, q, s, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        w8a8.w8a8_gemm(q, s, q, s, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="out_dtype"):
        w8a8.w8a8_gemm(q, s, q, s, torch.zeros(4), out_dtype=torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _fresh_event_loop_policy():
    """asyncio.run leaves the main thread's event loop policy with its loop
    set to None; a later file on the same xdist worker whose
    asyncio.get_event_loop() expects a loop then raises
    (tests/test_core.py::TestRegistry::test_lifecycle). Hand the next file
    a fresh policy."""
    yield
    asyncio.set_event_loop_policy(None)
