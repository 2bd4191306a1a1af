"""W8A8-dynamic int8 products: the activation quantize and the s8 GEMM.

The reference computes both in XLA, not in Pallas
(`rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows` :80-89
and `_qdense` :92-100, and the int8 heads of `models/qwen.py::_logits`
:309-327). Per row of x [M, K]: s = max(max|x|, 1e-8) / 127 and xq =
clip(rint(x / s), -127, 127); per weight [N, K] (K contiguous: the
reference's [in, out] weight transposed) the exact s32 sum of xq by it,
then (f32(acc) * s[m]) * ws[n] rounded to the output type, plus the bias
in that type. PyTorch has no call that computes them at decode shapes
(`torch._int_mm` wants more than 16 rows, and an f32 product of int8 values
stops being exact once K * 127^2 passes 2^24), so the card runs three
kernels written by hand for Hopper, on two routes that `_route` chooses by
shape:

- large row counts (M > `M_STAR`, K % 16 == 0, 16-byte-aligned weights):
  `quantize_rows` (`csrc/w8a8_quant.cu`, on the plan `_quant_plan` gives:
  1 to 8 warps a row up to 8,192 bf16, a block of up to 32 warps a row, or
  a cluster of 2 to 8 such blocks, past that), then `w8a8_gemm`
  (`csrc/w8a8_wgmma.cu`: s8 wgmma fed by TMA), one launch for the group
  on the plan `_gemm_plan` gives: 128-column tiles over all of K where
  they fill the card (a cluster of 2 to 4 row tiles sharing each weight
  tile, or bands of column tiles that keep a wave's weights in L2, where
  the weights are large); else, where one tile holds the rows, 128-column
  tiles with K split across the blocks of a cluster (exact int32 partial
  sums); else 64 x 64 tiles, K split or not;
- everything else (K % 4 == 0): `w8a8_qgemm`, the quantize and the GEMM
  of up to three weights that share x (q/k/v, gate/up) in one launch:
  `csrc/w8a8_short_k.cu` on `_qshort_plan`'s plan where K is at most 1,024
  and the weights a few MB (`_qgemm_short`: Qwen2.5-0.5B's q/k/v, o and
  gate/up, the classifiers), else `csrc/w8a8_gemm.cu` on `_qgemm_plan`'s
  (long rows and the heads: its weights stream at the card's rate).

`w8a8_dense` is the entry the models call. Under a row split over tp (o
and down, BERT's ffn_out: `models/layers.py::row_dense`) they call
`w8a8_row_dense`: the whole row quantized once (`quantize_rows` over the
shards' columns joined: the reference's abs-max runs over the whole row),
each shard's exact s32 partial (`w8a8_gemm_s32`, the two GEMM kernels'
s32 output kind), the partials summed in int32 (exact, as the
reference's psum of the int32 dot), then the reference's epilogue in
plain f32 torch ops: bit for bit the unsplit product.

On CUDA tensors every wrapper
launches its kernel (or raises: a failed build or launch is never replaced
by the plain version, and no route picks it); on CPU tensors it runs
`quantize_rows_plain` / `w8a8_gemm_plain` / `w8a8_dense_plain`, the
kernels' oracles, which the tests hold to the JAX package bit for bit. Each
kernel counts the launches it makes outside a CUDA graph capture
(`quantize_rows.launches`, of which `quantize_rows.long_row_launches`
took the long-row kernel, `w8a8_gemm.launches`, `w8a8_qgemm.launches`,
and for the s32 kind `w8a8_gemm_s32.launches`, of which
`w8a8_gemm_s32.wgmma_launches` took the wgmma route; of the small-row
launches of either kind, `short_launches` took the short-K kernel; of the
wgmma launches of either kind, `few_tile_launches` took a plan for few
rows, `_few_rows`, and `plan_launches` counts them by plan kind,
`_plan_kind`): a call under a capture records its kernel into the graph and counts nothing,
as the K7 wrappers do (`ops/kv.py`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from . import _kernels

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_S32 = 2  # the s32 kind: int8 rows in (the small-row kernel), int32 sums out

# rows above which a product takes the wgmma route. tools/bench_w8a8.py
# --sweep (8 to 512 rows, Qwen2.5-0.5B's groups, an H100 80GB HBM3 at 700 W;
# PERF.md) finds the wgmma route (quantize_rows, then one GEMM launch a
# group on `_gemm_plan`'s plan) faster than the small-row kernel for one
# product from 8 rows up, but the whole int8 decode step at 16 and 32 lanes
# no faster for it in every turn: decode steps up to 32 lanes keep the
# small-row kernel, one launch a group
M_STAR = 32
# csrc/w8a8_gemm.cu's block: 16 warps, K in 64-byte blocks, m tiles of at
# most 64 rows, tiles of 16 weight rows, units of 512, 256 or 128 bytes of K (a stage row padded by 64), rings of
# up to 8 stages a warp; the
# card's shared memory a block may take and an SM holds (1 KB of it
# reserved a block)
_QG_WARPS, _QG_BLOCK_K, _QG_MAX_ROWS, _QG_TILE_ROWS = 16, 64, 64, 16
_QG_ROW_PAD, _QG_MAX_DEPTH, _QG_UNITS = 64, 8, (512, 256, 128)
# rows of at most _QG_SHORT_K elements: the short-K kernel's (under
# _QS_MAX_BYTES of weights), else quantized whole by each block of the
# streaming kernel (no cluster) where a thread keeps at most 2 of its
# row's 16-element units (a row goes to 512 / G threads, G its rows
# rounded up to a power of two)
_QG_SHORT_K = 1024
# csrc/w8a8_short_k.cu's block: 8 warps, rings of 8 slots of 32 x 32
# bytes, clusters of 8 blocks; the weight bytes of a group below which a product
# of rows of at most _QG_SHORT_K takes it (Qwen2.5-0.5B's gate/up is 8.7
# MB, its head 136 MB)
_QS_WARPS, _QS_DEPTH, _QS_CLUSTER, _QS_MAX_BYTES = 8, 8, 8, 1 << 24
_BLOCK_SMEM, _SM_SMEM, _SM_RESERVED = 232_448, 233_472, 1024
# the blocks of a small-row cluster (sharing the quantize of x), and the
# clusters of 1, 2 and 8 one-an-SM blocks an H100 runs at once
# (cudaOccupancyMaxActiveClusters, `ragtorch_w8a8_qgemm_clusters`;
# PERF.md): pairs fill its 132 SMs, larger clusters leave SMs of a GPC
# idle
_QG_CLUSTER, _QG_WAVE = 2, {1: 132, 2: 66, 8: 15}
# csrc/w8a8_wgmma.cu's tiles: 128 bytes of K a stage, 64 rows a consumer
# warpgroup (one or two), 128 or 64 columns; K split over at most 8 blocks
# of a cluster (the portable cluster size); a weight tile shared by the
# blocks of at most 4 row tiles
_WG_BLOCK_K, _WG_MAX_SPLIT, _WG_MAX_SHARE = 128, 8, 4
# the token rows of a swapped tile (the wgmma's n side); the weight bytes of
# a group from which two row tiles share each weight tile at prefill; the
# H100's GPCs (a cluster's blocks share one: clusters of 2, 3 and 4 blocks
# one an SM run 66, 39 and 30 at once on its 132 SMs,
# cudaOccupancyMaxActiveClusters, PERF.md)
_WG_TOKEN_TILES, _WG_SHARE_BYTES, _GPCS = (32, 64, 80, 128), 1 << 24, 8
# csrc/w8a8_quant.cu's kernels (`Path`): the scalar fallback, the short-row
# kernel (1 to 8 warps a row, 8-warp blocks), the long-row kernel with the
# row in registers or streamed twice; at most 4 16-byte pieces a lane in
# registers, 32 warps a block, 8 blocks a row (the portable cluster size)
_Q_SCALAR, _Q_SHORT, _Q_LONG, _Q_STREAMED = 0, 1, 2, 3
_Q_VECS, _Q_SHORT_WARPS, _Q_MAX_WARPS, _Q_MAX_CLUSTER = 4, 8, 32, 8

Weights = Sequence[tuple[torch.Tensor, torch.Tensor]]


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 in f32, an IEEE division on every device, as
    the reference's quantizers write it. The divisor is a tensor: PyTorch's
    CUDA division by a Python scalar multiplies by the scalar's reciprocal,
    which moves some scales by an ulp."""
    return torch.clamp(amax, min=1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `quantize_rows`, on any device: x [..., K]
    -> (q [..., K] int8, s [...] f32)."""
    x32 = x.float()
    s = int8_scale(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def w8a8_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `w8a8_gemm_s32`, on any device: the exact
    s32 sums xq [M, K] . wq [N, K]^T. The product of the int8 values runs in
    float64: every partial sum is an integer below K * 127^2 < 2^53, so it
    is exact in any order and casts to the exact s32 sum."""
    return torch.matmul(xq.double(), wq.double().T).to(torch.int32)


def w8a8_epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The reference's epilogue of exact sums acc [M, N]: (f32(acc) * xs[m])
    * ws[n], two f32 multiplies in that order (separate ops, so nothing
    contracts them into an FMA: the kernels' `__fmul_rn` pair), rounded to
    `out_dtype`, plus the bias in that type."""
    y = ((acc.float() * xs[:, None]) * ws[None, :]).to(out_dtype)
    return y if bias is None else y + bias


def w8a8_gemm_plain(
    xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of `w8a8_gemm`, on any device: the exact sums
    (`w8a8_acc_plain`), then the reference's epilogue."""
    return w8a8_epilogue(w8a8_acc_plain(xq, wq), xs, ws, bias, out_dtype=out_dtype)


def w8a8_dense_plain(
    x: torch.Tensor, weights: Weights, biases=None, *, out_dtype: torch.dtype,
) -> list[torch.Tensor]:
    """Plain PyTorch version of `w8a8_dense` and `w8a8_qgemm`: x's rows
    quantized once, then each weight's product."""
    xq, xs = quantize_rows_plain(x)
    biases = biases if biases is not None else (None,) * len(weights)
    return [w8a8_gemm_plain(xq, xs, wq, ws, b, out_dtype=out_dtype)
            for (wq, ws), b in zip(weights, biases)]


def _off_card(what: str, tensors) -> bool:
    """True when every tensor lies on the CPU (run the plain version);
    False when all lie on one CUDA device; raises on a mix."""
    first = tensors[0]
    if first.is_cpu and all(t.is_cpu for t in tensors):
        return True
    if not first.is_cuda or any(t.device != first.device for t in tensors):
        raise ValueError(f"{what}: all tensors must be on one CUDA device (or all "
                         "on the CPU)")
    return False


# --- the route and the small-row kernel's plan (host arithmetic, reached by
# the CPU tests) -------------------------------------------------------------


def _qgemm_stride(k: int) -> int:
    """Bytes a quantized row of K takes in the small-row kernel's shared
    memory (`csrc/w8a8_gemm.cu::row_stride`)."""
    kp = -(-k // _QG_BLOCK_K) * _QG_BLOCK_K
    return kp if kp % 128 == 64 else kp + 64


def _qgemm_slice(k: int, cluster: int) -> int:
    """Bytes of K in a small-row block's slice at most, K split over a
    cluster's blocks in 64-byte blocks (`csrc/w8a8_gemm.cu::slice_max`)."""
    return -(-(-(-k // _QG_BLOCK_K)) // cluster) * _QG_BLOCK_K


def _qgemm_smem(mt: int, k: int, slots: int = 1, kc: int = _QG_UNITS[-1],
                depth: int = 1, cluster: int = 1) -> int:
    """Shared memory of a small-row block (`csrc/w8a8_gemm.cu::Layout`): the
    quantized m tile of its K slice (K split over `cluster` blocks), the
    int32 sums of the `slots` tiles it stores and their columns' scales,
    biases and places, the row scales and maxima, the
    warps' mbarriers and (on 128 bytes) their rings of `depth` stages of
    16 rows of kc + 64 bytes. The defaults are the most a row takes
    (all of K) beside the smallest ring: a stage of 128 bytes of K a
    warp."""
    ring = -(-(mt * _qgemm_stride(_qgemm_slice(k, cluster))
               + slots * (mt + 3) * _QG_TILE_ROWS * 4 + 2 * mt * 4 + _QG_WARPS * depth * 8)
             // 128) * 128
    return ring + _QG_WARPS * depth * _QG_TILE_ROWS * (kc + _QG_ROW_PAD)


def _qshort_smem(mt: int, k: int) -> int:
    """Shared memory of a short-K block (`csrc/w8a8_short_k.cu::smem_bytes`):
    the quantized m tile, the K splits' partial sums, the row scales and
    maxima, a tile's column scales and biases, and the warps' rings."""
    return (mt * _qgemm_stride(k) + _QS_WARPS * 8 * mt * 4 + 2 * mt * 4 + 2 * 64 * 4
            + _QS_WARPS * _QS_DEPTH * 32 * 32)


def _qgemm_short(k: int, ns: Sequence[int]) -> bool:
    """Whether a small-row product over weights of N `ns` takes the
    short-K kernel (csrc/w8a8_short_k.cu): rows of at most _QG_SHORT_K
    elements and a group of less than _QS_MAX_BYTES of weights. There a
    product moves a few MB and the launch's latency sets its time: the
    short-K kernel's is lower (Qwen2.5-0.5B's q/k/v, o and gate/up ran
    5-62% slower on csrc/w8a8_gemm.cu's at 8 to 32 rows on an H100,
    PERF.md); its down (K 4,864) and its head (136 MB) ran 9-32% faster
    there."""
    return k <= _QG_SHORT_K and k * sum(ns) < _QS_MAX_BYTES


def _qshort_plan(m: int, k: int, ns: Sequence[int], sms: int) -> tuple[int, int, int, int]:
    """(mt, nt8, grid_x, cluster) of a short-K launch: the m tile
    (`_qgemm_rows`); n8 tiles a block tile (8 weight rows each); the blocks
    that share the tiles, at most as many as the card holds at once (in
    whole clusters, rounded up within that, else down); and the blocks a
    cluster, which share the quantize of the m tile: 8 where each block
    takes at most two tiles, else 1.

    nt8 is the largest of 8, 4, 2, 1 that gives at least one block tile an
    SM (1 if none does): at 8 each warp owns whole 8-row tiles over all of
    K with no block barrier; below it the warps split K, which spreads a
    few-row weight over more SMs."""
    mt = _qgemm_rows(m, k)
    if mt is None:
        raise ValueError(f"w8a8_qgemm: K = {k} leaves no room for an m tile")
    per_sm = 2 if 2 * (_qshort_smem(mt, k) + _SM_RESERVED) <= _SM_SMEM else 1
    for nt8 in (8, 4, 2, 1):
        tiles = sum(-(-n // (8 * nt8)) for n in ns)
        if tiles >= sms:
            break
    cap = per_sm * sms
    blocks = min(tiles, cap)
    cluster = _QS_CLUSTER if tiles <= 2 * blocks else 1
    grid = -(-blocks // cluster) * cluster  # whole clusters, within one wave
    if grid > cap:
        grid = max(cluster, blocks // cluster * cluster)
    return mt, nt8, grid, cluster


def _qgemm_rows(m: int, k: int) -> Optional[int]:
    """Token rows an m tile of the small-row kernel holds at K: 8 for M <=
    8, else M rounded up to 16 rows and at most 64, fewer where all of K
    leaves no room beside the smallest ring (a cluster's split of K only
    deepens the ring); None when not even the smallest tile fits a
    block."""
    mt = 8 if m <= 8 else min(-(-m // 16) * 16, _QG_MAX_ROWS)
    while _qgemm_smem(mt, k) > _BLOCK_SMEM:
        if mt <= 16:
            return None
        mt -= 16
    return mt


def _route(m: int, k: int, aligned: bool) -> str:
    """The kernel an [M, K] product takes on the card: "wgmma" (quantize_rows,
    then w8a8_gemm) for more than M_STAR rows when K % 16 == 0 and the int8
    weights are 16-byte aligned (`aligned`), and for any such shape whose K
    the small-row kernel cannot hold; else "qgemm". Raises when neither takes
    the shape."""
    fits = k % 4 == 0 and _qgemm_rows(m, k) is not None
    if k % 16 == 0 and aligned and (m > M_STAR or not fits):
        return "wgmma"
    if not fits:
        raise ValueError(f"w8a8: no kernel takes K = {k} here (the small-row kernel "
                         "needs K % 4 == 0 and an m tile within a block's shared "
                         "memory; the wgmma route K % 16 == 0 and 16-byte-aligned "
                         "weights)")
    return "qgemm"


class QgemmPlan(NamedTuple):
    """A small-row launch plan (`_qgemm_plan`): the token rows an m tile,
    the bytes of K a unit, the ring stages a warp, the blocks of the grid
    (one an SM) and the blocks of a cluster."""

    mt: int
    kc: int
    depth: int
    grid: int
    cluster: int


def _qgemm_plan(m: int, k: int, ns: Sequence[int], sms: int,
                cluster: Optional[int] = None) -> QgemmPlan:
    """The launch plan of a small-row product over the weights of N `ns`
    that share x [M, K] on `sms` SMs:

    - one block an SM, in pairs (`_QG_CLUSTER`; 66 fill an H100, clusters
      of 8 fit 15, `_QG_WAVE`) that split K between them: each block
      quantizes its half of x's rows (the abs-maxima meet through
      distributed shared memory) and streams that half of K of every tile
      of the pair; a pair takes the contiguous tiles [c T / P, (c + 1) T /
      P) of its P pairs, at most one more than any other pair
      (`_qgemm_tiles`). Clusters of 8 where a pair's slice of a row of x
      gives its threads more than 2 units of 16 elements each (the 8B's
      down at 8 rows, its engine's 32 rows at K 4,096, the 1B's and the
      0.5B's down: the quantize then outweighs 12 idle SMs), one block
      alone (every block quantizes all of x) where K is at most 1,024 and
      that gives a thread at most 2 units (Qwen2.5-0.5B's head up to 16
      rows), or the `cluster` the caller asks for (1, 2 or 8: a wave of
      them);
    - tiles of 16 weight rows (the mma's A side) and the m tile of
      `_qgemm_rows`;
    - units of 512 bytes of K where each warp gets two of them at least,
      else 256, else 128, and the ring as deep as the shared memory left
      after the m tile and the sums holds (2 to 8 stages a warp; 1 where
      a block's sums leave room for no more, as a head's 67-80 tiles a
      block do at 17 to 32 rows); where not even 128-byte units give each
      warp two (Qwen2.5-0.5B's down, Llama-3.2-1B's q/k/v and o: a few
      MB, whose time is latency) the largest unit a stage holds, the
      fewest copies."""
    mt = _qgemm_rows(m, k)
    if mt is None:
        raise ValueError(f"w8a8_qgemm: K = {k} leaves no room for an m tile")
    if cluster is None:
        # a short row's block quantizes all of it where that gives a thread
        # at most 2 units of its row; else pairs, or 8 blocks where a
        # pair's slice gives a thread more than 2
        lanes = _QG_WARPS * 32 // (1 << (min(m, mt) - 1).bit_length())  # threads a row

        def units(c):
            return -(-(_qgemm_slice(k, c) // 16) // lanes)

        cluster = (1 if k <= _QG_SHORT_K and units(1) <= 2
                   else _QG_CLUSTER if units(_QG_CLUSTER) <= 2 else 8)
    # the clusters one wave holds: pairs fill the SMs (`_QG_WAVE`)
    fit = _QG_WAVE[cluster] * sms // 132
    tiles = sum(-(-n // _QG_TILE_ROWS) for n in ns)
    clusters = min(tiles, fit)
    per_cluster = -(-tiles // clusters)  # tiles a cluster at most
    slots = -(-per_cluster // cluster)  # the tiles a block owns (stores)
    # fewer than two 128-byte units a warp: latency, not bytes, sets the
    # time; the largest unit (the fewest copies) a stage can hold
    kslice = _qgemm_slice(k, cluster)
    few = per_cluster * -(-kslice // _QG_UNITS[-1]) < 2 * _QG_WARPS
    for kc in _QG_UNITS:
        depth = _QG_MAX_DEPTH
        while depth and _qgemm_smem(mt, k, slots, kc, depth, cluster) > _BLOCK_SMEM:
            depth -= 1
        if depth >= (1 if few else 2) and (
                few or per_cluster * -(-kslice // kc) >= 2 * _QG_WARPS):
            break
    if depth < 1:
        raise ValueError(f"w8a8_qgemm: {tiles} tiles at K = {k} leave no room for a ring")
    return QgemmPlan(mt, kc, depth, clusters * cluster, cluster)


def _qgemm_plan_smem(m: int, k: int, ns: Sequence[int], plan) -> int:
    """A small-row block's shared memory on `plan` (the launch asks for
    more: one block an SM)."""
    tiles = sum(-(-n // _QG_TILE_ROWS) for n in ns)
    slots = -(-(-(-tiles // (plan.grid // plan.cluster))) // plan.cluster)
    return _qgemm_smem(plan.mt, k, slots, plan.kc, plan.depth, plan.cluster)


def _qgemm_tiles(m: int, k: int, ns: Sequence[int],
                 plan) -> list[tuple[int, int, int, int, int, int]]:
    """What each warp of a small-row launch on `plan` streams, unit by
    unit: (block, warp, weight, first row of its tile, first and end byte
    of K), as csrc/w8a8_gemm.cu's kernel works it out. Cluster c of the P
    clusters takes the tiles [c T / P, (c + 1) T / P) of the T tiles of
    every weight in turn; its block of rank r takes the 64-byte K blocks
    [r B / C, (r + 1) B / C) of the B of K (C blocks a cluster); the
    block's (tile, chunk of kc bytes of its slice) units, tile by tile, go
    to its 16 warps in 16 even runs. Every m tile's blocks (the grid's y)
    repeat the map."""
    kc, grid, cluster = plan.kc, plan.grid, plan.cluster
    tiles = [-(-n // _QG_TILE_ROWS) for n in ns]
    total, nclusters, blocks64 = sum(tiles), grid // cluster, -(-k // _QG_BLOCK_K)
    out = []
    for b in range(grid):
        c, r = divmod(b, cluster)
        t0, t1 = c * total // nclusters, (c + 1) * total // nclusters
        kbeg = r * blocks64 // cluster * _QG_BLOCK_K
        kend = min(k, (r + 1) * blocks64 // cluster * _QG_BLOCK_K)
        chunks = -(-(kend - kbeg) // kc) if kend > kbeg else 0
        units = (t1 - t0) * chunks
        for w in range(_QG_WARPS):
            for u in range(w * units // _QG_WARPS, (w + 1) * units // _QG_WARPS):
                tl, ch = divmod(u, chunks)
                t, mem = t0 + tl, 0
                while t >= tiles[mem]:
                    t -= tiles[mem]
                    mem += 1
                k0 = kbeg + ch * kc
                out.append((b, w, mem, t * _QG_TILE_ROWS, k0, min(kend, k0 + kc)))
    return out


class GemmPlan(NamedTuple):
    """A wgmma-route launch plan (`_gemm_plan`): the rows a tile (64: one
    consumer warpgroup; 128: two), the columns a tile, the blocks of a
    cluster that split K, the blocks of a cluster that share each weight
    tile (one a row tile), the column tiles a band of the tile order
    (`_gemm_tiles`), one block an SM with the deepest ring (`deep`), and
    the blocks of the grid."""

    bm: int
    bn: int
    split: int
    share: int
    band: int
    deep: bool
    blocks: int


def _gemm_plan(m: int, k: int, ns: Sequence[int], sms: int) -> GemmPlan:
    """The launch plan of a wgmma-route product over the weights of N `ns`
    that share xq [M, K] on `sms` SMs (measured on an H100 with
    `tools/bench_w8a8.py --plans`, PERF.md):

    - wide: where 128-column tiles give at least half as many blocks as
      SMs (prefill, the heads, gate/up from 72 rows), a block takes its
      tile over all of K, on 64-row tiles where M fits one, else 128.
      Where the group's weights pass 16 MB, row tiles share each weight
      tile in a cluster: with 2 to 4 row tiles (the engine's verify round,
      288 rows) all of them, one block an SM where the grid fits the card
      (the 8B's engine verify down 48 µs against 71 on the order by rows);
      with more (prefill), pairs (the 8B's prefill down 357 against 420
      µs). Below 16 MB (Qwen2.5-0.5B's weights) the cluster costs more than
      it saves. Where the weights are wider than the rows (prefill's
      gate/up) the tiles go in bands of about a wave's blocks
      (`_gemm_tiles`), so each weight byte comes from HBM once, not once a
      row tile (the 8B's gate/up group 800 against 1,324 µs);
    - few rows: where one tile of 32, 64, 80 or 128 token rows holds M and
      128 weight rows split K over a cluster of 2 to 8 blocks (each at
      least four of K's 128-byte chunks, the grid within one wave of
      clusters, one block an SM: a GPC of the card's `_GPCS` leaves up to
      split - 1 of its SMs idle) fill at least half the card: Llama-3.1-8B's
      verify round (72 rows) and engine step (32 rows). The product is
      swapped (the weight rows are the wgmma's 64-row side, the tokens its
      n side), so 72 rows cost 80 columns of products, not 128 rows; each
      weight byte leaves L2 once, xq's re-reads stay M / 128 of the weights;
    - else (Qwen2.5-0.5B's narrow weights) 64 x 64 tiles, and K splits over
      the most blocks of a cluster (a power of two, as above) that keep the
      grid within an SM a block: the verify round's down (72 x 4,864 ->
      896) takes 28 tiles x 4 splits, where 128 x 128 tiles gave 7 blocks;
      64-row tiles beat 128-row ones at 72 to 288 rows there."""
    chunks = -(-k // _WG_BLOCK_K)
    most = min(_WG_MAX_SPLIT, chunks // 4)
    bm = 64 if m <= 64 else 128
    rows = -(-m // bm)
    tiles = sum(-(-n // 128) for n in ns)
    if 2 * rows * tiles >= sms:
        share = 1
        if sum(ns) * k >= _WG_SHARE_BYTES:  # two or more row tiles are 128 rows each
            share = rows if rows <= _WG_MAX_SHARE else 2
        deep = share > 1 and rows * tiles <= sms
        band = tiles
        if rows > share and sum(ns) > m:
            band = max(1, min(tiles, (1 if deep else 2) * sms // rows))
        return GemmPlan(bm, 128, 1, share, band, deep, rows * tiles)
    if m <= _WG_TOKEN_TILES[-1]:
        split = 1
        while split < most and tiles * (split + 1) <= sms - _GPCS * split:
            split += 1
        if split > 1 and 2 * split * tiles >= sms:
            tok = next(t for t in _WG_TOKEN_TILES if m <= t)
            return GemmPlan(tok, 128, split, 1, tiles, True, tiles * split)
    tiles = -(-m // 64) * sum(-(-n // 64) for n in ns)
    split = 1
    while 2 * split <= most and 2 * split * tiles <= sms:
        split *= 2
    return GemmPlan(64, 64, split, 1, sum(-(-n // 64) for n in ns), False, tiles * split)


def _few_rows(plan) -> bool:
    """Whether a plan is one of the plans for few rows (64 x 64 tiles, or K
    split over a cluster): the launches `few_tile_launches` counts."""
    return plan[1] == 64 or plan[2] > 1


PLAN_KINDS = ("wide", "bands", "shared", "few_rows", "few_tiles")


def _plan_kind(plan, ns: Sequence[int]) -> str:
    """The kind of a plan over weights of N `ns`, as `plan_launches` counts
    it: "few_tiles" (64 x 64 tiles), "few_rows" (128 weight rows by the
    token rows, K split), "bands" (wide tiles in bands narrower than the
    column tiles, a weight tile shared or not), "shared" (a weight tile
    shared by a cluster's row tiles, in the order by rows), "wide"."""
    bn, split, share, band = plan[1:5]
    if bn == 64:
        return "few_tiles"
    if split > 1:
        return "few_rows"
    if band < sum(-(-n // bn) for n in ns):
        return "bands"
    return "shared" if share > 1 else "wide"


def _gemm_tiles(m: int, k: int, ns: Sequence[int],
                plan) -> list[tuple[int, int, int, int, int]]:
    """What each block of a launch on `plan` computes, by block index:
    (weight, row tile, column tile of that weight, first and end 128-byte
    chunk of K), as csrc/w8a8_wgmma.cu's kernel works it out. A cluster of
    split x share consecutive blocks takes one column tile (the blocks of a
    split one range of K each, those of a shared weight tile one row tile
    each); the clusters walk bands of `band` column tiles, every column of
    a band for one group of `share` row tiles, then the next group. Rows
    past M make no tile: a shared weight tile's last group may hold some."""
    bm, bn, split, share, band = plan[:5]
    chunks = -(-k // _WG_BLOCK_K)
    tiles = [-(-n // bn) for n in ns]
    ntiles = sum(tiles)
    groups = -(-(-(-m // bm)) // share)
    band = min(band, ntiles)
    cluster = split * share
    out = []
    for b in range(ntiles * groups * cluster):
        rank, q = b % cluster, b // cluster
        which, j = divmod(q, band * groups)
        bw = min(band, ntiles - which * band)
        t, mem = which * band + j % bw, 0
        while t >= tiles[mem]:
            t -= tiles[mem]
            mem += 1
        row = j // bw * share + (rank if share > 1 else 0)
        s = rank if split > 1 else 0
        out.append((mem, row, t, s * chunks // split, (s + 1) * chunks // split))
    return out


def _pdl(k: int, plan) -> bool:
    """Whether a wgmma-route launch goes out under programmatic dependent
    launch (its start overlapping the end of the kernel before it): for K
    under 4,096 bytes, and on the plans of one block an SM (`deep`). On an
    H100 (`tools/bench_w8a8.py`, PERF.md), after an elementwise kernel and
    `quantize_rows` as in a layer, it sped up every product at K 896 and
    slowed every one of two blocks an SM at K 4,864 (the 0.5B's split
    verify down, the engine's and a B = 1 prefill's down); alone it slowed
    prefill's down by 4%; on the 8B's deep plans (the
    verify round's down and o, the engine's down and verify down) it saved
    1.0 to 1.6 µs each."""
    return k < 32 * _WG_BLOCK_K or bool(plan[5])


@functools.lru_cache(maxsize=256)
def _quant_plan(m: int, k: int, in_kind: int, sms: int,
                aligned: bool = True) -> tuple[int, int, int]:
    """(path, warps, cluster) of a `quantize_rows` launch over x [M, K] of
    `in_kind` (`_IN_KINDS`) on `sms` SMs, x 16-byte aligned or not
    (`csrc/w8a8_quant.cu`'s paths):

    - a K that is not a whole number of 16-byte pieces, or an x off 16
      bytes: the scalar kernel, one warp a row (no model's product);
    - a row of at most 8 warps x 32 lanes x 4 pieces (8,192 bf16, 4,096
      f32): the short-row kernel on the fewest warps (1, 2, 4, 8) that
      hold it at 4 pieces a lane;
    - a longer row: the long-row kernel on the fewest blocks a row (a
      cluster of 1, 2, 4, 8) that hold it in registers, 32 warps x 32
      lanes x 4 pieces a block, and each block on the fewest warps that
      hold its slice. Where one block holds the row and the rows outnumber
      the SMs, two blocks a row when that evens the SMs' load by a tenth
      or more (the most rows' worth on one SM, all blocks resident):
      Llama-3.1-8B's down (K 14,336) at the engine's verify round's 288
      rows takes 2 blocks of 7 warps a row, every other row count one of
      14. Measured on an H100 (`tools/bench_w8a8.py` `quant`, PERF.md):
      two blocks a row 7.45 us against one's 8.24 at 288 rows; at 32 and
      72 rows, 2 to 8 blocks a row gain nothing or lose up to 1.1 us (the
      cluster barrier), at 4,096 rows they lose 4% to 93%. Past what 8
      blocks hold (262,144 bf16), 8 blocks of 32 warps stream the row and
      read it twice."""
    elems = 16 // (2 if in_kind == _IN_KINDS[torch.bfloat16] else 4)
    if not aligned or k % elems:
        return _Q_SCALAR, 1, 1
    pieces, warp = k // elems, 32 * _Q_VECS
    if pieces <= _Q_SHORT_WARPS * warp:
        g = 1
        while g * warp < pieces:
            g *= 2
        return _Q_SHORT, g, 1
    block = _Q_MAX_WARPS * warp
    cluster = 1
    while cluster < _Q_MAX_CLUSTER and cluster * block < pieces:
        cluster *= 2
    if cluster == 1 and m > sms and -(-2 * m // sms) / 2 <= 0.9 * -(-m // sms):
        cluster = 2
    per = -(-pieces // cluster)
    if per > block:
        return _Q_STREAMED, _Q_MAX_WARPS, cluster
    return _Q_LONG, -(-per // warp), cluster


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# --- the kernels' wrappers ----------------------------------------------------


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (bf16 or f32, contiguous) -> (q [M, K] int8, s [M] f32).

    On CUDA tensors this launches csrc/w8a8_quant.cu on the plan
    `_quant_plan` gives (or raises); on CPU tensors it runs
    `quantize_rows_plain`. The checks come cheapest first: the wrapper
    sits on every large-row product."""
    shape = x.shape
    kind = _IN_KINDS.get(x.dtype)
    if len(shape) != 2:
        raise ValueError(f"quantize_rows: x must be [M, K], not {tuple(shape)}")
    if kind is None:
        raise TypeError(f"quantize_rows: x must be bf16 or f32, not {x.dtype}")
    if _off_card("quantize_rows", (x,)):
        return quantize_rows_plain(x)
    if not x.is_contiguous():
        raise ValueError("quantize_rows: x must be contiguous")
    m, k = shape
    q = torch.empty(shape, dtype=torch.int8, device=x.device)
    s = torch.empty(m, dtype=torch.float32, device=x.device)
    if m and k:
        index = x.get_device()
        path, warps, cluster = _quant_plan(m, k, kind, _sms(index), x.data_ptr() % 16 == 0)
        _kernels.launch("ragtorch_w8a8_quantize_rows", index, x.data_ptr(), q.data_ptr(),
                        s.data_ptr(), m, k, kind, path, warps, cluster)
        if not torch.cuda.is_current_stream_capturing():
            quantize_rows.launches += 1
            quantize_rows.long_row_launches += path >= _Q_LONG
    return q, s


def _check_weights(what: str, k: int, weights: Weights, biases, out_dtype) -> list:
    """Each (wq [N, K] int8, ws [N] f32) and bias ([N] of out_dtype, or None)
    checked; returns the biases as a list."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: out_dtype must be bf16 or f32, not {out_dtype}")
    biases = list(biases) if biases is not None else [None] * len(weights)
    if not 1 <= len(weights) <= 3 or len(biases) != len(weights):
        raise ValueError(f"{what}: 1 to 3 weights and as many biases, not "
                         f"{len(weights)} and {len(biases)}")
    for (wq, ws), b in zip(weights, biases):
        if wq.dim() != 2 or wq.shape[1] != k:
            raise ValueError(f"{what}: a weight {tuple(wq.shape)} must be [N, K] with "
                             f"K = {k}")
        n = wq.shape[0]
        if ws.shape != (n,) or (b is not None and b.shape != (n,)):
            raise ValueError(f"{what}: scales {tuple(ws.shape)} must be [{n}], a bias "
                             f"[{n}]")
        if wq.dtype != torch.int8 or ws.dtype != torch.float32:
            raise TypeError(f"{what}: a weight must be int8 with float32 scales, not "
                            f"{wq.dtype}, {ws.dtype}")
        if b is not None and b.dtype != out_dtype:
            raise TypeError(f"{what}: out_dtype must be bf16 or f32 and the bias of "
                            f"that type, not {out_dtype}, {b.dtype}")
    return biases


def _gemm_launch(xq, xs, weights, biases, out_dtype) -> list[torch.Tensor]:
    """The wgmma GEMM over 1 to 3 weights sharing xq, one launch on the
    plan `_gemm_plan` gives; out_dtype int32 is the s32 kind (xs, the
    scales and the biases None), under programmatic dependent launch where
    `_pdl` says so."""
    m, k = xq.shape
    outs = [torch.empty((m, wq.shape[0]), dtype=out_dtype, device=xq.device)
            for wq, _ in weights]
    live = [i for i, (wq, _) in enumerate(weights) if wq.shape[0]]
    if m and live:
        index = xq.get_device()
        ns = [weights[i][0].shape[0] for i in live]
        plan = _gemm_plan(m, k, ns, _sms(index))
        ptrs = ctypes.c_void_p * 3
        _kernels.launch(
            "ragtorch_w8a8_gemm_wgmma", index, xq.data_ptr(),
            None if xs is None else xs.data_ptr(),
            ptrs(*(weights[i][0].data_ptr() for i in live)),
            ptrs(*(None if weights[i][1] is None else weights[i][1].data_ptr()
                   for i in live)),
            ptrs(*(None if biases[i] is None else biases[i].data_ptr() for i in live)),
            ptrs(*(outs[i].data_ptr() for i in live)), (ctypes.c_int * 3)(*ns),
            len(live), m, k, _OUT_KINDS[out_dtype], *plan[:5], int(plan[5]),
            int(_pdl(k, plan)))
        if not torch.cuda.is_current_stream_capturing():
            fn = w8a8_gemm_s32 if out_dtype == torch.int32 else w8a8_gemm
            fn.launches += 1
            if fn is w8a8_gemm_s32:
                fn.wgmma_launches += 1
            fn.few_tile_launches += _few_rows(plan)
            fn.plan_launches[_plan_kind(plan, ns)] += 1
    return outs


def w8a8_gemm(
    xq: torch.Tensor,  # [M, K] int8
    xs: torch.Tensor,  # [M] f32
    wq: torch.Tensor,  # [N, K] int8, K contiguous
    ws: torch.Tensor,  # [N] f32
    bias: Optional[torch.Tensor] = None,  # [N] of out_dtype
    *,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """(f32(xq . wq^T) * xs[:, None]) * ws[None, :] rounded to `out_dtype`
    (bf16 or f32), plus `bias` in `out_dtype` -> [M, N]: the large-row
    route's GEMM.

    On CUDA tensors this launches csrc/w8a8_wgmma.cu (or raises: K must be
    a multiple of 16 and xq, wq 16-byte aligned); on CPU tensors it runs
    `w8a8_gemm_plain`."""
    if xq.dim() != 2:
        raise ValueError(f"w8a8_gemm: xq {tuple(xq.shape)} must be [M, K]")
    m, k = xq.shape
    (bias,) = _check_weights("w8a8_gemm", k, [(wq, ws)], [bias], out_dtype)
    if xs.shape != (m,):
        raise ValueError(f"w8a8_gemm: xs {tuple(xs.shape)} must be [{m}]")
    if xq.dtype != torch.int8 or xs.dtype != torch.float32:
        raise TypeError(f"w8a8_gemm: xq must be int8 and xs float32, not {xq.dtype}, "
                        f"{xs.dtype}")
    tensors = (xq, xs, wq, ws) if bias is None else (xq, xs, wq, ws, bias)
    if _off_card("w8a8_gemm", tensors):
        return w8a8_gemm_plain(xq, xs, wq, ws, bias, out_dtype=out_dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w8a8_gemm: every tensor must be contiguous")
    if k % 16 or (xq.data_ptr() | wq.data_ptr()) % 16:
        raise ValueError(f"w8a8_gemm: TMA loads 16-byte rows: K ({k}) must be a "
                         "multiple of 16 and xq, wq 16-byte aligned")
    return _gemm_launch(xq, xs, [(wq, ws)], [bias], out_dtype)[0]


def _qgemm_launch(x, weights, biases, out_dtype) -> list[torch.Tensor]:
    """The small-row kernel over 1 to 3 weights; int8 x with out_dtype
    int32 is the s32 kind (scales and biases unread)."""
    m, k = x.shape
    if x.data_ptr() % (4 * x.element_size()):  # the kernel reads 4 elements at once
        x = x.clone()
    outs = [torch.empty((m, wq.shape[0]), dtype=out_dtype, device=x.device)
            for wq, _ in weights]
    if m:
        index = x.get_device()
        ns = [wq.shape[0] for wq, _ in weights]
        short = _qgemm_short(k, ns)
        plan = (_qshort_plan if short else _qgemm_plan)(m, k, ns, _sms(index))
        ptrs = ctypes.c_void_p * 3
        _kernels.launch(
            "ragtorch_w8a8_qshort" if short else "ragtorch_w8a8_qgemm", index, x.data_ptr(),
            ptrs(*(wq.data_ptr() for wq, _ in weights)),
            ptrs(*(None if ws is None else ws.data_ptr() for _, ws in weights)),
            ptrs(*(None if b is None else b.data_ptr() for b in biases)),
            ptrs(*(o.data_ptr() for o in outs)), (ctypes.c_int * 3)(*ns),
            len(weights), m, k, _S32 if x.dtype == torch.int8 else _IN_KINDS[x.dtype],
            _OUT_KINDS[out_dtype], *plan)
        if not torch.cuda.is_current_stream_capturing():
            fn = w8a8_gemm_s32 if out_dtype == torch.int32 else w8a8_qgemm
            fn.launches += 1
            fn.short_launches += short
    return outs


def _check_group(what: str, x, weights: Weights, biases, out_dtype) -> tuple[list, bool]:
    """The checks of a grouped entry -> (the biases as a list, True when
    every tensor lies on the CPU)."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [M, K], not {tuple(x.shape)}")
    if x.dtype not in _IN_KINDS:
        raise TypeError(f"{what}: x must be bf16 or f32, not {x.dtype}")
    biases = _check_weights(what, x.shape[1], weights, biases, out_dtype)
    tensors = [x, *(t for w in weights for t in w), *(b for b in biases if b is not None)]
    if _off_card(what, tensors):
        return biases, True
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every tensor must be contiguous")
    if any(wq.data_ptr() % 4 for wq, _ in weights):
        raise ValueError(f"{what}: every weight must be 4-byte aligned")
    return biases, False


def w8a8_qgemm(
    x: torch.Tensor,  # [M, K] bf16 or f32
    weights: Weights,  # 1 to 3 of (wq [N_i, K] int8, ws [N_i] f32)
    biases=None,  # None, or one [N_i] of out_dtype (or None) a weight
    *,
    out_dtype: torch.dtype,
) -> list[torch.Tensor]:
    """x's rows quantized, then each weight's W8A8 product -> [M, N_i] of
    `out_dtype` each: the small-row route, one launch for the group.

    On CUDA tensors this launches csrc/w8a8_short_k.cu where `_qgemm_short`
    says so, else csrc/w8a8_gemm.cu (or raises: K must be a multiple of 4,
    the weights 4-byte aligned, and an m tile of x must fit a block); on
    CPU tensors it runs `w8a8_dense_plain`."""
    biases, on_cpu = _check_group("w8a8_qgemm", x, weights, biases, out_dtype)
    if on_cpu:
        return w8a8_dense_plain(x, weights, biases, out_dtype=out_dtype)
    k = x.shape[1]
    if k % 4:
        raise ValueError(f"w8a8_qgemm: the kernel copies 4-byte words: K ({k}) must "
                         "be a multiple of 4")
    if _qgemm_rows(x.shape[0], k) is None:
        raise ValueError(f"w8a8_qgemm: K = {k} leaves no room for an m tile")
    return _qgemm_launch(x, weights, biases, out_dtype)


def w8a8_dense(
    x: torch.Tensor,  # [M, K] bf16 or f32
    weights: Weights,  # 1 to 3 of (wq [N_i, K] int8, ws [N_i] f32), sharing x
    biases=None,  # None, or one [N_i] of out_dtype (or None) a weight
    *,
    out_dtype: torch.dtype,
) -> list[torch.Tensor]:
    """The W8A8 `dense` of each weight over the same x -> [M, N_i] of
    `out_dtype` each, as the reference computes it for each weight
    (`quantize_act_rows` and `_qdense`).

    On CUDA tensors `_route` picks the kernels: `quantize_rows` once and
    one `w8a8_gemm` launch for the group for large row counts, else one
    `w8a8_qgemm` launch for the group. On CPU tensors it runs
    `w8a8_dense_plain`."""
    biases, on_cpu = _check_group("w8a8_dense", x, weights, biases, out_dtype)
    if on_cpu:
        return w8a8_dense_plain(x, weights, biases, out_dtype=out_dtype)
    m, k = x.shape
    aligned = all(wq.data_ptr() % 16 == 0 for wq, _ in weights)
    if _route(m, k, aligned) == "qgemm":
        return _qgemm_launch(x, weights, biases, out_dtype)
    xq, xs = quantize_rows(x)
    return _gemm_launch(xq, xs, weights, biases, out_dtype)


def w8a8_gemm_s32(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact s32 sums xq [M, K] int8 . wq [N, K]^T int8 -> [M, N] int32,
    before any scale: a row-parallel shard's partial.

    On CUDA tensors this launches the s32 kind of the kernel `_route`
    picks (or raises: K must be a multiple of 16 and xq, wq 16-byte
    aligned): the small-row kernel with int8 rows in, or the wgmma GEMM;
    on CPU tensors it runs `w8a8_acc_plain`."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"w8a8_gemm_s32: xq {tuple(xq.shape)} and wq {tuple(wq.shape)} "
                         "must be [M, K] and [N, K]")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"w8a8_gemm_s32: xq and wq must be int8, not {xq.dtype}, {wq.dtype}")
    if _off_card("w8a8_gemm_s32", (xq, wq)):
        return w8a8_acc_plain(xq, wq)
    if not (xq.is_contiguous() and wq.is_contiguous()):
        raise ValueError("w8a8_gemm_s32: xq and wq must be contiguous")
    m, k = xq.shape
    if k % 16 or (xq.data_ptr() | wq.data_ptr()) % 16:
        raise ValueError(f"w8a8_gemm_s32: K ({k}) must be a multiple of 16 and xq, wq "
                         "16-byte aligned")
    if _route(m, k, True) == "qgemm":
        return _qgemm_launch(xq, [(wq, None)], [None], torch.int32)[0]
    return _gemm_launch(xq, None, [(wq, None)], [None], torch.int32)[0]


def w8a8_row_dense(
    xs: Sequence[torch.Tensor],  # tp slices [M, K_j] (bf16 or f32) of the rows
    wqs: Sequence[torch.Tensor],  # the matching [N, K_j] int8 row shards
    ws: torch.Tensor,  # [N] f32: a row split keeps the scales whole
    bias: Optional[torch.Tensor] = None,  # [N] of out_dtype
    *,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """The W8A8 `dense` of a row-parallel product -> [M, N] of `out_dtype`
    on the first slice's device, bit for bit the unsplit `w8a8_dense`.

    The reference's `_qdense` under a row split: the abs-max runs over the
    whole row, so the slices are joined on the first device and quantized
    once (`quantize_rows`: on the card its kernel; a per-shard scale would
    change the tokens); each shard multiplies its columns of the int8 rows
    by its weight rows into exact s32 (`w8a8_gemm_s32`, on its device); the
    partials are summed in int32 in position order (exact: the reference
    psums the int32 dot); then the epilogue once (`w8a8_epilogue`). The
    f32 outputs of the shards could not be summed instead: an s32 partial
    past 2^24 (down at tp = 2 reaches 3.9e7) does not survive the cast."""
    front = xs[0].device
    x = torch.cat([p.to(front) for p in xs], dim=1) if len(xs) > 1 else xs[0]
    if sum(wq.shape[1] for wq in wqs) != x.shape[1]:
        raise ValueError(f"w8a8_row_dense: the shards take K = "
                         f"{sum(wq.shape[1] for wq in wqs)}, the rows have {x.shape[1]}")
    xq, xscale = quantize_rows(x.contiguous())
    parts, k0 = [], 0
    for wq in wqs:
        kj = wq.shape[1]
        xj = xq[:, k0:k0 + kj].to(wq.device).contiguous()
        if xj.data_ptr() % 16:  # a one-row slice is a view at byte k0
            xj = xj.clone()
        parts.append(w8a8_gemm_s32(xj, wq))
        k0 += kj
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(front)
    return w8a8_epilogue(acc, xscale, ws.to(front), bias, out_dtype=out_dtype)


# kernel launches, for chip_smoke.py: a call under a CUDA graph capture
# records the launch into the graph and runs nothing, so it counts nothing
quantize_rows.launches = 0
quantize_rows.long_row_launches = 0
w8a8_gemm.launches = 0
w8a8_qgemm.launches = 0
w8a8_qgemm.short_launches = 0
w8a8_gemm_s32.short_launches = 0
w8a8_gemm_s32.launches = 0
w8a8_gemm_s32.wgmma_launches = 0
w8a8_gemm.few_tile_launches = 0
w8a8_gemm_s32.few_tile_launches = 0
# of the wgmma launches of either kind, by plan kind (`_plan_kind`)
w8a8_gemm.plan_launches = dict.fromkeys(PLAN_KINDS, 0)
w8a8_gemm_s32.plan_launches = dict.fromkeys(PLAN_KINDS, 0)
