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
  `quantize_rows` (`csrc/w8a8_quant.cu`, one warp a row), then `w8a8_gemm`
  (`csrc/w8a8_wgmma.cu`: s8 wgmma fed by TMA) for each weight;
- everything else (K % 4 == 0): `w8a8_qgemm` (`csrc/w8a8_gemm.cu`), the
  quantize and the GEMM of up to three weights that share x (q/k/v,
  gate/up) in one launch.

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
(`quantize_rows.launches`, `w8a8_gemm.launches`, `w8a8_qgemm.launches`,
and for the s32 kind `w8a8_gemm_s32.launches`, of which
`w8a8_gemm_s32.wgmma_launches` took the wgmma route): a
call under a capture records its kernel into the graph and counts nothing,
as the K7 wrappers do (`ops/kv.py`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _kernels

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_S32 = 2  # the s32 kind: int8 rows in (the small-row kernel), int32 sums out

# rows above which a product takes the wgmma route: where the two routes'
# times for a Qwen2.5-0.5B layer cross, between 32 and 48 rows, on an H100
# 80GB HBM3 at 700 W (tools/bench_w8a8.py --sweep; PERF.md)
M_STAR = 32
# csrc/w8a8_gemm.cu's block: 8 warps, rings of 8 slots of 32 x 32 bytes, K
# in 64-byte blocks, m tiles of at most 64 rows, clusters of 8 blocks; the
# card's shared memory a block may take and an SM holds (1 KB of it
# reserved a block)
_QG_WARPS, _QG_DEPTH, _QG_BLOCK_K, _QG_MAX_ROWS, _QG_CLUSTER = 8, 8, 64, 64, 8
_BLOCK_SMEM, _SM_SMEM, _SM_RESERVED = 232_448, 233_472, 1024

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


def _counted(fn) -> None:
    if not torch.cuda.is_current_stream_capturing():
        fn.launches += 1


# --- the route and the small-row kernel's plan (host arithmetic, reached by
# the CPU tests) -------------------------------------------------------------


def _qgemm_stride(k: int) -> int:
    """Bytes a quantized row of K takes in the small-row kernel's shared
    memory (`csrc/w8a8_gemm.cu::row_stride`)."""
    kp = -(-k // _QG_BLOCK_K) * _QG_BLOCK_K
    return kp if kp % 128 == 64 else kp + 64


def _qgemm_smem(mt: int, k: int) -> int:
    """Shared memory of a small-row block (`csrc/w8a8_gemm.cu::smem_bytes`)."""
    return (mt * _qgemm_stride(k) + _QG_WARPS * 8 * mt * 4 + 2 * mt * 4 + 2 * 64 * 4
            + _QG_WARPS * _QG_DEPTH * 32 * 32)


def _qgemm_rows(m: int, k: int) -> Optional[int]:
    """Token rows an m tile of the small-row kernel holds at K: 8 for M <=
    8, else M rounded up to 16 rows and at most 64, fewer where K leaves no
    room; None when not even the smallest tile fits a block."""
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


def _qgemm_plan(m: int, k: int, ns: Sequence[int],
                sms: int) -> tuple[int, int, int, int]:
    """(mt, nt8, grid_x, cluster) of a small-row launch: the m tile; n8
    tiles a block tile (8 weight rows each); the blocks that share the
    tiles, at most as many as the card holds at once (in whole clusters,
    rounded up within that, else down); and the blocks a
    cluster, which share the quantize of the m tile: 8 where each block
    takes at most two tiles, else 1 (a block quantizes once, however many
    tiles it takes; on an H100 a cluster of blocks that loop over many
    tiles, as the head's do, measured slower: PERF.md). The grid is whole
    clusters.

    nt8 is the largest of 8, 4, 2, 1 that gives at least one block tile an
    SM (1 if none does): at 8 each warp owns whole 8-row tiles over all of
    K with no block barrier; below it the warps split K, which spreads a
    few-row weight over more SMs."""
    mt = _qgemm_rows(m, k)
    if mt is None:
        raise ValueError(f"w8a8_qgemm: K = {k} leaves no room for an m tile")
    per_sm = 2 if 2 * (_qgemm_smem(mt, k) + _SM_RESERVED) <= _SM_SMEM else 1
    for nt8 in (8, 4, 2, 1):
        tiles = sum(-(-n // (8 * nt8)) for n in ns)
        if tiles >= sms:
            break
    cap = per_sm * sms
    blocks = min(tiles, cap)
    cluster = _QG_CLUSTER if tiles <= 2 * blocks else 1
    grid = -(-blocks // cluster) * cluster  # whole clusters, within one wave
    if grid > cap:
        grid = max(cluster, blocks // cluster * cluster)
    return mt, nt8, grid, cluster


@functools.lru_cache(maxsize=16)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# --- the kernels' wrappers ----------------------------------------------------


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (bf16 or f32, contiguous) -> (q [M, K] int8, s [M] f32).

    On CUDA tensors this launches csrc/w8a8_quant.cu (or raises); on CPU
    tensors it runs `quantize_rows_plain`. The checks come cheapest first:
    the wrapper sits on every large-row product."""
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
        _kernels.launch("ragtorch_w8a8_quantize_rows", x.get_device(), x.data_ptr(),
                        q.data_ptr(), s.data_ptr(), m, k, kind)
        _counted(quantize_rows)
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


def _gemm_launch(xq, xs, wq, ws, bias, out_dtype) -> torch.Tensor:
    """The wgmma GEMM; out_dtype int32 is the s32 kind (xs, ws, bias None)."""
    m, k = xq.shape
    n = wq.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        _kernels.launch("ragtorch_w8a8_gemm_wgmma", xq.get_device(), xq.data_ptr(),
                        None if xs is None else xs.data_ptr(), wq.data_ptr(),
                        None if ws is None else ws.data_ptr(),
                        None if bias is None else bias.data_ptr(), out.data_ptr(),
                        m, n, k, _OUT_KINDS[out_dtype])
        _counted(w8a8_gemm_s32 if out_dtype == torch.int32 else w8a8_gemm)
        if out_dtype == torch.int32 and not torch.cuda.is_current_stream_capturing():
            w8a8_gemm_s32.wgmma_launches += 1
    return out


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
    return _gemm_launch(xq, xs, wq, ws, bias, out_dtype)


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
        mt, nt8, grid_x, cluster = _qgemm_plan(m, k, ns, _sms(index))
        ptrs = ctypes.c_void_p * 3
        _kernels.launch(
            "ragtorch_w8a8_qgemm", index, x.data_ptr(),
            ptrs(*(wq.data_ptr() for wq, _ in weights)),
            ptrs(*(None if ws is None else ws.data_ptr() for _, ws in weights)),
            ptrs(*(None if b is None else b.data_ptr() for b in biases)),
            ptrs(*(o.data_ptr() for o in outs)), (ctypes.c_int * 3)(*ns),
            len(weights), m, k, _S32 if x.dtype == torch.int8 else _IN_KINDS[x.dtype],
            _OUT_KINDS[out_dtype], mt, nt8, grid_x, cluster)
        _counted(w8a8_gemm_s32 if out_dtype == torch.int32 else w8a8_qgemm)
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

    On CUDA tensors this launches csrc/w8a8_gemm.cu (or raises: K must be a
    multiple of 4, the weights 4-byte aligned, and an m tile of x must fit a
    block); on CPU tensors it runs `w8a8_dense_plain`."""
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
    `w8a8_gemm` per weight for large row counts, else one `w8a8_qgemm`
    launch for the group. On CPU tensors it runs `w8a8_dense_plain`."""
    biases, on_cpu = _check_group("w8a8_dense", x, weights, biases, out_dtype)
    if on_cpu:
        return w8a8_dense_plain(x, weights, biases, out_dtype=out_dtype)
    m, k = x.shape
    aligned = all(wq.data_ptr() % 16 == 0 for wq, _ in weights)
    if _route(m, k, aligned) == "qgemm":
        return _qgemm_launch(x, weights, biases, out_dtype)
    xq, xs = quantize_rows(x)
    return [_gemm_launch(xq, xs, wq, ws, b, out_dtype)
            for (wq, ws), b in zip(weights, biases)]


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
    return _gemm_launch(xq, None, wq, None, None, torch.int32)


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
w8a8_gemm.launches = 0
w8a8_qgemm.launches = 0
w8a8_gemm_s32.launches = 0
w8a8_gemm_s32.wgmma_launches = 0
