"""W8A8-dynamic int8 products: the activation quantize and the s8 GEMM.

The reference computes both in XLA, not in Pallas
(`rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows` :80-89
and `_qdense` :92-100, and the int8 heads of `models/qwen.py::_logits`
:309-327). PyTorch has no call that computes them at decode shapes:
`torch._int_mm` wants more than 16 rows, and an f32 product of int8
values stops being exact once K * 127^2 passes 2^24. So both are kernels
written by hand for Hopper:

- `quantize_rows` (`csrc/w8a8_quant.cu`): per row of x [M, K],
  s = max(max|x|, 1e-8) / 127 and q = clip(rint(x / s), -127, 127),
  int8 q and f32 s, in one launch;
- `w8a8_gemm` (`csrc/w8a8_gemm.cu`): the exact s32 sum of xq [M, K] by the
  weight [N, K] (K contiguous: the reference's [in, out] weight
  transposed), then (f32(acc) * xs[m]) * s[n] rounded to the output type,
  plus the bias in that type.

On CUDA tensors each wrapper launches its kernel (or raises: a failed
build or launch is never replaced by the plain version); on CPU tensors it
runs `quantize_rows_plain` / `w8a8_gemm_plain`, the kernels' oracles,
which the tests hold to the JAX package bit for bit. Each wrapper counts
the launches it makes outside a CUDA graph capture (`<wrapper>.launches`):
a call under a capture records its kernel into the graph and counts
nothing, as the K7 wrappers do (`ops/kv.py`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _kernels

_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}


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


def w8a8_gemm_plain(
    xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None, *, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of `w8a8_gemm`, on any device. The product of
    the int8 values runs in float64: every partial sum is an integer below
    K * 127^2 < 2^53, so it is exact in any order and casts to the exact
    s32 sum. Then the reference's epilogue."""
    acc = torch.matmul(xq.double(), wq.double().T).to(torch.int32)
    y = ((acc.float() * xs[:, None]) * ws[None, :]).to(out_dtype)
    return y if bias is None else y + bias


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


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (bf16 or f32, contiguous) -> (q [M, K] int8, s [M] f32).

    On CUDA tensors this launches csrc/w8a8_quant.cu (or raises); on CPU
    tensors it runs `quantize_rows_plain`. The checks come cheapest first:
    the wrapper sits on every eager projection."""
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
        if not torch.cuda.is_current_stream_capturing():
            quantize_rows.launches += 1
    return q, s


@functools.lru_cache(maxsize=1024)
def _splits(m: int, n: int, k: int, index: int) -> int:
    """The kernel's K splits for an [m, n, k] product (its own rule, asked
    once per shape): the wrapper sizes the split scratch from it."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return int(_kernels.load_library().ragtorch_w8a8_splits(m, n, k, sms))


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
    (bf16 or f32), plus `bias` in `out_dtype` -> [M, N].

    On CUDA tensors this launches csrc/w8a8_gemm.cu (or raises); on CPU
    tensors it runs `w8a8_gemm_plain`."""
    xshape, wshape = xq.shape, wq.shape
    if len(xshape) != 2 or len(wshape) != 2 or xshape[1] != wshape[1]:
        raise ValueError(f"w8a8_gemm: xq {tuple(xshape)} must be [M, K] and wq "
                         f"{tuple(wshape)} [N, K]")
    m, k = xshape
    n = wshape[0]
    if xs.shape != (m,) or ws.shape != (n,) or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"w8a8_gemm: scales {tuple(xs.shape)}, {tuple(ws.shape)} must be "
                         f"[{m}] and [{n}], a bias [{n}]")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"w8a8_gemm: xq and wq must be int8, not {xq.dtype}, {wq.dtype}")
    if xs.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError("w8a8_gemm: the scales must be float32")
    kind = _OUT_KINDS.get(out_dtype)
    if kind is None or (bias is not None and bias.dtype != out_dtype):
        raise TypeError(f"w8a8_gemm: out_dtype must be bf16 or f32 and the bias of "
                        f"that type, not {out_dtype}, {None if bias is None else bias.dtype}")
    tensors = (xq, xs, wq, ws) if bias is None else (xq, xs, wq, ws, bias)
    if _off_card("w8a8_gemm", tensors):
        return w8a8_gemm_plain(xq, xs, wq, ws, bias, out_dtype=out_dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("w8a8_gemm: every tensor must be contiguous")
    xp, wp = xq.data_ptr(), wq.data_ptr()
    if k % 4 or (xp | wp) % 4:
        raise ValueError(f"w8a8_gemm: the kernel copies 4-byte words: K ({k}) must be "
                         "a multiple of 4 and xq, wq 4-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m and n:
        index = xq.get_device()
        splits = _splits(m, n, k, index)
        part = (torch.empty((splits, m, n), dtype=torch.int32, device=xq.device)
                if splits > 1 else None)
        _kernels.launch("ragtorch_w8a8_gemm", index, xp, xs.data_ptr(), wp,
                        ws.data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), None if part is None else part.data_ptr(),
                        m, n, k, splits, kind)
        if not torch.cuda.is_current_stream_capturing():
            w8a8_gemm.launches += 1
    return out


# kernel launches, for chip_smoke.py: a call under a CUDA graph capture
# records the launch into the graph and runs nothing, so it counts nothing
quantize_rows.launches = 0
w8a8_gemm.launches = 0
