"""Encoder flash attention with segment ids.

Port of the library flash-attention forward that the reference's
`encoder_attention` calls on a TPU at long context
(`rag_inference_pipeline_tpu/models/layers.py:205-215`, the Pallas kernel
`jax/experimental/pallas/ops/tpu/flash_attention.py`, forward at
`_flash_attention_kernel_single_batch`), non-causal, with no bias:

- s = (q . k^T accumulated in f32) * sm_scale, sm_scale = 1/sqrt(dh),
  the scale applied after the product;
- s += 0 where seg_q[i] == seg_kv[j], else -0.7 * f32 max (an additive
  mask, not a fill: a query whose segment holds no valid token attends the
  keys of its own segment, and a row with no valid token at all attends
  every key);
- an online softmax over 128-key blocks in order: m from -inf,
  m' = max(m, rowmax s), p = exp(s - m'), alpha = exp(m - m'),
  l' = rowsum p + alpha l, and the accumulator normalised as it goes,
  acc = acc * (alpha l / l') + (p cast to v's dtype @ v, in f32) / l',
  with no division at the end;
- the output cast to q's dtype.

`q`, `k`, `v` are [B, T, H, Dh] as `encoder_attention` holds them (the
reference transposes to [B, H, T, Dh] for the library; the kernel reads
this layout through its strides), `seg_q` and `seg_kv` [B, T] integers.
On CUDA tensors `flash_encoder_attention` launches
`csrc/flash_attention.cu` (or raises); on CPU tensors it runs
`flash_encoder_attention_plain`, its oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels

BLOCK_K = 128  # the library's default key block (BlockSizes.get_default)
HEAD_DIMS = (64, 128, 256)
# the library's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the dtype code the kernel's entry point takes
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_encoder_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    seg_q: torch.Tensor, seg_kv: torch.Tensor,
) -> torch.Tensor:
    """The library's forward op by op on any device: the same 128-key
    blocks in order, `p` cast to v's dtype per block, the accumulator
    normalised as it goes. Returns [B, T, H, Dh] in q's dtype."""
    _check_shapes(q, k, v, seg_q, seg_kv)
    dh = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(dh)
    qh = q.transpose(1, 2).float()  # [B, H, T, Dh]
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2)
    sq = seg_q[:, None, :, None]
    m = torch.full((*qh.shape[:3], 1), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qh.shape, device=q.device)
    for s0 in range(0, q.shape[1], BLOCK_K):
        s = torch.matmul(qh, kh[:, :, s0:s0 + BLOCK_K].transpose(-1, -2)) * sm_scale
        same = sq == seg_kv[:, None, None, s0:s0 + BLOCK_K]
        s = s + torch.where(same, 0.0, MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        o = torch.matmul(p.to(v.dtype).float(), vh[:, :, s0:s0 + BLOCK_K].float())
        acc = acc * (l_corr * inv) + o * inv
        m, l = m_next, l_next
    return acc.to(q.dtype).transpose(1, 2)


def _check_shapes(q, k, v, seg_q, seg_kv) -> None:
    """The checks both versions make, cheapest first."""
    shape = q.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v must be one [B, T, H, Dh] shape, not "
                         f"{tuple(shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, _, dh = shape
    if seg_q.shape != (b, t) or seg_kv.shape != (b, t):
        raise ValueError(f"segment ids must be [B, T] = {(b, t)}, not "
                         f"{tuple(seg_q.shape)}, {tuple(seg_kv.shape)}")
    if t % BLOCK_K:
        raise ValueError(f"T ({t}) must be a multiple of the {BLOCK_K}-key block")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} is not one of {HEAD_DIMS}")
    if q.dtype not in _KINDS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {tuple(_KINDS)}, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if seg_q.is_floating_point() or seg_kv.is_floating_point():
        raise TypeError(f"segment ids must be integers, not {seg_q.dtype}, "
                        f"{seg_kv.dtype}")


def _on_card(q, k, v, seg_q, seg_kv) -> Optional[int]:
    """None when every tensor lies on the CPU (run the plain version), else
    the CUDA device's index; raises when they are spread over devices or
    the kernel cannot read them (a head row off 16 bytes)."""
    tensors = (q, k, v, seg_q, seg_kv)
    if all(x.is_cpu for x in tensors):
        return None
    index = q.get_device() if q.is_cuda else -1
    if index < 0 or any(not x.is_cuda or x.get_device() != index for x in tensors):
        raise ValueError("flash_encoder_attention: all tensors must be on one CUDA "
                         "device (or all on the CPU)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        size = x.element_size()
        if (x.stride(3) != 1 or x.data_ptr() % 16
                or any(s * size % 16 for s in x.stride()[:3])):
            raise ValueError(f"flash_encoder_attention: {name} must have contiguous "
                             "head rows on 16-byte boundaries, not strides "
                             f"{x.stride()} from a base off 16 bytes by "
                             f"{x.data_ptr() % 16}")
    return index


def flash_encoder_attention(
    q: torch.Tensor,  # [B, T, H, Dh]
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,  # [B, T] int
    seg_kv: torch.Tensor,
) -> torch.Tensor:
    """Segment-masked flash attention -> [B, T, H, Dh] in q's dtype.

    On CUDA tensors this launches csrc/flash_attention.cu (or raises); on
    CPU tensors it runs `flash_encoder_attention_plain`. Segment ids are
    read as int32."""
    _check_shapes(q, k, v, seg_q, seg_kv)
    index = _on_card(q, k, v, seg_q, seg_kv)
    if index is None:
        return flash_encoder_attention_plain(q, k, v, seg_q, seg_kv)
    b, t, h, dh = q.shape
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    sq = seg_q.to(torch.int32).contiguous()
    skv = sq if seg_kv is seg_q else seg_kv.to(torch.int32).contiguous()
    if skv.data_ptr() % 16:  # the bf16/f16 kernel bulk-copies key ids from 16 bytes
        skv = skv.clone()
    if out.numel():
        _kernels.launch(
            "ragtorch_flash_attention", index, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), sq.data_ptr(), skv.data_ptr(), out.data_ptr(),
            b, t, h, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _KINDS[q.dtype],
        )
        if not torch.cuda.is_current_stream_capturing():
            flash_encoder_attention.launches += 1
    return out


# kernel launches, for chip_smoke.py: a call under a CUDA graph capture
# records the launch into the graph and runs nothing, so it counts nothing
flash_encoder_attention.launches = 0
