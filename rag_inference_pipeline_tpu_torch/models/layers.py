"""Shared transformer building blocks in PyTorch.

Port of `rag_inference_pipeline_tpu/models/layers.py`. Layouts follow the
JAX package at every public function: weights [in, out], activations
[B, T, H, Dh]. Reductions that the reference runs in float32 (norms,
softmax, attention scores) run in float32 here too.

Parameters live in a `ParamTree`: the JAX parameter tree (nested dicts and
lists of arrays) as an `nn.Module`, so `state_dict` keys are the tree's
paths (`layers.3.q_w`) and the model functions read `params.layers[3].q_w`.
A W8A8 leaf is a `QuantizedLinear` or `QuantizedEmbed` module in the tree
(`layers.3.q_w.q`, `layers.3.q_w.s`); `dense` dispatches on it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.flash_attention import flash_encoder_attention
from ..ops.w8a8 import int8_scale, quantize_rows, w8a8_dense


class ParamTree(nn.Module):
    """A JAX-style parameter tree as a module: dicts become submodules,
    lists `nn.ModuleList`s, tensors frozen `nn.Parameter`s, and a module
    leaf (`QuantizedLinear`, `QuantizedEmbed`) stays itself."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, nn.Module):
                self.add_module(name, v)
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False)
                )

    def get(self, name: str, default=None):
        """Optional leaf (e.g. `q_b`, present only with qkv bias)."""
        return getattr(self, name, default)

    def to_tree(self) -> dict:
        """The nested dicts and lists this tree was built from (the same
        tensors and module leaves, not copies)."""
        out: dict = dict(self._parameters)
        for name, m in self._modules.items():
            if isinstance(m, ParamTree):
                out[name] = m.to_tree()
            elif isinstance(m, nn.ModuleList):
                out[name] = [x.to_tree() for x in m]
            else:
                out[name] = m
        return out


class _Int8Weight(nn.Module):
    """An int8 `q` and its f32 scales `s`, as buffers. The scales stay
    float32 whatever dtype the tree is moved to: `.to(torch.bfloat16)`
    moves them, and casts nothing here (`q` is not floating point)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    def _apply(self, fn, recurse=True):
        s = self.s
        super()._apply(fn, recurse)
        if self.s.dtype != torch.float32:  # a dtype cast: move, keep f32
            self.s = s.to(self.s.device)
        return self


class QuantizedLinear(_Int8Weight):
    """Weight-only int8 linear of the W8A8-dynamic path: w ~= q.T * s.

    `q` is [out, in] int8, the TRANSPOSE of the reference's [in, out]
    `QuantizedLinear.q` (`rag_inference_pipeline_tpu/models/layers.py:36-53`):
    the s8 tensor-core GEMM (`ops/w8a8.py`) wants K contiguous. `s` is
    [out] f32, one scale per output column, as in the reference."""


class QuantizedEmbed(_Int8Weight):
    """int8 token-embedding table: `q` [V, H] int8 with per-row scales `s`
    [V] f32, the reference's layout (`layers.py:56-65`). The tied head
    contracts H against it with no transpose."""


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-column int8 quantization of an [in, out]
    weight, as the reference's `quantize_linear` (`layers.py:64-69`): f32,
    s = max(max|w| over in, 1e-8) / 127, q = clip(round(w / s), -127, 127)
    (half to even, an IEEE division); q stored [out, in]."""
    w32 = w.float()
    s = int8_scale(w32.abs().amax(dim=0))
    q = torch.clamp(torch.round(w32 / s[None, :]), -127, 127).to(torch.int8)
    return QuantizedLinear(q.T.contiguous(), s)


def quantize_embed(w: torch.Tensor) -> QuantizedEmbed:
    """Symmetric per-row int8 quantization of a [V, H] table
    (`layers.py:72-77`)."""
    w32 = w.float()
    s = int8_scale(w32.abs().amax(dim=1))
    q = torch.clamp(torch.round(w32 / s[:, None]), -127, 127).to(torch.int8)
    return QuantizedEmbed(q, s)


def quantize_act_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization over the last axis ->
    (q int8 of x's shape, scales f32 [..., 1]), as the reference's
    `quantize_act_rows` (`layers.py:80-89`): the `quantize_rows` kernel on
    CUDA tensors, its plain version on the CPU."""
    q, s = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def layer_norm(x, weight, bias, eps: float = 1e-12):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def dense(x, w, b=None):
    """x @ w ([in, out] weight) with f32 accumulation, in x's dtype.

    Over a `QuantizedLinear` this is the reference's W8A8 `dense`
    (`layers.py:92-110`): x quantized per row, the exact s8 product,
    (f32(acc) * xs) * s cast to x's dtype, then the bias added in that
    dtype, all in `ops/w8a8.py::w8a8_dense`."""
    return dense_group(x, (w,), (b,))[0]


def dense_group(x, ws, bs=None) -> list:
    """`dense` of each weight in `ws` (1 to 3) over the same x, with the
    biases `bs` (None, or one bias or None a weight).

    Over `QuantizedLinear` weights (all of them, as a quantized tree has
    them: q/k/v, gate/up) the group is one `w8a8_dense` call: x quantized
    once, and on the card one launch for the group where the rows are few.
    Other weights run `torch.matmul` each, as `dense` always has."""
    bs = bs if bs is not None else (None,) * len(ws)
    if isinstance(ws[0], QuantizedLinear):
        lead = x.shape[:-1]
        ys = w8a8_dense(x.reshape(-1, x.shape[-1]).contiguous(),
                        [(w.q, w.s) for w in ws], bs, out_dtype=x.dtype)
        return [y.reshape(*lead, y.shape[-1]) for y in ys]
    out = []
    for w, b in zip(ws, bs):
        y = torch.matmul(x, w)
        out.append(y if b is None else y + b)
    return out


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="none")


def rope_frequencies(
    head_dim: int, max_len: int, theta: float = 10000.0, scaling=None,
    device: Optional[torch.device] = None,
):
    """RoPE cos/sin tables: [max_len, head_dim//2] each, float32.

    `scaling` is the Llama-3.x frequency remap (factor, low_freq_factor,
    high_freq_factor, original_max_len), as in the reference."""
    inv = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                  / head_dim)
    )
    if scaling is not None:
        factor, low_ff, high_ff, orig_max = scaling
        wavelen = 2.0 * math.pi / inv
        low_wl = orig_max / low_ff
        high_wl = orig_max / high_ff
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        smoothed = (1.0 - smooth) * (inv / factor) + smooth * inv
        inv = torch.where(
            wavelen < high_wl,
            inv,
            torch.where(wavelen > low_wl, inv / factor, smoothed),
        )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def rope_at(cos, sin, positions):
    """The rope tables' rows at `positions` [B, T] -> ([B, T, 1, Dh/2],
    [B, T, 1, Dh/2]). A position past the tables reads the last row, as
    the reference's gather clamps it (a finished decode-engine lane keeps
    counting positions)."""
    p = positions.clamp(max=cos.shape[0] - 1)
    return cos[p][:, :, None, :], sin[p][:, :, None, :]


def rotate(x, c, s):
    """x: [B, T, H, Dh] rotated by the gathered rope rows of `rope_at`."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x, cos, sin, positions):
    """x: [B, T, H, Dh]; positions: [B, T] absolute positions."""
    return rotate(x, *rope_at(cos, sin, positions))


def attention(
    q: torch.Tensor,  # [B, T, Hq, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, T, S], bool
) -> torch.Tensor:
    """Scaled dot-product attention with GQA head-group broadcast.

    Scores and softmax in float32 whatever the input dtype. Masked scores
    are filled with -1e30, not -inf, so a fully masked row gets uniform
    weights (as in the reference) instead of NaN."""
    dh = q.shape[-1]
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(dh)
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs.float(), v.float())
    return out.to(q.dtype)


def make_padding_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] {0,1} -> [B, 1, 1, S] boolean key-padding mask."""
    return (attn_mask > 0)[:, None, None, :]


def _use_flash(q) -> bool:
    """The reference's gate for its flash branch (`layers.py:198-203`),
    with "the backend is a TPU" read as "q lies on a CUDA card"."""
    _, t, _, dh = q.shape
    return q.is_cuda and t % 128 == 0 and t >= 1024 and dh in (64, 128, 256)


def encoder_attention(q, k, v, attn_mask):
    """Bidirectional self-attention over [B, T, H, Dh], as the reference's
    `encoder_attention`. Where its gate holds (on the card, T % 128 == 0,
    T >= 1024, Dh in 64/128/256) this is the flash kernel with the mask as
    segment ids for q and kv (`ops/flash_attention.py`): a padded query
    attends the padded keys there, as the reference's does on a TPU.
    Everywhere else, the CPU included, it is the key-padding path."""
    if _use_flash(q):
        return flash_encoder_attention(q, k, v, attn_mask, attn_mask)
    return attention(q, k, v, make_padding_mask(attn_mask))
