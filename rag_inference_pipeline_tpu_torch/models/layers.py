"""Shared transformer building blocks in PyTorch.

Port of `rag_inference_pipeline_tpu/models/layers.py`. Layouts follow the
JAX package at every public function: weights [in, out], activations
[B, T, H, Dh]. Reductions that the reference runs in float32 (norms,
softmax, attention scores) run in float32 here too.

Parameters live in a `ParamTree`: the JAX parameter tree (nested dicts and
lists of arrays) as an `nn.Module`, so `state_dict` keys are the tree's
paths (`layers.3.q_w`) and the model functions read `params.layers[3].q_w`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class ParamTree(nn.Module):
    """A JAX-style parameter tree as a module: dicts become submodules,
    lists `nn.ModuleList`s, tensors frozen `nn.Parameter`s."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False)
                )

    def get(self, name: str, default=None):
        """Optional leaf (e.g. `q_b`, present only with qkv bias)."""
        return getattr(self, name, default)


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
    """x @ w ([in, out] weight) with f32 accumulation, in x's dtype."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


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


def encoder_attention(q, k, v, attn_mask):
    """Bidirectional self-attention with key padding. The reference's TPU
    flash-attention branch (T >= 1024 on a TPU) is not ported yet; this is
    the masked path it takes everywhere else."""
    return attention(q, k, v, make_padding_mask(attn_mask))
