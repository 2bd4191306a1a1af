"""Qwen2-style causal LM in PyTorch with a static-shape KV cache.

Port of `rag_inference_pipeline_tpu/models/qwen.py`: RMSNorm pre-norm,
RoPE, GQA, SwiGLU, optional QKV bias, tied embeddings; prefill fills the
cache at offset 0, each decode step inserts one row per lane, greedy
generation loops over steps. Unlike the reference's pure functions, the
cache is written in place (the reference rewrites the whole cache each
step); `qwen_prefill` and `qwen_decode_step` return the cache they were
given, with its `length` advanced.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from .layers import ParamTree, apply_rope, attention, dense, rms_norm, rope_frequencies


@dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151936
    hidden: int = 896
    layers: int = 24
    heads: int = 14
    kv_heads: int = 2
    head_dim: int = 64
    intermediate: int = 4864
    rope_theta: float = 1e6
    eps: float = 1e-6
    qkv_bias: bool = True
    tie_embeddings: bool = True
    max_len: int = 4096
    # Llama-3.x rope remap: (factor, low_freq_factor, high_freq_factor,
    # original_max_len) or None (see layers.rope_frequencies)
    rope_scaling: Optional[tuple] = None

    @staticmethod
    def qwen25_05b() -> "QwenConfig":
        """Qwen/Qwen2.5-0.5B-Instruct."""
        return QwenConfig()

    @staticmethod
    def llama32_1b() -> "QwenConfig":
        """meta-llama/Llama-3.2-1B-Instruct (no qkv bias, llama3 rope)."""
        return QwenConfig(
            vocab_size=128256, hidden=2048, layers=16, heads=32, kv_heads=8,
            head_dim=64, intermediate=8192, rope_theta=500000.0, eps=1e-5,
            qkv_bias=False, tie_embeddings=True, max_len=4096,
            rope_scaling=(32.0, 1.0, 4.0, 8192),
        )

    @staticmethod
    def llama31_8b() -> "QwenConfig":
        """meta-llama/Llama-3.1-8B-Instruct (untied lm head)."""
        return QwenConfig(
            vocab_size=128256, hidden=4096, layers=32, heads=32, kv_heads=8,
            head_dim=128, intermediate=14336, rope_theta=500000.0, eps=1e-5,
            qkv_bias=False, tie_embeddings=False, max_len=4096,
            rope_scaling=(8.0, 1.0, 4.0, 8192),
        )

    @staticmethod
    def tiny() -> "QwenConfig":
        return QwenConfig(
            vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, intermediate=128, max_len=256,
        )


def init_qwen_params(
    cfg: QwenConfig,
    *,
    generator: Optional[torch.Generator],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> ParamTree:
    """Random init with the reference's tree layout and distributions.
    `device="meta"` with no generator builds the bare skeleton."""
    std = 0.02

    def w(*shape):
        return (
            std * torch.randn(shape, generator=generator, device=device)
        ).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    h = cfg.hidden
    qd = cfg.heads * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim
    tree = {"embed": w(cfg.vocab_size, h), "final_ln": ones(h), "layers": []}
    if not cfg.tie_embeddings:
        tree["lm_head"] = w(h, cfg.vocab_size)
    for _ in range(cfg.layers):
        lp = {
            "in_ln": ones(h),
            "q_w": w(h, qd),
            "k_w": w(h, kvd),
            "v_w": w(h, kvd),
            "o_w": w(qd, h),
            "post_ln": ones(h),
            "gate_w": w(h, cfg.intermediate),
            "up_w": w(h, cfg.intermediate),
            "down_w": w(cfg.intermediate, h),
        }
        if cfg.qkv_bias:
            lp.update(q_b=zeros(qd), k_b=zeros(kvd), v_b=zeros(kvd))
        tree["layers"].append(lp)
    return ParamTree(tree)


class KVCache:
    """Static-shape KV cache: [L, B, S, Hkv, Dh] per k and v, written in
    place; `length` [B] int32 is the filled length per lane."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: torch.Tensor):
        self.k, self.v, self.length = k, v, length

    @classmethod
    def zeros(cls, layers, batch, max_len, heads_kv, head_dim,
              dtype=torch.bfloat16, device=None):
        shape = (layers, batch, max_len, heads_kv, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros(batch, dtype=torch.int32, device=device),
        )


@functools.lru_cache(maxsize=8)
def _rope_tables(cfg: QwenConfig, device: torch.device):
    return rope_frequencies(
        cfg.head_dim, cfg.max_len, cfg.rope_theta, cfg.rope_scaling,
        device=device,
    )


def _block(
    lp: ParamTree,
    cfg: QwenConfig,
    x: torch.Tensor,  # [B, T, H]
    cos,
    sin,
    positions: torch.Tensor,  # [B, T]
    cache_k: torch.Tensor,  # [B, S, Hkv, Dh], written in place
    cache_v: torch.Tensor,
    mask: torch.Tensor,  # [B or 1, 1, T, S] bool
) -> torch.Tensor:
    b, t, _ = x.shape
    y = rms_norm(x, lp.in_ln, cfg.eps)
    q = dense(y, lp.q_w, lp.get("q_b")).reshape(b, t, cfg.heads, cfg.head_dim)
    k = dense(y, lp.k_w, lp.get("k_b")).reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = dense(y, lp.v_w, lp.get("v_b")).reshape(b, t, cfg.kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if t == 1:
        # decode-step insert, in place with index_copy_ over the flattened
        # [B*S] rows. Positions clamp to the last slot, as the reference's
        # one-hot insert does, so a lane past the end overwrites slot S-1
        # instead of dropping the newest k/v.
        s_len = cache_k.shape[1]
        pos = torch.clamp(positions[:, 0].long(), max=s_len - 1)
        rows = torch.arange(b, device=x.device) * s_len + pos
        cache_k.view(b * s_len, *cache_k.shape[2:]).index_copy_(0, rows, k[:, 0])
        cache_v.view(b * s_len, *cache_v.shape[2:]).index_copy_(0, rows, v[:, 0])
    else:
        # prefill of a right-padded prompt writes at offset 0
        cache_k[:, :t] = k
        cache_v[:, :t] = v
    a = attention(q, cache_k, cache_v, mask).reshape(b, t, -1)
    x = x + dense(a, lp.o_w)
    y = rms_norm(x, lp.post_ln, cfg.eps)
    ff = torch.nn.functional.silu(dense(y, lp.gate_w)) * dense(y, lp.up_w)
    return x + dense(ff, lp.down_w)


def _logits(params: ParamTree, cfg: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits: the head product runs in float32, as in the reference."""
    y = rms_norm(x, params.final_ln, cfg.eps).float()
    if cfg.tie_embeddings:
        return torch.matmul(y, params.embed.float().T)
    return torch.matmul(y, params.lm_head.float())


def qwen_prefill(
    params: ParamTree,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded prompt bucket
    attn_mask: torch.Tensor,  # [B, T]
    cache: KVCache,
) -> tuple[torch.Tensor, KVCache]:
    """Fill the cache with the prompt; return (next-token logits [B, V],
    cache). `cache.length` becomes the true prompt length per lane."""
    b, t = input_ids.shape
    s = cache.k.shape[2]
    dev = input_ids.device
    cos, sin = _rope_tables(cfg, dev)
    positions = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0).long()
    lengths = attn_mask.sum(dim=1).to(torch.int32)
    x = params.embed[input_ids.long()]
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    causal = (cols <= rows)[None, None]
    valid_key = (cols[None] < lengths[:, None, None])[:, None]
    mask = causal & valid_key
    for li, lp in enumerate(params.layers):
        x = _block(lp, cfg, x, cos, sin, positions, cache.k[li], cache.v[li], mask)
    cache.length = lengths
    last = x[torch.arange(b, device=dev), torch.clamp(lengths.long() - 1, min=0)]
    return _logits(params, cfg, last[:, None, :])[:, 0], cache


def qwen_decode_step(
    params: ParamTree,
    cfg: QwenConfig,
    tokens: torch.Tensor,  # [B] last tokens
    cache: KVCache,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step for every lane -> (logits [B, V], cache)."""
    s = cache.k.shape[2]
    dev = tokens.device
    cos, sin = _rope_tables(cfg, dev)
    positions = cache.length.long()[:, None]  # [B, 1]
    x = params.embed[tokens.long()][:, None, :]
    cols = torch.arange(s, device=dev)[None, :]
    mask = (cols[None] <= positions[:, :, None])[:, None]  # [B,1,1,S]
    for li, lp in enumerate(params.layers):
        x = _block(lp, cfg, x, cos, sin, positions, cache.k[li], cache.v[li], mask)
    cache.length = cache.length + 1
    return _logits(params, cfg, x)[:, 0], cache


@torch.inference_mode()
def greedy_generate(
    params: ParamTree,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded
    attn_mask: torch.Tensor,
    max_new_tokens: int,
    *,
    eos_token_id: int = -1,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """Greedy decode -> [B, max_new_tokens] int32, eos-padded after eos."""
    b, t = input_ids.shape
    s = cache_len or (t + max_new_tokens)
    cache = KVCache.zeros(
        cfg.layers, b, s, cfg.kv_heads, cfg.head_dim,
        dtype=params.final_ln.dtype, device=input_ids.device,
    )
    logits, cache = qwen_prefill(params, cfg, input_ids, attn_mask, cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    done = tok == eos_token_id
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = qwen_decode_step(params, cfg, tok, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, eos_token_id, nxt).to(torch.int32)
        done = done | (nxt == eos_token_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
