"""Qwen2-style causal LM in PyTorch with a static-shape KV cache.

Port of `rag_inference_pipeline_tpu/models/qwen.py`: RMSNorm pre-norm,
RoPE, GQA, SwiGLU, optional QKV bias, tied embeddings; prefill fills the
cache at offset 0, each decode step inserts one row per lane,
`qwen_extend` a window of rows per lane; greedy generation loops over
steps, n-gram speculation over verify rounds. Unlike the reference's pure
functions, the cache is written in place (the reference rewrites the whole
cache each step): `qwen_prefill`, `qwen_decode_step` and `qwen_extend`
return the cache they were given, its rows and `length` updated in place.

The loops keep their carried state in tensors updated in place, so that
on CUDA one captured graph of the loop body serves every step
(`models/decode_graph.py`); `greedy_generate_eager` and
`ngram_speculative_generate_eager` issue every step from Python.

Every function takes a tp-sharded tree too (`layers.TPTree`, from
`parallel/sharding.py`), as the reference's take a sharded pytree: each
shard runs its `heads / tp` query heads and `kv_heads / tp` kv heads
against its own slice of the KV cache, o and down are row-parallel
(`layers.row_dense`, the residual added after the sum), the tied head runs
whole and an untied one column-split (its f32 logits joined in position
order). A `layers.MeshTree` (one tree a dp position) splits the batch over
dp: each position's lanes, and their cache, live on its tp group
(`KVCache.zeros(grid=...)`, the reference's `kv_cache_sharding`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch

from . import decode_graph
from ..ops.w8a8 import w8a8_dense
from .layers import (
    MeshTree,
    ParamTree,
    QuantizedEmbed,
    QuantizedLinear,
    TPTree,
    attention,
    dense_group,
    over_dp,
    quantize_embed,
    quantize_linear,
    rms_norm,
    rope_at,
    rope_frequencies,
    rotate,
    row_dense,
    shards_of,
    spread,
    tree_devices,
)


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
    quantize: bool = False,
) -> ParamTree:
    """Random init with the reference's tree layout and distributions.
    `device="meta"` with no generator builds the bare skeleton.

    `quantize` builds the W8A8 tree at the source, as the reference's
    `init_qwen_params_int8` (`rag_inference_pipeline_tpu/models/qwen.py:156-204`):
    each matmul leaf is drawn in `dtype` and quantized before the next is
    drawn, so the full-precision tree never exists; bitwise equal to
    `quantize_qwen_params(init_qwen_params(...))` from the same generator
    state."""
    std = 0.02

    def w(*shape):
        if generator is None:  # the skeleton: no draw (a meta draw is slow)
            return torch.empty(shape, dtype=dtype, device=device)
        return (
            std * torch.randn(shape, generator=generator, device=device)
        ).to(dtype)

    def wq(*shape):
        return quantize_linear(w(*shape)) if quantize else w(*shape)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    h = cfg.hidden
    qd = cfg.heads * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim
    embed = w(cfg.vocab_size, h)
    tree = {"embed": quantize_embed(embed) if quantize else embed,
            "final_ln": ones(h), "layers": []}
    del embed  # with `quantize`, the full-precision table goes before the layers
    if not cfg.tie_embeddings:
        tree["lm_head"] = wq(h, cfg.vocab_size)
    for _ in range(cfg.layers):
        lp = {
            "in_ln": ones(h),
            "q_w": wq(h, qd),
            "k_w": wq(h, kvd),
            "v_w": wq(h, kvd),
            "o_w": wq(qd, h),
            "post_ln": ones(h),
            "gate_w": wq(h, cfg.intermediate),
            "up_w": wq(h, cfg.intermediate),
            "down_w": wq(cfg.intermediate, h),
        }
        if cfg.qkv_bias:
            lp.update(q_b=zeros(qd), k_b=zeros(kvd), v_b=zeros(kvd))
        tree["layers"].append(lp)
    return ParamTree(tree)


_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def quantize_qwen_params(params: ParamTree) -> ParamTree:
    """The W8A8 tree of `params`, as the reference's `quantize_qwen_params`
    (`qwen.py:207-227`): the projections and an untied `lm_head` become
    `QuantizedLinear`, the embedding a `QuantizedEmbed`; norms and biases
    are the same tensors. `params` itself is left as it is."""
    tree = params.to_tree()
    tree["embed"] = quantize_embed(tree["embed"])
    if "lm_head" in tree:
        tree["lm_head"] = quantize_linear(tree["lm_head"])
    for lp in tree["layers"]:
        for k in _QUANT_KEYS:
            lp[k] = quantize_linear(lp[k])
    return ParamTree(tree)


def _embed_rows(params: ParamTree, ids: torch.Tensor) -> torch.Tensor:
    """Token-embedding rows; an int8 table dequantizes per row, f32(q) *
    s, cast to the model's dtype (`final_ln`'s), as the reference's
    `_embed_rows` (`qwen.py:235-242`)."""
    e = params.embed
    ids = ids.long()
    if isinstance(e, QuantizedEmbed):
        return (e.q[ids].float() * e.s[ids][..., None]).to(params.final_ln.dtype)
    return e[ids]


class KVCache:
    """Static-shape KV cache: [L, B, S, Hkv, Dh] per k and v, written in
    place; `length` [B] int32 is the filled length per lane.

    On a mesh the cache is a grid of blocks (`grid[i][j]` = (k, v) of dp
    position i, tp position j: [L, B/dp, S, Hkv/tp, Dh] on that position's
    device, the reference's `kv_cache_sharding`); `length` stays whole on
    the first device. `k` and `v` name the one block of an unsplit cache."""

    def __init__(self, k, v, length: torch.Tensor, grid=None):
        self.grid = grid if grid is not None else (((k, v),),)
        self.length = length

    @property
    def k(self) -> torch.Tensor:
        return self._whole()[0]

    @property
    def v(self) -> torch.Tensor:
        return self._whole()[1]

    def _whole(self):
        if len(self.grid) * len(self.grid[0]) != 1:
            raise AttributeError("a cache split over a mesh has no single k, v: read .grid")
        return self.grid[0][0]

    @property
    def max_len(self) -> int:
        return self.grid[0][0][0].shape[2]

    @property
    def dtype(self) -> torch.dtype:
        return self.grid[0][0][0].dtype

    def zero_(self) -> None:
        for row in self.grid:
            for k, v in row:
                k.zero_()
                v.zero_()

    @classmethod
    def zeros(cls, layers, batch, max_len, heads_kv, head_dim,
              dtype=torch.bfloat16, device=None, grid=None):
        """A zero cache on `device`, or split over `grid` (a mesh's grid, or
        one tp group as a 1-row grid): the lanes over its rows (dp), the kv
        heads over its columns (tp); `length` on grid[0][0]."""
        if grid is None:
            grid = ((device,),)
        dp, tp = len(grid), len(grid[0])
        if batch % dp or heads_kv % tp:
            raise ValueError(f"a cache of {batch} lanes and {heads_kv} kv heads does not "
                             f"split over dp={dp} x tp={tp}")
        shape = (layers, batch // dp, max_len, heads_kv // tp, head_dim)
        blocks = tuple(
            tuple((torch.zeros(shape, dtype=dtype, device=d),
                   torch.zeros(shape, dtype=dtype, device=d)) for d in row)
            for row in grid)
        return cls(None, None, torch.zeros(batch, dtype=torch.int32, device=grid[0][0]),
                   grid=blocks)

    def put_lanes(self, lanes: list, src: "KVCache") -> None:
        """Row r of `src` (a cache of one dp block, split like this one over
        tp, with len(lanes) rows or more) into lane `lanes[r]`: a lane of dp
        block i lands in block i, on its devices."""
        per = self.grid[0][0][0].shape[1]
        for i, row in enumerate(self.grid):
            rows = [r for r, lane in enumerate(lanes) if lane // per == i]
            if not rows:
                continue
            local = [lanes[r] - i * per for r in rows]
            for (k, v), (sk, sv) in zip(row, src.grid[0]):
                src_rows, dst = _index(rows, sk.device), _index(local, k.device)
                k[:, dst] = sk[:, src_rows].to(k.device)
                v[:, dst] = sv[:, src_rows].to(v.device)
        self.length[_index(lanes, self.length.device)] = (
            src.length[: len(lanes)].to(self.length.device))


def _index(values: list, device: torch.device) -> torch.Tensor:
    """Host ints as a long tensor on `device`, through pinned memory on a
    card (a pageable copy would wait for the work queued there)."""
    t = torch.tensor(values, dtype=torch.long)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@functools.lru_cache(maxsize=8)
def _rope_tables(cfg: QwenConfig, device: torch.device):
    return rope_frequencies(
        cfg.head_dim, cfg.max_len, cfg.rope_theta, cfg.rope_scaling,
        device=device,
    )


def cache_grid(params):
    """The devices a tree's cache lies on, as `KVCache.zeros` takes them:
    None for an unsplit tree (its own device), one tp group, or a
    `MeshTree`'s groups."""
    if isinstance(params, MeshTree):
        return tuple(tree_devices(g) for g in params.groups)
    if isinstance(params, TPTree):
        return (params.devices,)
    return None


def tree_all_devices(params) -> tuple[torch.device, ...]:
    """Every device a tree's work runs on, each once."""
    groups = params.groups if isinstance(params, MeshTree) else (params,)
    return tuple(dict.fromkeys(d for g in groups for d in tree_devices(g)))


def _attend(lp, cfg: QwenConfig, heads: int, kv_heads: int, y, rope, positions,
            cache_k, cache_v, mask) -> torch.Tensor:
    """The attention half of a block on one shard's `heads` query and
    `kv_heads` kv heads (all of them unsplit): q/k/v, rope, the cache
    write (none without a cache: `qwen_forward`) and attention ->
    [B, T, heads * Dh]."""
    b, t, _ = y.shape
    q, k, v = dense_group(y, (lp.q_w, lp.k_w, lp.v_w),
                          (lp.get("q_b"), lp.get("k_b"), lp.get("v_b")))
    q = rotate(q.reshape(b, t, heads, cfg.head_dim), *rope)
    k = rotate(k.reshape(b, t, kv_heads, cfg.head_dim), *rope)
    v = v.reshape(b, t, kv_heads, cfg.head_dim)
    if cache_k is None:
        return attention(q, k, v, mask).reshape(b, t, -1)
    s_len = cache_k.shape[1]
    lanes = torch.arange(b, device=y.device)
    if t == 1:
        # decode-step insert, in place with index_copy_ over the flattened
        # [B*S] rows. As in the reference's one-hot insert, a lane past the
        # end overwrites slot S-1 instead of dropping the newest k/v, and a
        # lane below 0 writes nothing: it rewrites its own slot 0 with the
        # value already there (no host sync, so the step can be captured).
        pos = positions[:, 0].long()
        rows = lanes * s_len + pos.clamp(0, s_len - 1)
        keep = (pos >= 0)[:, None, None]
        for cache, new in ((cache_k, k), (cache_v, v)):
            flat = cache.view(b * s_len, *cache.shape[2:])
            flat.index_copy_(0, rows, torch.where(keep, new[:, 0], flat[rows]))
    else:
        # a window of t rows per lane at positions[:, 0], the start clamped
        # to [0, S - t] as the reference's dynamic_update_slice clamps it
        # (a prefill starts at 0; qwen_extend at the lane's length)
        start = positions[:, 0].long().clamp(0, s_len - t)
        rows = (lanes * s_len + start)[:, None] + torch.arange(t, device=y.device)
        for cache, new in ((cache_k, k), (cache_v, v)):
            cache.view(b * s_len, *cache.shape[2:]).index_copy_(
                0, rows.reshape(-1), new.reshape(b * t, *new.shape[2:]).to(cache.dtype)
            )
    return attention(q, cache_k, cache_v, mask).reshape(b, t, -1)


def _block(lps, devs, cfg: QwenConfig, x, ropes, poss, kv, masks) -> torch.Tensor:
    """One decoder layer over a tp group (one shard for an unsplit tree):
    `lps[j]` is the layer's shard j on `devs[j]`, with its `heads / tp`
    query and `kv_heads / tp` kv heads and its cache block `kv[j]` (None:
    no cache); the norms run once on x (on devs[0]) and are copied to each
    distinct device; o and down are row-parallel, their partials summed
    before the residual."""
    tp = len(lps)
    ys = spread(rms_norm(x, lps[0].in_ln, cfg.eps), devs)
    parts = [
        _attend(lp, cfg, cfg.heads // tp, cfg.kv_heads // tp, ys[j], ropes[j], poss[j],
                *(kv[j] if kv is not None else (None, None)), masks[j])
        for j, lp in enumerate(lps)
    ]
    x = x + row_dense(parts, [lp.o_w for lp in lps])
    ys = spread(rms_norm(x, lps[0].post_ln, cfg.eps), devs)
    ffs = []
    for lp, y in zip(lps, ys):
        gate, up = dense_group(y, (lp.gate_w, lp.up_w))
        ffs.append(torch.nn.functional.silu(gate) * up)
    return x + row_dense(ffs, [lp.down_w for lp in lps])


def _head(head, cfg: QwenConfig, y: torch.Tensor) -> torch.Tensor:
    """f32 logits of the normed y against a head (or a shard's vocabulary
    slice of an untied one). An int8 head (the tied `QuantizedEmbed`, or an
    untied `QuantizedLinear`: both [V, H] here) is the reference's W8A8
    branch (`qwen.py:309-327`): the quantized rows of y against it, f32(acc)
    * ys * s, kept in f32."""
    if isinstance(head, (QuantizedEmbed, QuantizedLinear)):
        out = w8a8_dense(y.reshape(-1, y.shape[-1]).contiguous(), [(head.q, head.s)],
                         out_dtype=torch.float32)[0]
        return out.reshape(*y.shape[:-1], out.shape[-1])
    y = y.float()
    if cfg.tie_embeddings:
        return torch.matmul(y, head.float().T)
    return torch.matmul(y, head.float())


def _logits(params, cfg: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits: the head product runs in float32, as in the reference.
    A `MeshTree` runs each dp position's rows on its tree; an untied head
    over tp is column-split, each shard's f32 vocabulary slice joined in
    position order (the tied head is whole on every shard)."""
    if isinstance(params, MeshTree):
        return over_dp(_dp_devices(params), lambda g, xi: _logits(g, cfg, xi),
                       params.groups, x)
    y = rms_norm(x, params.final_ln, cfg.eps)
    if isinstance(params, TPTree) and not cfg.tie_embeddings:
        return torch.cat([_head(sh.lm_head, cfg, yj).to(y.device)
                          for sh, yj in zip(params.shards, spread(y, params.devices))], dim=-1)
    return _head(params.embed if cfg.tie_embeddings else params.lm_head, cfg, y)


def _dp_devices(params: MeshTree) -> list:
    return [tree_devices(g)[0] for g in params.groups]


def _group_layers(params, cfg, x, positions, blocks, mask) -> torch.Tensor:
    """Every layer over one tree (unsplit or a tp group) and its cache
    blocks (`KVCache.grid`'s row; None: no cache)."""
    shards, devs = shards_of(params)
    rope = rope_at(*_rope_tables(cfg, x.device), positions)
    ropes = list(zip(spread(rope[0], devs), spread(rope[1], devs)))
    poss, masks = spread(positions, devs), spread(mask, devs)
    for li in range(len(shards[0].layers)):
        kv = None if blocks is None else [(k[li], v[li]) for k, v in blocks]
        x = _block([sh.layers[li] for sh in shards], devs, cfg, x, ropes, poss, kv, masks)
    return x


def _layers(params, cfg, x, positions, cache: Optional[KVCache], mask) -> torch.Tensor:
    """The decoder layers over x [B, T, H]; a `MeshTree` runs each dp
    position's slice of the batch on its tree and cache block, the results
    joined on x's device."""
    if isinstance(params, MeshTree):
        rows = [(g, None if cache is None else cache.grid[i])
                for i, g in enumerate(params.groups)]
        return over_dp(_dp_devices(params),
                       lambda gb, xi, pi, mi: _group_layers(gb[0], cfg, xi, pi, gb[1], mi),
                       rows, x, positions, mask.expand(x.shape[0], *mask.shape[1:]))
    return _group_layers(params, cfg, x, positions,
                         None if cache is None else cache.grid[0], mask)


def qwen_forward(
    params,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T]
    attn_mask: torch.Tensor,  # [B, T] {0,1}, right-padded
) -> torch.Tensor:
    """Plain causal forward with no cache -> f32 logits [B, T, V], the
    reference's `qwen_forward` (`qwen.py:335-355`): causal and key-padding
    masks, positions from the mask's running count."""
    t = input_ids.shape[1]
    dev = input_ids.device
    positions = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0).long()
    idx = torch.arange(t, device=dev)
    causal = (idx[None, :] <= idx[:, None])[None, None]
    pad = (attn_mask > 0)[:, None, None, :]
    x = _layers(params, cfg, _embed_rows(params, input_ids), positions, None, causal & pad)
    return _logits(params, cfg, x)


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
    s = cache.max_len
    dev = input_ids.device
    positions = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0).long()
    lengths = attn_mask.sum(dim=1).to(torch.int32)
    rows = torch.arange(t, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    causal = (cols <= rows)[None, None]
    valid_key = (cols[None] < lengths[:, None, None])[:, None]
    x = _layers(params, cfg, _embed_rows(params, input_ids), positions, cache,
                causal & valid_key)
    cache.length.copy_(lengths)
    last = x[torch.arange(b, device=dev), torch.clamp(lengths.long() - 1, min=0)]
    return _logits(params, cfg, last[:, None, :])[:, 0], cache


def qwen_decode_step(
    params: ParamTree,
    cfg: QwenConfig,
    tokens: torch.Tensor,  # [B] last tokens
    cache: KVCache,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step for every lane -> (logits [B, V], cache); the
    cache's rows and `length` are updated in place."""
    s = cache.max_len
    positions = cache.length.long()[:, None]  # [B, 1]
    cols = torch.arange(s, device=tokens.device)[None, :]
    mask = (cols[None] <= positions[:, :, None])[:, None]  # [B,1,1,S]
    x = _layers(params, cfg, _embed_rows(params, tokens)[:, None, :], positions,
                cache, mask)
    cache.length.add_(1)
    return _logits(params, cfg, x)[:, 0], cache


def qwen_extend(
    params: ParamTree,
    cfg: QwenConfig,
    tokens: torch.Tensor,  # [B, T] window to consume (T = gamma + 1)
    cache: KVCache,
) -> tuple[torch.Tensor, KVCache]:
    """Multi-token decode step: consume a T-token window per lane starting
    at `cache.length` -> (logits for every window position [B, T, V],
    cache). The speculative-verify primitive. The window's rows go to
    `clamp(length, 0, S - T)`, as the reference's `dynamic_update_slice`
    puts them; `cache.length` advances by T in place, and callers roll it
    back to the accepted prefix (rows past `length` are never attended and
    are overwritten later)."""
    b, t = tokens.shape
    s = cache.max_len
    dev = tokens.device
    positions = cache.length.long()[:, None] + torch.arange(t, device=dev)[None]
    cols = torch.arange(s, device=dev)[None, None, :]
    mask = (cols <= positions[:, :, None])[:, None]  # [B, 1, T, S]
    x = _layers(params, cfg, _embed_rows(params, tokens), positions, cache, mask)
    cache.length.add_(t)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Greedy decode: one loop body, run eagerly on the CPU and replayed as a
# captured CUDA graph on the card (models/decode_graph.py)
# ---------------------------------------------------------------------------


class _GreedyState:
    """The greedy loop's carried state in tensors updated in place: the
    cache, each lane's last token and `done`, the output rows and the
    column the next token goes to (a device counter, so that one captured
    step serves every column)."""

    def __init__(self, cfg: QwenConfig, b: int, s: int, width: int, dtype, device,
                 grid=None):
        self.cache = KVCache.zeros(cfg.layers, b, s, cfg.kv_heads, cfg.head_dim,
                                   dtype=dtype, device=device, grid=grid)
        self.tok = torch.zeros(b, dtype=torch.int32, device=device)
        self.done = torch.zeros(b, dtype=torch.bool, device=device)
        self.out = torch.zeros(b, width, dtype=torch.int32, device=device)
        self.col = torch.zeros(1, dtype=torch.long, device=device)

    def start(self, params, cfg, input_ids, attn_mask, eos: int) -> None:
        """Prefill and the first token (eager: prompt shapes vary)."""
        logits, _ = qwen_prefill(params, cfg, input_ids, attn_mask, self.cache)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tok.copy_(first)
        self.done.copy_(first == eos)
        self.out[:, 0] = first
        self.col.fill_(1)


def _greedy_step(params, cfg: QwenConfig, st: _GreedyState, eos: int) -> None:
    """One greedy step: the next token of every lane into `st.out`."""
    logits, _ = qwen_decode_step(params, cfg, st.tok, st.cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(st.done, eos, nxt).to(torch.int32)
    st.done.logical_or_(nxt == eos)
    st.out.index_copy_(1, st.col, nxt[:, None])
    st.col.add_(1)
    st.tok.copy_(nxt)


def _greedy_graph(params, cfg, b, s, width, eos, device, pool) -> SimpleNamespace:
    st = _GreedyState(cfg, b, s, width, params.final_ln.dtype, device, cache_grid(params))
    graph = decode_graph.CapturedGraph(lambda: _greedy_step(params, cfg, st, eos),
                                       device, pool)
    return SimpleNamespace(state=st, graph=graph)


@torch.inference_mode()
def greedy_generate_eager(
    params: ParamTree,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded
    attn_mask: torch.Tensor,
    max_new_tokens: int,
    *,
    eos_token_id: int = -1,
    cache_len: Optional[int] = None,
) -> torch.Tensor:
    """`greedy_generate` with every step issued from Python, on any
    device: the CPU's path, and the card's yardstick for the graph."""
    b, t = input_ids.shape
    s = cache_len or (t + max_new_tokens)
    st = _GreedyState(cfg, b, s, max(s, max_new_tokens), params.final_ln.dtype,
                      input_ids.device, cache_grid(params))
    st.start(params, cfg, input_ids, attn_mask, eos_token_id)
    for _ in range(max_new_tokens - 1):
        _greedy_step(params, cfg, st, eos_token_id)
    return st.out[:, :max_new_tokens]


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
    """Greedy decode -> [B, max_new_tokens] int32, eos-padded after eos.

    On CUDA the decode steps replay one captured step graph, kept per
    (B, S, eos) on the parameter tree (prefill stays eager); on the CPU
    they run eagerly."""
    if not decode_graph.uses_graphs(tree_all_devices(params)):
        return greedy_generate_eager(
            params, cfg, input_ids, attn_mask, max_new_tokens,
            eos_token_id=eos_token_id, cache_len=cache_len,
        )
    b, t = input_ids.shape
    s = cache_len or (t + max_new_tokens)
    width = max(s, max_new_tokens)
    graphs = decode_graph.graphs_of(params)
    with graphs.lock:
        entry = graphs.get(
            ("greedy", b, s, width, eos_token_id),
            lambda: _greedy_graph(params, cfg, b, s, width, eos_token_id,
                                  input_ids.device, graphs.pool()),
        )
        st = entry.state
        # a fresh call sees a zero cache, as the eager path's new one
        st.cache.zero_()
        st.start(params, cfg, input_ids, attn_mask, eos_token_id)
        for _ in range(max_new_tokens - 1):
            entry.graph.replay()
        return st.out[:, :max_new_tokens].clone()


# ---------------------------------------------------------------------------
# n-gram (prompt-lookup) speculation
# ---------------------------------------------------------------------------


def bigram_draft(ctx_row, plen, last2, *, gamma: int):
    """Bigram prompt lookup: the last occurrence of (last2[0], last2[1]) in
    the prompt -> copy the `gamma` tokens that follow it as the draft; no
    match -> repeat last2[1]. `ctx_row` [..., TT], `plen` [...], `last2`
    [..., 2] -> [..., gamma]: one row as in the reference, or a batch of
    rows. The window's start is clamped to TT - min(gamma, TT), as the
    reference's `dynamic_slice_in_dim` clamps it."""
    tt = ctx_row.shape[-1]
    dev = ctx_row.device
    pos = torch.arange(tt - 1, device=dev)
    hit = (
        (ctx_row[..., :-1] == last2[..., 0:1])
        & (ctx_row[..., 1:] == last2[..., 1:2])
        & (pos + 1 < plen[..., None])
    )
    idx = torch.where(hit, pos, -1).amax(dim=-1)
    w = min(gamma, tt)
    start = (idx + 2).clamp(0, tt - 1).clamp(max=tt - w)
    win = torch.gather(ctx_row, -1, start[..., None] + torch.arange(w, device=dev))
    if w < gamma:
        win = torch.nn.functional.pad(win, (0, gamma - w))
    return torch.where((idx >= 0)[..., None], win, last2[..., 1:2])


class _SpecState:
    """`ngram_speculative_generate`'s carried state in tensors updated in
    place (the reference's while_loop carry), plus the prompt the drafts
    read, the injected acceptance draws and the loop condition."""

    def __init__(self, cfg: QwenConfig, b: int, t: int, s: int, out_w: int,
                 gamma: int, dtype, device, grid=None):
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = KVCache.zeros(cfg.layers, b, s, cfg.kv_heads, cfg.head_dim,
                                   dtype=dtype, device=device, grid=grid)
        self.ids, self.plen = zeros(b, t), zeros(b)
        self.out, self.n_out, self.last = zeros(b, out_w), zeros(b), zeros(b)
        self.limits = zeros(b)
        self.done = zeros(b, dtype=torch.bool)
        self.it = zeros()
        self.cont = zeros(dtype=torch.bool)
        self.u = zeros(b, gamma, dtype=torch.float32)

    def start(self, params, cfg, input_ids, attn_mask, eos: int, max_new: int) -> None:
        self.ids.copy_(input_ids)
        self.plen.copy_(attn_mask.sum(dim=1))
        logits, _ = qwen_prefill(params, cfg, input_ids, attn_mask, self.cache)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        self.out.fill_(eos)
        self.out[:, 0] = first
        self.n_out.fill_(1)
        self.limits.fill_(max_new)
        self.last.copy_(first)
        self.done.copy_(first == eos)
        self.it.zero_()
        self.cont.copy_(~self.done.all() & (self.it < max_new))


def spec_verify_round(params, cfg: QwenConfig, cache: KVCache, prompts, plen,
                      out, n_out, last, done, limits, *, gamma: int, eos: int,
                      accept_u: Optional[torch.Tensor] = None,
                      accept_p: Optional[float] = None,
                      cache_guard: bool = False) -> None:
    """One verify round for every lane, all in place: draft `gamma` tokens
    by bigram lookup in the lane's prompt (`prompts` [B, T], `plen` [B]),
    verify them from `last` with one `qwen_extend`, commit the accepted
    prefix (cut after the first eos, and at `limits - n_out`) into `out`
    [B, W] from column `n_out` (masked writes land on the scratch column
    W - 1), roll the cache back to the consumed prefix, then advance
    `last`, `n_out` and `done`. With `accept_p`, draft j is accepted where
    `accept_u[:, j] < accept_p` (the benchmark-only injection).
    `cache_guard` also ends a lane whose cache has no room for another
    window (the write would clamp onto live rows)."""
    w = out.shape[1]
    s = cache.max_len
    prev = torch.where(
        n_out >= 2, out.gather(1, (n_out.long() - 2).clamp(min=0)[:, None])[:, 0], last)
    drafts = bigram_draft(prompts, plen, torch.stack([prev, last], dim=1),
                          gamma=gamma)  # [B, gamma]
    window = torch.cat([last[:, None], drafts], dim=1)  # [B, g+1]
    logits, _ = qwen_extend(params, cfg, window, cache)
    targets = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, g+1]
    if accept_p is not None:
        ok = accept_u < accept_p
    else:
        ok = drafts == targets[:, :-1]  # accepted prefix: all j' <= j agree
    n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    # committed tokens = targets[0..n_acc], truncated at the first eos
    j = torch.arange(gamma + 1, device=out.device)[None]
    is_eos = (targets == eos) & (j <= n_acc[:, None])
    any_eos = is_eos.any(dim=1)
    eos_at = torch.argmax(is_eos.to(torch.int32), dim=1)
    commit = torch.where(any_eos, eos_at + 1, n_acc + 1)
    commit = torch.where(done, 0, commit)
    commit = torch.minimum(commit, (limits - n_out).clamp(min=0))
    dst = torch.where(j < commit[:, None], n_out[:, None] + j, w - 1)
    out.scatter_(1, dst.long(), targets)
    # roll the cache back to the consumed prefix: last + the accepted
    # drafts (eos truncation only shortens the output); qwen_extend
    # advanced it by gamma + 1
    cache.length.add_((torch.minimum(commit, n_acc + 1) - (gamma + 1)).to(torch.int32))
    new_last = targets.gather(1, (commit - 1).clamp(0, gamma).long()[:, None])[:, 0]
    last.copy_(torch.where(commit > 0, new_last, last))
    n_out.add_(commit.to(torch.int32))
    ended = any_eos | (n_out >= limits)
    if cache_guard:
        ended |= cache.length >= s - (gamma + 1)
    done.logical_or_(ended)


def _spec_round(params, cfg: QwenConfig, st: _SpecState, *, gamma: int, eos: int,
                max_new: int, inject_accept_p: Optional[float]) -> None:
    """One round of the reference's while_loop body: the verify round, the
    scratch tail cleaned, the round counted and the loop condition set."""
    spec_verify_round(params, cfg, st.cache, st.ids, st.plen, st.out, st.n_out,
                      st.last, st.done, st.limits, gamma=gamma, eos=eos,
                      accept_u=st.u, accept_p=inject_accept_p)
    st.out[:, max_new:] = eos
    st.it.add_(1)
    st.cont.copy_(~st.done.all() & (st.it < max_new))


def _spec_graph(params, cfg, key, device, pool) -> SimpleNamespace:
    _, b, t, s, out_w, gamma, eos, max_new, p = key
    st = _SpecState(cfg, b, t, s, out_w, gamma, params.final_ln.dtype, device,
                    cache_grid(params))
    graph = decode_graph.CapturedGraph(
        lambda: _spec_round(params, cfg, st, gamma=gamma, eos=eos,
                            max_new=max_new, inject_accept_p=p),
        device, pool,
    )
    return SimpleNamespace(state=st, graph=graph, flag=decode_graph.HostFlag(device))


def _spec_setup(cfg, input_ids, max_new_tokens, gamma, cache_len,
                inject_accept_p, inject_generator):
    b, t = input_ids.shape
    s = (cache_len or (t + max_new_tokens)) + gamma + 1  # verify overhang
    out_w = max_new_tokens + gamma + 1  # + the scratch tail
    gen = inject_generator
    if inject_accept_p is not None and gen is None:
        gen = torch.Generator(device=input_ids.device).manual_seed(0)
    return b, t, s, out_w, gen


def _draw(st: _SpecState, gen: Optional[torch.Generator]) -> None:
    """The round's injected acceptance draws (eager, before the round)."""
    if gen is not None:
        torch.rand(st.u.shape, generator=gen, device=st.u.device, out=st.u)


@torch.inference_mode()
def ngram_speculative_generate_eager(
    params: ParamTree,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded
    attn_mask: torch.Tensor,
    max_new_tokens: int,
    *,
    gamma: int = 8,
    eos_token_id: int = -1,
    cache_len: Optional[int] = None,
    inject_accept_p: Optional[float] = None,
    inject_generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`ngram_speculative_generate` with every round issued from Python and
    the loop condition read after each: the CPU's path, and the card's
    yardstick for the graph."""
    b, t, s, out_w, gen = _spec_setup(cfg, input_ids, max_new_tokens, gamma,
                                      cache_len, inject_accept_p, inject_generator)
    st = _SpecState(cfg, b, t, s, out_w, gamma, params.final_ln.dtype,
                    input_ids.device, cache_grid(params))
    st.start(params, cfg, input_ids, attn_mask, eos_token_id, max_new_tokens)
    while bool(st.cont):
        _draw(st, gen)
        _spec_round(params, cfg, st, gamma=gamma, eos=eos_token_id,
                    max_new=max_new_tokens, inject_accept_p=inject_accept_p)
    return _spec_result(st, max_new_tokens)


@torch.inference_mode()
def ngram_speculative_generate(
    params: ParamTree,
    cfg: QwenConfig,
    input_ids: torch.Tensor,  # [B, T] right-padded
    attn_mask: torch.Tensor,
    max_new_tokens: int,
    *,
    gamma: int = 8,
    eos_token_id: int = -1,
    cache_len: Optional[int] = None,
    inject_accept_p: Optional[float] = None,
    inject_generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode with n-gram (prompt-lookup) self-speculation ->
    (tokens [B, max_new_tokens] eos-padded, mean tokens per call f32).

    Token-identical to `greedy_generate`: each round drafts `gamma` tokens
    by bigram lookup in the prompt and verifies them with one
    `qwen_extend`; the committed tokens are the model's own argmaxes.
    `inject_accept_p` is the reference's benchmark-only mode: each draft is
    accepted by a Bernoulli(p) draw instead (from `inject_generator`, by
    default one seeded with 0 per call; the draws cannot match
    `jax.random`'s), so commits per call follow p and the text is no longer
    greedy's.

    On CUDA each round replays one captured graph, kept per static key on
    the parameter tree; the loop's condition (some lane live and fewer than
    `max_new_tokens` rounds) is read on the host between rounds through a
    pinned copy and an event. On the CPU the same round runs eagerly."""
    if not decode_graph.uses_graphs(tree_all_devices(params)):
        return ngram_speculative_generate_eager(
            params, cfg, input_ids, attn_mask, max_new_tokens, gamma=gamma,
            eos_token_id=eos_token_id, cache_len=cache_len,
            inject_accept_p=inject_accept_p, inject_generator=inject_generator,
        )
    b, t, s, out_w, gen = _spec_setup(cfg, input_ids, max_new_tokens, gamma,
                                      cache_len, inject_accept_p, inject_generator)
    key = ("spec", b, t, s, out_w, gamma, eos_token_id, max_new_tokens,
           inject_accept_p)
    graphs = decode_graph.graphs_of(params)
    with graphs.lock:
        entry = graphs.get(key, lambda: _spec_graph(params, cfg, key, input_ids.device,
                                                    graphs.pool()))
        st = entry.state
        st.cache.zero_()
        st.start(params, cfg, input_ids, attn_mask, eos_token_id, max_new_tokens)
        while entry.flag.read(st.cont):
            _draw(st, gen)
            entry.graph.replay()
        return _spec_result(st, max_new_tokens)


def _spec_result(st: _SpecState, max_new: int) -> tuple[torch.Tensor, torch.Tensor]:
    b = st.out.shape[0]
    mean = (st.n_out - 1).sum().float() / (st.it.float() * b).clamp(min=1.0)
    return st.out[:, :max_new].clone(), mean
