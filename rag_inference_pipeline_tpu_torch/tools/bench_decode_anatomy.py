"""Decode anatomy: where does one Qwen decode step's time go?

Port of `scripts/bench_decode_anatomy.py`. Each variant is one ablation
of the decode step, timed per step at each batch size over `--length`
steps, `--reps` times:

  real     the port's `qwen_decode_step` on its stacked in-place cache
  full     the same step written out over per-layer caches, the k/v row
           inserted by `index_copy_` (the port's own decode insert)
  nocache  attention over the warm cache only (no insert)
  nohead   no lm head and argmax; a token made from the hidden state
  noattn   no attention (projections, MLP and head; insert as `full`)
  onehot   the insert as a masked rewrite of the whole cache
  atset    the insert as one batched indexed write
  kernel   the insert by kernel K7 (`ops/kv.py::kv_row_insert_pair`),
           one launch per layer for K and V: the reference's `pallas`
           variant, which launches its kernel once per cache

The insert variants write the same values as `full`, so their tokens must
agree with it (at least 0.9 of the lanes, as the reference asserts). Each
call restores the per-layer caches from the warm prefill (2 x layers
copies, inside the timing: well under 1% of a call).

Each variant is timed twice: eagerly, every op issued from Python (row
`bf16_b{B}_{variant}`), and as one CUDA graph of the whole call, as the
reference times one jitted scan of `--length` steps (row
`..._graph`). The graph is captured once per batch and variant
(`models/decode_graph.py`), then replayed with a new start token per call;
its tokens must equal the eager call's bit for bit (same kernels, same
shapes). The `kernel` variant captures the K7 pair inside the graph. The
pair's launch count holds only the launches its wrapper made (the eager
calls and the capture's eager warm-up); the K7 launches of one replay are
counted by name in a torch.profiler trace (`graph_k7_per_replay`).

    python -m rag_inference_pipeline_tpu_torch.tools.bench_decode_anatomy
    python -m rag_inference_pipeline_tpu_torch.tools.bench_decode_anatomy --smoke

Without `--smoke` it runs Qwen2.5-0.5B at full width with random bf16
weights on the card (prompt 128, cache 384) and raises without one;
`--smoke` runs the tiny config in float32 on the CPU (host clock: no
device number). Weights are bf16 only: the reference's int8 rows need
the W8A8 path, which the port does not carry yet (ROADMAP Queue 1 item 5).
Results go to `build/bench/decode_anatomy.json`, or `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.layers import apply_rope, attention, dense, rms_norm
from ..models import decode_graph
from ..models.qwen import (
    KVCache,
    QwenConfig,
    _logits,
    _rope_tables,
    init_qwen_params,
    qwen_decode_step,
    qwen_prefill,
)
from ..ops.kv import kv_row_insert_pair

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "bench",
)
VARIANTS = ("real", "full", "nocache", "nohead", "noattn", "onehot", "atset", "kernel")
INSERTS = ("onehot", "atset", "kernel")  # held to `full`'s tokens
K7_KERNEL = "kv_row_insert_kernel"  # csrc/kv_row_insert.cu
AGREE_BAR = 0.9


def _insert(variant: str, cache: torch.Tensor, new: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """The layer's cache [B, S, H, D] after writing `new` [B, H, D] at
    `positions` [B] int32, by the variant's method."""
    b, s = cache.shape[:2]
    lanes = torch.arange(b, device=cache.device)
    if variant == "onehot":
        hit = torch.arange(s, device=cache.device)[None, :] == positions[:, None]
        return torch.where(hit[:, :, None, None], new[:, None], cache)
    if variant == "atset":
        cache[lanes, positions.long()] = new
        return cache
    rows = lanes * s + torch.clamp(positions.long(), max=s - 1)
    cache.view(b * s, *cache.shape[2:]).index_copy_(0, rows, new)
    return cache


def step_variant(params, cfg: QwenConfig, tok: torch.Tensor, ck: list,
                 cv: list, positions: torch.Tensor, variant: str) -> torch.Tensor:
    """One decode position over per-layer caches `ck`/`cv` (lists, updated
    in place or replaced); returns the next token [B] int32."""
    b = tok.shape[0]
    cos, sin = _rope_tables(cfg, tok.device)
    x = params.embed[tok.long()][:, None, :]
    pos2 = positions.long()[:, None]
    s = ck[0].shape[1]
    span = torch.arange(s, device=tok.device)[None, None, None, :] <= pos2[:, :, None, None]
    for li, lp in enumerate(params.layers):
        y = rms_norm(x, lp.in_ln, cfg.eps)
        q = dense(y, lp.q_w, lp.get("q_b")).reshape(b, 1, cfg.heads, cfg.head_dim)
        k = dense(y, lp.k_w, lp.get("k_b")).reshape(b, 1, cfg.kv_heads, cfg.head_dim)
        v = dense(y, lp.v_w, lp.get("v_b")).reshape(b, 1, cfg.kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin, pos2)
        k = apply_rope(k, cos, sin, pos2)
        if variant == "kernel":
            kv_row_insert_pair(ck[li], cv[li], k[:, 0].contiguous(),
                               v[:, 0].contiguous(), positions)
        elif variant != "nocache":
            ck[li] = _insert(variant, ck[li], k[:, 0].contiguous(), positions)
            cv[li] = _insert(variant, cv[li], v[:, 0].contiguous(), positions)
        if variant == "noattn":
            a = q.reshape(b, 1, -1)
        else:
            a = attention(q, ck[li], cv[li], span).reshape(b, 1, -1)
        x = x + dense(a, lp.o_w)
        y2 = rms_norm(x, lp.post_ln, cfg.eps)
        ff = torch.nn.functional.silu(dense(y2, lp.gate_w)) * dense(y2, lp.up_w)
        x = x + dense(ff, lp.down_w)
    if variant == "nohead":
        return x[:, 0].sum(dim=-1).to(torch.int32) % (cfg.vocab_size - 2) + 1
    return torch.argmax(_logits(params, cfg, x)[:, 0], dim=-1).to(torch.int32)


def make_model(smoke: bool, device: torch.device):
    """(cfg, params): the tiny config in float32, or Qwen2.5-0.5B in bf16,
    random weights from seed 0."""
    cfg = QwenConfig.tiny() if smoke else QwenConfig.qwen25_05b()
    dtype = torch.float32 if smoke else torch.bfloat16
    g = torch.Generator(device=device).manual_seed(0)
    return cfg, init_qwen_params(cfg, generator=g, dtype=dtype, device=device)


def warm_cache(params, cfg: QwenConfig, b: int, t_prompt: int, cache_len: int,
               rng: np.random.Generator) -> tuple[KVCache, torch.Tensor]:
    """A cache prefilled with a random `t_prompt`-token prompt per lane,
    and a first token per lane."""
    dev = params.final_ln.device
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (b, t_prompt))).to(dev)
    cache = KVCache.zeros(cfg.layers, b, cache_len, cfg.kv_heads, cfg.head_dim,
                          dtype=params.final_ln.dtype, device=dev)
    _, warm = qwen_prefill(params, cfg, ids, torch.ones_like(ids), cache)
    tok0 = torch.from_numpy(rng.integers(1, cfg.vocab_size - 1, (b,))).to(dev)
    return warm, tok0.to(torch.int32)


def make_loop(params, cfg: QwenConfig, variant: str, warm: KVCache, length: int):
    """call(tok) -> the last of `length` tokens decoded from the warm cache."""
    pos0 = warm.length.clone()

    if variant == "real":
        def call(tok):
            cache = KVCache(warm.k.clone(), warm.v.clone(), warm.length.clone())
            for _ in range(length):
                logits, cache = qwen_decode_step(params, cfg, tok, cache)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return tok

        return call

    def call(tok):
        ck = [warm.k[i].clone() for i in range(cfg.layers)]
        cv = [warm.v[i].clone() for i in range(cfg.layers)]
        pos = pos0
        for _ in range(length):
            tok = step_variant(params, cfg, tok, ck, cv, pos, variant)
            pos = pos + 1
        return tok

    return call


def graph_call(call, tok0: torch.Tensor):
    """`call` captured as one CUDA graph -> (replay(tok) -> the call's
    token, the graph). The start token goes through a static input. The
    capture's warm-up runs `call` eagerly, so it counts its K7 launches;
    the capture records them into the graph and counts none."""
    tok_in = tok0.clone()
    out: dict = {}

    def body():
        out["tok"] = call(tok_in)

    graph = decode_graph.CapturedGraph(body, tok0.device)

    def replay(tok):
        tok_in.copy_(tok)
        graph.replay()
        return out["tok"]

    return replay, graph


def traced_launches(fn, kernel: str) -> int:
    """The launches of the device kernel named `kernel` while `fn()` runs,
    counted by name in a torch.profiler trace; -1 where the trace holds no
    device events."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(kernel in e.name for e in events) if events else -1


def _timed(call, tok0, reps: int, length: int, vocab: int) -> tuple[torch.Tensor, float]:
    """The first call's tokens (a warm-up), and ms per step over `reps`
    more calls, each from a distinct start token inside [1, V-2]."""
    first = call(tok0).cpu()
    t0 = time.perf_counter()
    for r in range(reps):
        call((tok0 + r) % (vocab - 2) + 1).cpu()
    return first, (time.perf_counter() - t0) / (reps * length) * 1e3


def probe(params, cfg: QwenConfig, batches, length: int, reps: int,
          cache_len: int, t_prompt: int, graphs: bool = False,
          k7_graph: Optional[dict] = None) -> dict:
    """ms per step of every variant at every batch size, eager and (with
    `graphs`) as a replayed graph, and the insert variants' token agreement
    with `full`. With `graphs`, `k7_graph[B]` gets the K7 launches that one
    replay of the `kernel` variant's graph made, by the device's trace."""
    rng = np.random.default_rng(0)
    rows: dict = {}
    k7_graph = {} if k7_graph is None else k7_graph
    for b in batches:
        warm, tok0 = warm_cache(params, cfg, b, t_prompt, cache_len, rng)
        ref_tok = None
        for variant in VARIANTS:
            call = make_loop(params, cfg, variant, warm, length)
            first, ms = _timed(call, tok0, reps, length, cfg.vocab_size)
            rows[f"bf16_b{b}_{variant}"] = ms
            if graphs:
                replay, graph = graph_call(call, tok0)
                g_first, g_ms = _timed(replay, tok0, reps, length, cfg.vocab_size)
                if not torch.equal(g_first, first):
                    raise RuntimeError(f"{variant} at B={b}: the graph's tokens "
                                       "differ from the eager call's")
                rows[f"bf16_b{b}_{variant}_graph"] = g_ms
                rows[f"bf16_b{b}_{variant}_graph_capture_s"] = graph.capture_s
                if variant == "kernel":
                    # K7 nodes a replay runs, read from the device's trace
                    k7_graph[b] = traced_launches(lambda: replay(tok0), K7_KERNEL)
                print(f"bf16 B={b} {variant}: graph {g_ms:.3f} ms/step", flush=True)
                del replay, graph
            if variant == "full":
                ref_tok = first
            elif variant in INSERTS:
                agree = float((first == ref_tok).float().mean())
                rows[f"bf16_b{b}_{variant}_agree"] = agree
                if agree < AGREE_BAR:
                    raise RuntimeError(f"{variant} at B={b}: tokens agree with "
                                       f"full on {agree:.3f} of the lanes")
            print(f"bf16 B={b} {variant}: {ms:.3f} ms/step", flush=True)
    return rows


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny config in float32 on the CPU")
    ap.add_argument("--length", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--cache-len", type=int, default=384)
    ap.add_argument("--weights", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv: Optional[list[str]] = None) -> dict:
    args = parse_args(argv)
    if args.weights != "bf16":
        raise NotImplementedError(
            "--weights int8 needs the W8A8 decoder (quantize_qwen_params, "
            "_qdense, QuantizedEmbed), which the port does not carry yet: "
            "ROADMAP Queue 1 item 5"
        )
    dev = resolve_device("cpu" if args.smoke else None)
    length = 4 if args.smoke else args.length
    cache_len = 32 if args.smoke else args.cache_len
    t_prompt = 8 if args.smoke else 128
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} L={length}", flush=True)
    graphs = decode_graph.uses_graphs(dev)
    with torch.inference_mode():
        cfg, params = make_model(args.smoke, dev)
        k7_graph: dict = {}
        rows = probe(params, cfg, args.batches, length, args.reps, cache_len,
                     t_prompt, graphs=graphs, k7_graph=k7_graph)
    out = {"device": kind, "length": length, "reps": args.reps,
           "cache_len": cache_len, "t_prompt": t_prompt, "layers": cfg.layers,
           "batches": args.batches, "weights": args.weights,
           # eager calls of each variant per batch: one warm-up, then the
           # reps, and with graphs the capture's warm-up (the capture itself
           # and the replays call no wrapper)
           "calls_per_variant": 1 + args.reps + (1 if graphs else 0),
           # K7 launches of one replay of the kernel variant's graph, by B
           "graph_k7_per_replay": {str(b): n for b, n in k7_graph.items()},
           "rows": rows}
    path = args.out or os.path.join(OUT_DIR, "decode_anatomy.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {path}", flush=True)
    return out


if __name__ == "__main__":
    main()
