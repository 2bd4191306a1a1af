"""The W8A8 products and the int8 decode step timed alone, to compare
checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_w8a8.py [--out PATH] [--sweep]
        [--plans] [--llama8b] [--against PARENT_ROOT]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times on one card, with seeded random inputs:

- each product of `chip_smoke.py` phase w8a8's shapes as the model calls it
  (`models/layers.py`: `dense_group` where the checkout has it, else one
  shared quantize and a `dense` a weight), as a replayed CUDA graph of many
  calls (an eager loop of microsecond kernels times the host), with its
  bound (`chip_smoke.py::bound`'s rule), its share of the bound and, where
  M > 16, `torch._int_mm` on the quantized rows as a yardstick; where the
  product takes the wgmma route, its first weight's GEMM alone (`gemm_ms`,
  `w8a8_gemm`, the same call in any checkout) beside `_int_mm` on it, the
  group's GEMM alone in one launch (`group_ms`) and as one launch a weight
  in turn (`singles_ms`), and its plan (Qwen2.5-0.5B,
  BERT-base, and the wgmma-route products of Llama-3.1-8B and
  Llama-3.2-1B);
- `quantize_rows` alone (`quant`) at Qwen2.5-0.5B's and Llama-3.2-1B's
  rows and at Llama-3.1-8B's down (K 14,336: 32, 72, 288 and 4,096 rows,
  bf16, and f32 at 72 and 4,096), as a replayed graph, with its bound
  (the row read once, q and s written once) and share; where the
  checkout has `_quant_plan`, its plan and, at the 8B's down, the
  long-row kernel's time on every cluster size and streamed (keys
  "path,warps,cluster");
- the products of few row tiles, and the 8B's down, in the order a layer
  runs them (`model_order`): an elementwise kernel writing x,
  `quantize_rows`, then the group's wgmma GEMM (or `torch._int_mm` a
  weight), as a replayed graph: the GEMM no longer follows another GEMM;
  and the 8B's decode products on the small-row route (B 8 and 1) after
  the elementwise kernel (`small_ms`; `front_ms` that kernel alone);
- the B = 8 greedy step of Qwen2.5-0.5B at full width (random weights
  from seed 0, prompt bucket 512) in int8 (W8A8) and in bf16: device ms a
  step over replays of the step graph, ms a token of a whole
  `greedy_generate` call (prefill included), and the kernels a step
  replays (from a torch.profiler trace); the int8 step at 16 and 32
  lanes too;
- one int8 verify round of `ngram_speculative_generate` at B = 8, gamma 8
  (72 rows; bf16 activations): device ms a round over replays of its
  graph, and from a torch.profiler trace the kernel time a round, its
  W8A8 kernels' share and their count.

`--llama8b` adds Llama-3.1-8B in W8A8 at full width and depth (random
weights from seed 0): its greedy step at 8 and 1 lanes (every product on
the small-row route) and at 32 lanes (the engine's step, the down on the
wgmma route) and its verify round at B = 8, gamma 8, each as above
(device ms, W8A8 ms and kernels from a trace, each W8A8 kernel's full
name with its launches and ms a replay); speculation's ms a
token over LLAMA_SPEC_NEW tokens at B = 8; the decode engine's wall over
`chip_smoke.py`'s 16 prompts, plain and speculative.

Each small-row product carries its plan (`small_plan`: the short-K
kernel's where the checkout has it and `_qgemm_short` picks it, else the
streaming kernel's) and, at 32 rows,
`quantize_rows` then `torch._int_mm` a weight as the library's column
(`quant_int_mm_ms`).

`--sweep` times the two routes of the checkout's `ops/w8a8.py` against each
other at 8 to 512 rows for Qwen2.5-0.5B's groups (the small-row kernel, and
`quantize_rows` + the wgmma GEMM, one launch a group where the checkout
groups), each call after an elementwise kernel that writes x, as in a
layer; beside them `torch._int_mm`, the
wgmma GEMM's plan, and the streaming small-row kernel with its quantize
done by each block alone (a cluster of one);
then the wgmma GEMM alone on every plan kind its kernel takes (`plans`:
wide tiles, 64 x 64 tiles, either split over a cluster, a weight tile
shared by a cluster's row tiles, bands of column tiles) at the 0.5B's
few-tile shapes and the 8B's and the 1B's
(`PLAN_SHAPES`), beside `torch._int_mm`, against which `_gemm_plan`'s rule
is set. `--plans` times that alone, after the small-row kernel's plans
(`small_plans`: each streaming small-row shape's plan, the clusters the
card holds at once by the library's query and how many of the grid's run
in the first wave, the most weight bytes an SM streams beside the mean,
ms a launch alone and after an elementwise kernel that writes x, and both
on clusters of 1, 2 and 8 blocks).

`--against PARENT_ROOT` compares two checkouts on one card in one call: it
copies this file into PARENT_ROOT's `rag_inference_pipeline_tpu_torch/
tools/` and runs it there and here in turns (parent, change, change,
parent), each in a process of its own (the sweep only here, `--llama8b`
in every turn), then prints and writes the four runs as one JSON.
Without it, prints one JSON line and
writes it to `--out` (default `build/bench/w8a8.json`); needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# name, M, K, the N of each weight sharing x, a bias on each: the products
# of Qwen2.5-0.5B (H 896, kv 2 x 64, I 4,864, V 151,936) at a decode step
# (B = 8), a verify round (8 x 9 rows), the engine's speculative segment
# (32 x 9), a B = 1 prefill (128) and prefill (8 x 512), and of BERT-base
# (H 768, I 3,072) at 8 x 512 tokens and its classifier
SHAPES = [
    ("decode_qkv", 8, 896, (896, 128, 128), True), ("decode_o", 8, 896, (896,), False),
    ("decode_gate_up", 8, 896, (4864, 4864), False), ("decode_down", 8, 4864, (896,), False),
    ("decode_head", 8, 896, (151936,), False), ("decode_head_b1", 1, 896, (151936,), False),
    ("verify_qo", 72, 896, (896,), True), ("verify_qkv", 72, 896, (896, 128, 128), True),
    ("verify_gate_up", 72, 896, (4864, 4864), False),
    ("verify_down", 72, 4864, (896,), False), ("verify_head", 72, 896, (151936,), False),
    ("engine_qkv", 288, 896, (896, 128, 128), True), ("engine_o", 288, 896, (896,), False),
    ("engine_gate_up", 288, 896, (4864, 4864), False),
    ("engine_down", 288, 4864, (896,), False),
    ("prefill_b1_qkv", 128, 896, (896, 128, 128), True),
    ("prefill_b1_down", 128, 4864, (896,), False),
    ("prefill_qkv", 4096, 896, (896, 128, 128), True),
    ("prefill_gate_up", 4096, 896, (4864, 4864), False),
    ("prefill_down", 4096, 4864, (896,), False),
    ("encoder_ffn_in", 4096, 768, (3072,), True), ("classifier", 8, 768, (5,), True),
    # Qwen2.5-0.5B's engine step at 32 lanes (chip_smoke.py's lanes32_ rows)
    ("lanes32_qkv", 32, 896, (896, 128, 128), True), ("lanes32_o", 32, 896, (896,), False),
    ("lanes32_gate_up", 32, 896, (4864, 4864), False),
    ("lanes32_down", 32, 4864, (896,), False), ("lanes32_head", 32, 896, (151936,), False),
    # the wgmma-route products of Llama-3.1-8B (H 4,096, kv 8 x 128, I
    # 14,336, a 128,256-row head) at a verify round (72 rows), a prefill of
    # 8 x 512 tokens, its engine step (32 lanes) and the engine's verify
    # round (32 x 9), and of Llama-3.2-1B (H 2,048, kv 8 x 64, I 8,192) at
    # a prefill: chip_smoke.py's W8A8_SHAPES
    ("l8b_verify_qkv", 72, 4096, (4096, 1024, 1024), False),
    ("l8b_verify_o", 72, 4096, (4096,), False),
    ("l8b_verify_gate_up", 72, 4096, (14336, 14336), False),
    ("l8b_verify_down", 72, 14336, (4096,), False),
    ("l8b_verify_head", 72, 4096, (128256,), False),
    ("l8b_prefill_gate_up", 4096, 4096, (14336, 14336), False),
    ("l8b_prefill_down", 4096, 14336, (4096,), False),
    ("l8b_engine_down", 32, 14336, (4096,), False),
    ("l8b_engine_verify_qkv", 288, 4096, (4096, 1024, 1024), False),
    ("l8b_engine_verify_down", 288, 14336, (4096,), False),
    ("l1b_prefill_qkv", 4096, 2048, (2048, 512, 512), False),
    ("l1b_prefill_o", 4096, 2048, (2048,), False),
    ("l1b_prefill_gate_up", 4096, 2048, (8192, 8192), False),
    ("l1b_prefill_down", 4096, 8192, (2048,), False),
    # the small-row products of the Llama family (chip_smoke.py's
    # W8A8_SHAPES): the 8B's decode step at 8 and 1 lanes and its engine's
    # 32, the 1B's decode step at 8 lanes
    *((f"l8b_decode{tag}_{name}", m, k, ns, False) for tag, m in (("", 8), ("_b1", 1))
      for name, k, ns in (("qkv", 4096, (4096, 1024, 1024)), ("o", 4096, (4096,)),
                          ("gate_up", 4096, (14336, 14336)), ("down", 14336, (4096,)),
                          ("head", 4096, (128256,)))),
    ("l8b_engine_qkv", 32, 4096, (4096, 1024, 1024), False),
    ("l8b_engine_o", 32, 4096, (4096,), False),
    ("l8b_engine_gate_up", 32, 4096, (14336, 14336), False),
    ("l8b_engine_head", 32, 4096, (128256,), False),
    ("l1b_decode_qkv", 8, 2048, (2048, 512, 512), False),
    ("l1b_decode_o", 8, 2048, (2048,), False),
    ("l1b_decode_gate_up", 8, 2048, (8192, 8192), False),
    ("l1b_decode_down", 8, 8192, (2048,), False),
    ("l1b_decode_head", 8, 2048, (128256,), False),
]
# the shapes of SHAPES at most M_STAR rows: the small-row route's, but
# for the 8B engine's down (32 x 14,336: the wgmma route)
SMALL_SHAPES = [(name, m, k, ns) for name, m, k, ns, _ in SHAPES if m <= 32]
SWEEP_ROWS = (8, 16, 24, 32, 40, 48, 56, 64, 72, 96, 128, 192, 256, 288, 384, 512)
SWEEP_SHAPES = [("qkv", 896, (896, 128, 128)), ("o", 896, (896,)),
                ("gate_up", 896, (4864, 4864)), ("down", 4864, (896,))]
# the wgmma GEMM alone on every plan its kernel takes (`_gemm_plan` forced),
# at the few-tile shapes: name, M, K, N of each weight
PLAN_SHAPES = [("verify_o", 72, 896, (896,)), ("verify_qkv", 72, 896, (896, 128, 128)),
               ("verify_gate_up", 72, 896, (4864, 4864)), ("verify_down", 72, 4864, (896,)),
               ("engine_qkv", 288, 896, (896, 128, 128)), ("engine_down", 288, 4864, (896,)),
               ("prefill_b1_down", 128, 4864, (896,)), ("m33_o", 33, 896, (896,)),
               ("m48_down", 48, 4864, (896,)), ("engine_gate_up", 288, 896, (4864, 4864)),
               ("prefill_gate_up", 4096, 896, (4864, 4864)),
               # Llama-3.1-8B's verify round, engine step, engine verify
               # round and prefill; Llama-3.2-1B's prefill gate/up
               ("l8b_verify_down", 72, 14336, (4096,)), ("l8b_verify_o", 72, 4096, (4096,)),
               ("l8b_verify_qkv", 72, 4096, (4096, 1024, 1024)),
               ("l8b_verify_gate_up", 72, 4096, (14336, 14336)),
               ("l8b_engine_down", 32, 14336, (4096,)),
               ("l8b_engine_verify_down", 288, 14336, (4096,)),
               ("l8b_engine_verify_qkv", 288, 4096, (4096, 1024, 1024)),
               ("l8b_prefill_gate_up", 4096, 4096, (14336, 14336)),
               ("l8b_prefill_down", 4096, 14336, (4096,)),
               ("l8b_prefill_qkv", 4096, 4096, (4096, 1024, 1024)),
               ("l1b_prefill_gate_up", 4096, 2048, (8192, 8192)),
               ("l1b_prefill_down", 4096, 8192, (2048,)), ("prefill_down", 4096, 4864, (896,)),
               ("encoder_ffn_out", 4096, 3072, (768,))]
PDL_SHAPES = [("prefill_gate", 4096, 896, (4864,)), ("prefill_down", 4096, 4864, (896,)),
              ("prefill_o", 4096, 896, (896,)), ("verify_head", 72, 896, (151936,)),
              ("engine_gate_up", 288, 896, (4864, 4864)),
              ("prefill_down_tp2", 4096, 2432, (896,)),
              ("encoder_ffn_out", 4096, 3072, (768,))]
# the products of few row tiles, and Llama-3.1-8B's down (K 14,336: its
# engine step's 32 rows, a verify round's 72, the engine's verify round's
# 288, a prefill's 4,096) and its verify round's o, timed in a layer's
# order (`model_order`): between them the other layers' weights evict a
# product's weights from L2, which back-to-back replays keep there
ORDER_SHAPES = [("verify_qo", 72, 896, (896,)), ("verify_qkv", 72, 896, (896, 128, 128)),
                ("verify_gate_up", 72, 896, (4864, 4864)),
                ("verify_down", 72, 4864, (896,)), ("engine_qkv", 288, 896, (896, 128, 128)),
                ("engine_down", 288, 4864, (896,)), ("prefill_b1_down", 128, 4864, (896,)),
                ("l8b_engine_down", 32, 14336, (4096,)),
                ("l8b_verify_down", 72, 14336, (4096,)),
                ("l8b_verify_o", 72, 4096, (4096,)),
                ("l8b_engine_verify_down", 288, 14336, (4096,)),
                ("l8b_prefill_down", 4096, 14336, (4096,))]
# the 8B's decode step in a layer's order on the small-row route: an
# elementwise kernel writing x, then the group's one launch
SMALL_ORDER_SHAPES = [(name, m, k, ns) for name, m, k, ns in SMALL_SHAPES
                      if name.startswith("l8b_decode_") and "head" not in name]
# `quantize_rows` alone: name, M, K, input dtype; the 8B's down also on
# every plan of the long-row kernel
QUANT_SHAPES = [("prefill_q", 4096, 896, "bfloat16"), ("verify_q", 72, 896, "bfloat16"),
                ("l1b_prefill_down", 4096, 8192, "bfloat16"),
                ("l8b_prefill_qkv", 4096, 4096, "bfloat16"),
                ("l8b_engine_down", 32, 14336, "bfloat16"),
                ("l8b_verify_down", 72, 14336, "bfloat16"),
                ("l8b_engine_verify_down", 288, 14336, "bfloat16"),
                ("l8b_prefill_down", 4096, 14336, "bfloat16"),
                ("l8b_verify_down_f32", 72, 14336, "float32"),
                ("l8b_prefill_down_f32", 4096, 14336, "float32")]
DECODE_BUCKET, DECODE_NEW, STEP_REPLAYS = 512, 64, 48
STEP_LANES, ROUND_GAMMA, ROUND_REPLAYS = (16, 32), 8, 16
# the 8B's engine step (32 lanes), speculation's tokens and the engine's
# load, as chip_smoke.py's llama_8b_int8 and llama_engine phases run them
LLAMA_STEP_LANES, LLAMA_SPEC_NEW, LLAMA_GREEDY_LANES = 32, 32, (8, 1)
ENGINE_REQUESTS, ENGINE_LANES, ENGINE_CACHE, ENGINE_SEGMENT = 16, 32, 1024, 8


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device ms a call of `fn`: `iters` calls captured as one CUDA graph,
    replayed `replays` times between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _weights(g, k, ns, bias, out_dtype):
    import torch
    from rag_inference_pipeline_tpu_torch.models.layers import QuantizedLinear

    ws = [QuantizedLinear(torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                                        dtype=torch.int8),
                          torch.rand(n, generator=g, device="cuda") * 1e-3) for n in ns]
    bs = [torch.randn(n, generator=g, device="cuda").to(out_dtype) if bias else None
          for n in ns]
    return ws, bs


def _product(x, ws, bs):
    """The checkout's product over weights sharing x, as its models call it."""
    from rag_inference_pipeline_tpu_torch.models import layers

    if hasattr(layers, "dense_group"):
        return lambda: layers.dense_group(x, ws, bs)
    return lambda: [layers.dense(x, w, b, xq=q) for q in (layers.quantize_shared(x, ws[0]),)
                    for w, b in zip(ws, bs)]


def _head(x, w):
    """The int8 head's product (f32 out) as the checkout's `_logits` runs it."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    if hasattr(w8a8, "w8a8_dense"):
        return lambda: w8a8.w8a8_dense(x, [(w.q, w.s)], out_dtype=torch.float32)
    return lambda: w8a8.w8a8_gemm(*w8a8.quantize_rows(x), w.q, w.s, out_dtype=torch.float32)


def _wgmma_group(xq, xs, weights):
    """The wgmma GEMMs of a group on quantized rows, as the checkout's
    route runs them: one launch for the group, or a launch a weight."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    if hasattr(w8a8, "_gemm_plan"):
        return lambda: w8a8._gemm_launch(xq, xs, weights, [None] * len(weights),
                                         torch.bfloat16)
    return lambda: [w8a8.w8a8_gemm(xq, xs, wq, s, out_dtype=torch.bfloat16)
                    for wq, s in weights]


def bench_shapes(g) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out = {}
    for name, m, k, ns, bias in SHAPES:
        head = "head" in name
        out_dtype = torch.float32 if head else torch.bfloat16
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        ws, bs = _weights(g, k, ns, bias, out_dtype)
        fn = _head(x, ws[0]) if head else _product(x, ws, bs)
        big = m * sum(ns) * k > 1e10
        it = 20 if big else 100
        ms = graph_ms(fn, it)
        esz = 4 if head else 2
        nbytes = (m * k * 2 + sum(n * k + 4 * n + m * n * esz + (n * esz if bias else 0)
                                  for n in ns))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2.0 * m * k * sum(ns) / INT8_OPS_PER_S) * 1e3
        row = {"ms": ms, "bound_ms": bound_ms, "of_bound": bound_ms / ms}
        if w8a8._route(m, k, True) == "qgemm":
            # the short-K kernel's plan where the checkout has that kernel
            short = getattr(w8a8, "_qgemm_short", lambda k, ns: False)(k, ns)
            pick = w8a8._qshort_plan if short else w8a8._qgemm_plan
            row["small_plan"] = [int(v) for v in pick(m, k, ns, w8a8._sms(0))]
        if m > 16:
            xq, xs = w8a8.quantize_rows(x)
            row["int_mm_ms"] = graph_ms(lambda: [torch._int_mm(xq, w.q.t()) for w in ws], it)
            # the library's column at the small-row route's rows: the
            # quantize, then one _int_mm a weight
            row["quant_int_mm_ms"] = graph_ms(lambda: [
                torch._int_mm(q, w.q.t()) for q in (w8a8.quantize_rows(x)[0],) for w in ws], it)
            if w8a8._route(m, k, True) == "wgmma":
                w0, b0 = ws[0], bs[0]
                row["gemm_ms"] = graph_ms(lambda: w8a8.w8a8_gemm(
                    xq, xs, w0.q, w0.s, b0, out_dtype=out_dtype), it)
                row["gemm_int_mm_ms"] = graph_ms(lambda: torch._int_mm(xq, w0.q.t()), it)
                row["plan"] = list(w8a8._gemm_plan(m, k, ns, w8a8._sms(0)))[:-1]
                if len(ns) > 1:  # the group's GEMM alone: one launch, and one a weight
                    weights = [(w.q, w.s) for w in ws]
                    row["group_ms"] = graph_ms(_wgmma_group(xq, xs, weights), it)
                    row["singles_ms"] = graph_ms(lambda: [w8a8.w8a8_gemm(
                        xq, xs, wq, s, out_dtype=out_dtype) for wq, s in weights], it)
        out[name] = row
        del x, ws, bs, fn
        torch.cuda.empty_cache()
    return out


def bench_quant(g) -> dict:
    """`quantize_rows` alone at each QUANT_SHAPES row, ms a call, beside its
    bound; where the checkout has `_quant_plan`, its plan and, at the 8B's
    K, the long-row kernel's other plans (`_quant_plan` forced): the row in
    registers over 1, 2, 4 and 8 blocks, and streamed over 8 blocks of 32
    warps."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out = {}
    for name, m, k, dtype in QUANT_SHAPES:
        dt = getattr(torch, dtype)
        x = torch.randn(m, k, generator=g, device="cuda").to(dt)
        it = 20 if m * k > 1e7 else 100
        ms = graph_ms(lambda: w8a8.quantize_rows(x), it)
        bound_ms = (m * k * (dt.itemsize + 1) + 4 * m) / HBM_BYTES_PER_S * 1e3
        row = {"ms": ms, "bound_ms": bound_ms, "of_bound": bound_ms / ms}
        plan_of = getattr(w8a8, "_quant_plan", None)
        if plan_of is not None:
            row["plan"] = list(plan_of(m, k, w8a8._IN_KINDS[dt], w8a8._sms(0)))
            if k == 14336:
                pieces = k * dt.itemsize // 16
                plans = [(w8a8._Q_LONG, -(-pieces // (c * 128)), c) for c in (1, 2, 4, 8)]
                try:
                    for plan in plans + [(w8a8._Q_STREAMED, 32, 8)]:
                        w8a8._quant_plan = lambda *a, plan=plan: plan
                        row[",".join(map(str, plan))] = graph_ms(
                            lambda: w8a8.quantize_rows(x), it)
                finally:
                    w8a8._quant_plan = plan_of
        out[name] = row
        del x
        torch.cuda.empty_cache()
    return out


def bench_sweep(g) -> dict:
    """The two routes against each other by rows (this checkout's kernels)."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out = {}
    for name, k, ns in SWEEP_SHAPES:
        ws, bs = _weights(g, k, ns, False, torch.bfloat16)
        weights = [(w.q, w.s) for w in ws]
        for m in SWEEP_ROWS:
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            xq, xs = w8a8.quantize_rows(x)
            gemm = _wgmma_group(xq, xs, weights)

            x0 = x.clone()

            def wgmma():
                torch.mul(x0, 1.0, out=x)  # the layer's elementwise kernel before
                w8a8.quantize_rows(x)
                return gemm()

            def qgemm():
                torch.mul(x0, 1.0, out=x)
                return w8a8.w8a8_qgemm(x, weights, out_dtype=torch.bfloat16)

            row = {"qgemm_ms": graph_ms(qgemm, 50), "wgmma_ms": graph_ms(wgmma, 50),
                   "quant_only_ms": graph_ms(lambda: w8a8.quantize_rows(x), 50),
                   "gemm_only_ms": graph_ms(gemm, 50)}
            if m > 16:
                row["int_mm_ms"] = graph_ms(lambda: [torch._int_mm(xq, wq.t())
                                                     for wq, _ in weights], 50)
            if hasattr(w8a8, "_gemm_plan"):
                row["plan"] = list(w8a8._gemm_plan(m, k, ns, w8a8._sms(0))[:3])
            # the streaming small-row kernel with every block quantizing
            # all of x (a cluster of one)
            pick, short = w8a8._qgemm_plan, w8a8._qgemm_short
            one = pick(m, k, ns, w8a8._sms(0), cluster=1)
            w8a8._qgemm_plan, w8a8._qgemm_short = (lambda *a, one=one: one), (lambda k, ns: False)
            try:
                row["qgemm_cluster1_ms"] = graph_ms(qgemm, 50)
            finally:
                w8a8._qgemm_plan, w8a8._qgemm_short = pick, short
            out[f"{name}_m{m}"] = row
    if hasattr(w8a8, "_gemm_plan"):
        out["plans"] = bench_plans(g)
    return out


def _plan_kinds(m: int, k: int, ns) -> dict:
    """The plans the kernel takes that `bench_plans` times at [M, K] x
    `ns`, by name: (bm, bn, split, share, band, deep); the few-row plans on
    the smallest swapped token tile (32, 64, 80, 128 rows) that holds M."""
    chunks = -(-k // 128)
    bm, rows = (64 if m <= 64 else 128), -(-m // 128)
    tok = next((t for t in (32, 64, 80, 128) if m <= t), 128)  # a swapped tile's rows
    wide = sum(-(-n // 128) for n in ns)
    narrow = sum(-(-n // 64) for n in ns)
    out = {"wide": (bm, 128, 1, 1, wide, False), "narrow": (64, 64, 1, 1, narrow, False)}
    for s in (2, 3, 4, 8):
        if s <= chunks:
            out[f"narrow_split{s}"] = (64, 64, s, 1, narrow, False)
            out[f"few_rows_split{s}"] = (tok, 128, s, 1, wide, True)
    for sh in ((2, 3, 4) if 1 < rows <= 4 else (2, 4) if rows > 4 else ()):
        for deep in (False, True):
            out[f"share{sh}{'_deep' if deep else ''}"] = (128, 128, 1, sh, wide, deep)
    if rows >= 8:
        for band in (4, 8, 16):
            out[f"band{band}"] = (128, 128, 1, 1, band, False)
        for sh in (2, 4):
            out[f"band8_share{sh}"] = (128, 128, 1, sh, 8, False)
            out[f"band8_share{sh}_deep"] = (128, 128, 1, sh, 8, True)
    return out


def _clusters(plan) -> int:
    """The clusters of a plan's instance the card holds at once
    (`ragtorch_w8a8_gemm_clusters`: cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from rag_inference_pipeline_tpu_torch.ops import _kernels

    bm, bn, split, share, _, deep = plan
    out = ctypes.c_int()
    rc = _kernels.load_library().ragtorch_w8a8_gemm_clusters(bm, bn, split, share,
                                                            int(deep), ctypes.byref(out))
    if rc:
        raise RuntimeError(f"ragtorch_w8a8_gemm_clusters failed: cudaError {rc}")
    return out.value


def _small_load(m: int, k: int, ns, plan) -> int:
    """The most weight bytes one SM streams on a streaming small-row plan
    (one block an SM), from the block -> unit map `_qgemm_tiles`."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    per = {}
    for b, _, mem, n0, k0, k1 in w8a8._qgemm_tiles(m, k, ns, plan):
        per[b] = per.get(b, 0) + min(w8a8._QG_TILE_ROWS, ns[mem] - n0) * (k1 - k0)
    return max(per.values())


def _small_clusters(mt: int, smem: int, cluster: int) -> int:
    """The clusters of the streaming small-row kernel the card holds at once
    (`ragtorch_w8a8_qgemm_clusters`: cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from rag_inference_pipeline_tpu_torch.ops import _kernels

    lib = _kernels.load_library()
    out = ctypes.c_int()
    rc = lib.ragtorch_w8a8_qgemm_clusters(mt, smem, cluster, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"ragtorch_w8a8_qgemm_clusters failed: cudaError {rc}")
    return out.value


def bench_small_plans(g) -> dict:
    """Each SMALL_SHAPES product of the streaming small-row kernel (not
    `_qgemm_short`'s) on the plan `_qgemm_plan` picks: the plan, a block's
    shared memory, the clusters the card holds at once (the library's
    query), the grid's clusters and how many of them run in the first
    wave, the most weight bytes one SM streams beside the average over the
    SMs, and ms a launch (a replayed graph), alone and after an elementwise
    kernel that writes x (`order_ms`, as in a step; `front_ms` that kernel
    alone); also ms on clusters of 1, 2 and 8 blocks (its plan for each: a
    wave of them) and the clusters of each the card holds."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out, pick, sms = {}, w8a8._qgemm_plan, w8a8._sms(0)
    for name, m, k, ns in SMALL_SHAPES:
        if w8a8._route(m, k, True) != "qgemm" or w8a8._qgemm_short(k, ns):
            continue
        plan = pick(m, k, ns, sms)
        smem = w8a8._qgemm_plan_smem(m, k, ns, plan)
        grid, cluster = plan.grid, plan.cluster
        fits = _small_clusters(plan.mt, smem, cluster)
        row = {"plan": [int(v) for v in plan], "smem": smem,
               "clusters": grid // cluster, "clusters_fit": fits,
               "first_wave": min(fits, grid // cluster),
               "most_sm_bytes": _small_load(m, k, ns, plan),
               "mean_sm_bytes": sum(ns) * k / sms}
        x0 = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        x = x0.clone()
        ws, _ = _weights(g, k, ns, False, torch.bfloat16)
        weights = [(w.q, w.s) for w in ws]
        out_dtype = torch.float32 if "head" in name else torch.bfloat16
        it = 10 if sum(ns) * k > 1e8 else 50

        def run():
            return w8a8.w8a8_qgemm(x, weights, out_dtype=out_dtype)

        def front():  # the layer's elementwise kernel writing x, as in a step
            torch.mul(x0, 1.0, out=x)

        def in_order():
            front()
            return run()

        row.update({"ms": graph_ms(run, it), "order_ms": graph_ms(in_order, it),
                    "front_ms": graph_ms(front, it)})
        try:
            for c in (1, 2, 8):
                try:
                    forced = pick(m, k, ns, sms, cluster=c)
                except ValueError:  # a wave of them leaves no room for a ring
                    continue
                w8a8._qgemm_plan = lambda *a, forced=forced: forced
                row[f"cluster{c}_ms"] = graph_ms(run, it)
                row[f"cluster{c}_order_ms"] = graph_ms(in_order, it)
                row[f"cluster{c}_fit"] = _small_clusters(
                    forced.mt, w8a8._qgemm_plan_smem(m, k, ns, forced), c)
        finally:
            w8a8._qgemm_plan = pick
        out[name] = row
        del x0, x, ws, weights
        torch.cuda.empty_cache()
    return out


def bench_plans(g) -> dict:
    """The wgmma GEMM of each PLAN_SHAPES group on each plan kind its
    kernel takes (`_plan_kinds`: wide 128-column tiles over all of K; 64 x
    64 tiles; either split over a cluster of 2, 3, 4, 8 blocks, the
    128-column split swapped; a weight tile shared by 2 to 4 row tiles'
    blocks, two blocks an SM or one; bands of column tiles), beside
    `torch._int_mm` on each weight and, for each plan of a cluster, the
    clusters the card holds at once; then, on the plan
    `_gemm_plan` picks, with programmatic dependent launch off and on
    (`_pdl` forced), there and at prefill's shapes; ms a launch."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out, pick, pdl = {}, w8a8._gemm_plan, w8a8._pdl
    for name, m, k, ns in PLAN_SHAPES:
        ws, _ = _weights(g, k, ns, False, torch.bfloat16)
        weights = [(w.q, w.s) for w in ws]
        xq, xs = w8a8.quantize_rows(torch.randn(m, k, generator=g, device="cuda")
                                    .to(torch.bfloat16))
        it = 10 if m * k * sum(ns) > 1e10 else 50
        row = {"picked": list(pick(m, k, ns, w8a8._sms(0)))[:-1],
               "int_mm": graph_ms(lambda: [torch._int_mm(xq, wq.t()) for wq, _ in weights],
                                  it)}
        try:
            for kind, plan in _plan_kinds(m, k, ns).items():
                w8a8._gemm_plan = lambda *a, plan=plan: (*plan, 0)
                key = f"{kind}={','.join(str(int(v)) for v in plan)}"
                row[key] = graph_ms(_wgmma_group(xq, xs, weights), it)
                if plan[2] * plan[3] > 1:
                    row[f"clusters_{key}"] = _clusters(plan)
        finally:
            w8a8._gemm_plan = pick
        out[name] = row
        del ws, weights, xq, xs
        torch.cuda.empty_cache()
    # the picked plan with programmatic dependent launch forced off and on
    for name, m, k, ns in PLAN_SHAPES[:4] + PDL_SHAPES:
        ws, _ = _weights(g, k, ns, False, torch.bfloat16)
        weights = [(w.q, w.s) for w in ws]
        xq, xs = w8a8.quantize_rows(torch.randn(m, k, generator=g, device="cuda")
                                    .to(torch.bfloat16))
        row = out.setdefault(name, {})
        try:
            for on in (False, True):
                w8a8._pdl = lambda *a, on=on: on
                row[f"pdl_{int(on)}"] = graph_ms(_wgmma_group(xq, xs, weights),
                                                 20 if m >= 4096 else 50)
        finally:
            w8a8._pdl = pdl
    return out


def bench_model_order(g) -> dict:
    """Each ORDER_SHAPES group as a layer runs it: an elementwise kernel
    writing x (bf16), `quantize_rows`, then the group's wgmma GEMM
    (`gemm_ms`), or `torch._int_mm` a weight instead (`int_mm_ms`), or
    nothing (`quant_ms`); where the checkout has `_pdl`, the GEMM with
    programmatic dependent launch forced off and on too
    (`gemm_pdl_off_ms`, `gemm_pdl_on_ms`).
    ms a call of the three or two kernels."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    out = {}
    for name, m, k, ns in ORDER_SHAPES:
        ws, _ = _weights(g, k, ns, False, torch.bfloat16)
        weights = [(w.q, w.s) for w in ws]
        x0 = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        x = x0.clone()

        def front():
            torch.mul(x0, 1.0, out=x)
            return w8a8.quantize_rows(x)

        def with_gemm():
            return _wgmma_group(*front(), weights)()

        def with_int_mm():
            xq = front()[0]
            return [torch._int_mm(xq, wq.t()) for wq, _ in weights]

        row = {"gemm_ms": graph_ms(with_gemm, 50), "int_mm_ms": graph_ms(with_int_mm, 50),
               "quant_ms": graph_ms(front, 50)}
        if hasattr(w8a8, "_pdl"):
            pdl = w8a8._pdl
            try:
                for on in (False, True):
                    w8a8._pdl = lambda *a, on=on: on
                    row[f"gemm_pdl_{'on' if on else 'off'}_ms"] = graph_ms(with_gemm, 50)
            finally:
                w8a8._pdl = pdl
        out[name] = row
    for name, m, k, ns in SMALL_ORDER_SHAPES:
        ws, _ = _weights(g, k, ns, False, torch.bfloat16)
        x0 = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        x = x0.clone()

        def small():
            torch.mul(x0, 1.0, out=x)
            return _product(x, ws, [None] * len(ws))()

        out[name] = {"small_ms": graph_ms(small, 50),
                     "front_ms": graph_ms(lambda: torch.mul(x0, 1.0, out=x), 50)}
        del ws, x0, x
        torch.cuda.empty_cache()
    return out


def _decoder(name: str, weights: str):
    """(cfg, params): Qwen2.5-0.5B ("qwen05b") or Llama-3.1-8B ("llama8b")
    at full width and depth, random bf16 weights from seed 0, W8A8
    quantized at the source for `weights` "int8"."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    cfg = (qwen.QwenConfig.qwen25_05b() if name == "qwen05b"
           else qwen.QwenConfig.llama31_8b())
    g = torch.Generator(device="cuda").manual_seed(0)
    return cfg, qwen.init_qwen_params(cfg, generator=g, dtype=torch.bfloat16,
                                      device=torch.device("cuda"),
                                      quantize=weights == "int8")


def _trace(entry) -> dict:
    """From a torch.profiler trace of 8 replays of `entry`'s graph: kernel
    ms a replay, the W8A8 kernels' ms, and the count of each."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            entry.graph.replay()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    w8 = [e for e in kern if "w8a8" in e.name or "quantize_rows" in e.name]
    if not kern:
        return {"kernel_ms": "not measured (no device events)"}
    by_name = {}
    for e in w8:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us()
    return {"kernel_ms": sum(e.time_range.elapsed_us() for e in kern) / 8e3,
            "w8a8_ms": sum(e.time_range.elapsed_us() for e in w8) / 8e3,
            "kernels": len(kern) // 8, "w8a8_kernels": len(w8) // 8,
            # each W8A8 kernel's full name: launches and ms a replay
            "w8a8_by_name": {n: [c // 8, us / 8e3] for n, (c, us) in by_name.items()}}


def bench_round(model=None) -> dict:
    """One int8 verify round of ngram_speculative_generate at B = 8, gamma
    8 (72 rows, bf16 activations) of `model` (cfg, params; default
    Qwen2.5-0.5B): device ms a round over replays of its graph (CUDA
    events), and from a torch.profiler trace of 8 replays the kernel ms a
    round, the W8A8 kernels' ms and their count."""
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen

    cfg, params = model or _decoder("qwen05b", "int8")
    ids, mask = _prompts(np, torch, 8, cfg.vocab_size)
    before = len(decode_graph.graphs_of(params))
    qwen.ngram_speculative_generate(params, cfg, ids, mask, DECODE_NEW,
                                    gamma=ROUND_GAMMA, eos_token_id=-1)
    entry = next(e for e in decode_graph.graphs_of(params).entries()[before:]
                 if hasattr(e, "flag"))

    def restart():
        entry.state.cache.zero_()
        entry.state.start(params, cfg, ids, mask, -1, DECODE_NEW)
        torch.cuda.synchronize()

    restart()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ROUND_REPLAYS):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    out = {"round_ms": start.elapsed_time(end) / ROUND_REPLAYS}
    restart()
    out.update(_trace(entry))
    del params, entry
    torch.cuda.empty_cache()
    return out


def _prompts(np, torch, b: int, vocab: int = 151936):
    rng = np.random.default_rng(8)
    ids = rng.integers(1000, vocab - 1, (b, DECODE_BUCKET)).astype(np.int32)
    lens = rng.integers(DECODE_BUCKET * 3 // 4, DECODE_BUCKET + 1, b)
    mask = (np.arange(DECODE_BUCKET)[None] < lens[:, None]).astype(np.int32)
    return torch.from_numpy(ids * mask).cuda(), torch.from_numpy(mask).cuda()


def bench_step(weights: str, b: int = 8, model=None) -> dict:
    """The greedy step of `model` (cfg, params; default Qwen2.5-0.5B in
    `weights`) at B lanes: step graph replays, a whole call's ms a token,
    and from a trace the kernels, W8A8 kernels and their ms a step."""
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen

    cfg, params = model or _decoder("qwen05b", weights)
    ids, mask = _prompts(np, torch, b, cfg.vocab_size)
    before = len(decode_graph.graphs_of(params))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qwen.greedy_generate(params, cfg, ids, mask, DECODE_NEW, eos_token_id=-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    entry = decode_graph.graphs_of(params).entries()[before]
    entry.state.start(params, cfg, ids, mask, -1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEP_REPLAYS):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / STEP_REPLAYS
    entry.state.start(params, cfg, ids, mask, -1)
    trace = _trace(entry)
    out = {"step_ms": step_ms, "ms_per_token": min(walls[1:]) / DECODE_NEW * 1e3,
           "kernels_a_step": trace.pop("kernels", None), **trace}
    del params, entry
    torch.cuda.empty_cache()
    return out


def bench_llama8b() -> dict:
    """Llama-3.1-8B in W8A8 (`--llama8b`): its greedy step at 32 lanes and
    its verify round at B = 8, gamma 8 (`bench_step`, `bench_round`);
    speculation's ms a token over LLAMA_SPEC_NEW tokens at B = 8 (the third
    call's wall: the first captures its graph); the decode engine's wall
    over chip_smoke.py's 16 prompts (lengths 64-512, budgets 16-128 from
    seed 31), plain and speculative, each after its construction's
    capture."""
    import asyncio
    import gc

    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
    from rag_inference_pipeline_tpu_torch.models import qwen

    cfg, params = _decoder("llama8b", "int8")
    model = (cfg, params)
    out = {f"step_b{b}": bench_step("int8", b, model) for b in LLAMA_GREEDY_LANES}
    out.update({"step_b32": bench_step("int8", LLAMA_STEP_LANES, model),
                "round_b8": bench_round(model)})
    ids, mask = _prompts(np, torch, 8, cfg.vocab_size)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qwen.ngram_speculative_generate(params, cfg, ids, mask, LLAMA_SPEC_NEW,
                                        gamma=ROUND_GAMMA, eos_token_id=-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["spec_ms_per_token"] = min(walls[1:]) / LLAMA_SPEC_NEW * 1e3
    rng = np.random.default_rng(31)
    lens = rng.integers(64, 513, ENGINE_REQUESTS)
    budgets = rng.integers(16, 129, ENGINE_REQUESTS)
    prompts = [rng.integers(1000, cfg.vocab_size - 1, int(k)).astype(np.int32) for k in lens]
    for spec in (False, True):
        eng = DecodeEngine(params, cfg, lanes=ENGINE_LANES, cache_len=ENGINE_CACHE,
                           segment_steps=ENGINE_SEGMENT, eos_token_id=-1,
                           admit_buckets=(1, 2, 4, 8, 16, 32),
                           prefill_buckets=(128, 256, 512), speculative=spec,
                           gamma=ROUND_GAMMA)

        async def serve():
            await eng.start()
            try:
                return await asyncio.gather(*(eng.submit(p, int(n))
                                              for p, n in zip(prompts, budgets)))
            finally:
                await eng.stop()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.new_event_loop().run_until_complete(serve())
        torch.cuda.synchronize()
        tag = "spec" if spec else "plain"
        out[f"engine_{tag}_wall_s"] = time.perf_counter() - t0
        out[f"engine_{tag}_tokens"] = eng.tokens_generated
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def against(parent: str, sweep: bool, llama8b: bool = False) -> dict:
    """This checkout and `parent` in turns (parent, change, change,
    parent), each run a process of its own on this file."""
    import shutil

    here = os.path.abspath(__file__)
    there = os.path.join(os.path.abspath(parent), "rag_inference_pipeline_tpu_torch",
                         "tools", os.path.basename(here))
    if os.path.abspath(there) != here:
        shutil.copyfile(here, there)
    turns = []
    for i, (tag, script) in enumerate((("parent", there), ("change", here),
                                       ("change", here), ("parent", there))):
        out = os.path.join(ROOT, "build", "bench", f"w8a8_turn{i}_{tag}.json")
        cmd = [sys.executable, script, "--out", out]
        if sweep and tag == "change" and i == 1:
            cmd.append("--sweep")
        if llama8b:
            cmd.append("--llama8b")
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
        with open(out) as fh:
            turns.append({"tag": tag, **json.load(fh)})
    return {"turns": turns}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "w8a8.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="time the two routes against each other by rows")
    ap.add_argument("--plans", action="store_true",
                    help="time only the wgmma GEMM on every plan kind")
    ap.add_argument("--llama8b", action="store_true",
                    help="also time Llama-3.1-8B's W8A8 step, verify round, "
                         "speculation and engine")
    ap.add_argument("--against", metavar="PARENT_ROOT",
                    help="time PARENT_ROOT's checkout and this one in turns")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_w8a8 needs a CUDA card")
    if args.against:
        out = against(args.against, args.sweep, args.llama8b)
    else:
        from rag_inference_pipeline_tpu_torch.ops import _kernels

        _kernels.load_library()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        g = torch.Generator(device="cuda").manual_seed(0)
        with torch.inference_mode():
            if args.plans:
                out = {"root": ROOT, "card": smi, "small_plans": bench_small_plans(g),
                       "plans": bench_plans(g)}
                return _write(out, args.out)
            out = {"root": ROOT, "card": smi, "shapes": bench_shapes(g),
                   "quant": bench_quant(g)}
            if args.sweep:
                out["sweep"] = bench_sweep(g)
            out["model_order"] = bench_model_order(g)
            out["step_int8"] = bench_step("int8")
            out["step_bf16"] = bench_step("bf16")
            for b in STEP_LANES:
                out[f"step_int8_b{b}"] = bench_step("int8", b)
            out["round_int8"] = bench_round()
            if args.llama8b:
                out["llama8b"] = bench_llama8b()
    return _write(out, args.out)


def _write(out: dict, path: str) -> dict:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
