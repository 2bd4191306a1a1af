"""The W8A8 products and the int8 decode step timed alone, to compare
checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_w8a8.py [--out PATH] [--sweep]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times on one card, with seeded random inputs:

- each product of `chip_smoke.py` phase w8a8's shapes as the model calls it
  (`models/layers.py`: `dense_group` where the checkout has it, else one
  shared quantize and a `dense` a weight), as a replayed CUDA graph of many
  calls (an eager loop of microsecond kernels times the host), with its
  bound (`chip_smoke.py::bound`'s rule), its share of the bound and, where
  M > 16, `torch._int_mm` on the quantized rows as a yardstick;
- the B = 8 greedy step of Qwen2.5-0.5B at full width (random weights
  from seed 0, prompt bucket 512) in int8 (W8A8) and in bf16: device ms a
  step over replays of the step graph, ms a token of a whole
  `greedy_generate` call (prefill included), and the kernels a step
  replays (from a torch.profiler trace).

`--sweep` times the two routes of the checkout's `ops/w8a8.py` against each
other at 8 to 256 rows for the decode shapes (the small-row kernel, and
`quantize_rows` + the wgmma GEMM): where they cross sets `M_STAR`; and the
small-row kernel with its quantize shared by a cluster of 8 blocks (where
the plan clusters) and done by each block alone.

To compare two checkouts in one call on the same card, copy this file into
the other checkout's `rag_inference_pipeline_tpu_torch/tools/` and run both
in turns (parent, change, change, parent). Prints one JSON line and writes
it to `--out` (default `build/bench/w8a8.json`); needs a card.
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
# (B = 8), a verify round (8 x 9 rows) and prefill (8 x 512), and of
# BERT-base (H 768, I 3,072) at 8 x 512 tokens and its classifier
SHAPES = [
    ("decode_qkv", 8, 896, (896, 128, 128), True), ("decode_o", 8, 896, (896,), False),
    ("decode_gate_up", 8, 896, (4864, 4864), False), ("decode_down", 8, 4864, (896,), False),
    ("decode_head", 8, 896, (151936,), False), ("decode_head_b1", 1, 896, (151936,), False),
    ("verify_qo", 72, 896, (896,), True), ("verify_head", 72, 896, (151936,), False),
    ("prefill_qkv", 4096, 896, (896, 128, 128), True),
    ("prefill_gate_up", 4096, 896, (4864, 4864), False),
    ("prefill_down", 4096, 4864, (896,), False),
    ("encoder_ffn_in", 4096, 768, (3072,), True), ("classifier", 8, 768, (5,), True),
]
SWEEP_ROWS = (8, 16, 24, 32, 48, 64, 72, 96, 128, 192, 256)
SWEEP_SHAPES = [("qkv", 896, (896, 128, 128)), ("o", 896, (896,)),
                ("gate_up", 896, (4864, 4864)), ("down", 4864, (896,))]
DECODE_BUCKET, DECODE_NEW, STEP_REPLAYS = 512, 64, 48


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


def bench_shapes(g) -> dict:
    import torch

    out = {}
    for name, m, k, ns, bias in SHAPES:
        head = "head" in name
        out_dtype = torch.float32 if head else torch.bfloat16
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        ws, bs = _weights(g, k, ns, bias, out_dtype)
        fn = _head(x, ws[0]) if head else _product(x, ws, bs)
        big = m * sum(ns) * k > 1e10
        ms = graph_ms(fn, 20 if big else 100)
        esz = 4 if head else 2
        nbytes = (m * k * 2 + sum(n * k + 4 * n + m * n * esz + (n * esz if bias else 0)
                                  for n in ns))
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2.0 * m * k * sum(ns) / INT8_OPS_PER_S) * 1e3
        row = {"ms": ms, "bound_ms": bound_ms, "of_bound": bound_ms / ms}
        if m > 16:
            xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            row["int_mm_ms"] = graph_ms(lambda: [torch._int_mm(xq, w.q.t()) for w in ws],
                                        20 if big else 100)
        out[name] = row
        del x, ws, bs, fn
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

            def wgmma():
                xq, xs = w8a8.quantize_rows(x)
                return [w8a8.w8a8_gemm(xq, xs, wq, s, out_dtype=torch.bfloat16)
                        for wq, s in weights]

            def qgemm():
                return w8a8.w8a8_qgemm(x, weights, out_dtype=torch.bfloat16)

            xq, xs = w8a8.quantize_rows(x)
            row = {"qgemm_ms": graph_ms(qgemm, 50), "wgmma_ms": graph_ms(wgmma, 50),
                   "quant_only_ms": graph_ms(lambda: w8a8.quantize_rows(x), 50),
                   "gemm_only_ms": graph_ms(lambda: w8a8.w8a8_gemm(
                       xq, xs, *weights[0], out_dtype=torch.bfloat16), 50)}
            # the small-row kernel with its m tile's quantize shared by a
            # cluster of 8 blocks (where the plan clusters), and done by
            # each block alone
            keep = w8a8._QG_CLUSTER
            w8a8._QG_CLUSTER = 1
            try:
                row["qgemm_cluster1_ms"] = graph_ms(qgemm, 50)
            finally:
                w8a8._QG_CLUSTER = keep
            out[f"{name}_m{m}"] = row
    return out


def _kernels_a_step(entry) -> int:
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(8):
            entry.graph.replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) // 8


def bench_step(weights: str) -> dict:
    """The B = 8 greedy step of Qwen2.5-0.5B: step graph replays, a whole
    call's ms a token, kernels a step."""
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen

    cfg = qwen.QwenConfig.qwen25_05b()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = qwen.init_qwen_params(cfg, generator=g, dtype=torch.bfloat16,
                                   device=torch.device("cuda"), quantize=weights == "int8")
    rng = np.random.default_rng(8)
    ids = rng.integers(1000, 151935, (8, DECODE_BUCKET)).astype(np.int32)
    lens = rng.integers(DECODE_BUCKET * 3 // 4, DECODE_BUCKET + 1, 8)
    mask = (np.arange(DECODE_BUCKET)[None] < lens[:, None]).astype(np.int32)
    ids = torch.from_numpy(ids * mask).cuda()
    mask = torch.from_numpy(mask).cuda()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qwen.greedy_generate(params, cfg, ids, mask, DECODE_NEW, eos_token_id=-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    entry = decode_graph.graphs_of(params).entries()[0]
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
    kernels = _kernels_a_step(entry)
    out = {"step_ms": step_ms, "ms_per_token": min(walls[1:]) / DECODE_NEW * 1e3,
           "kernels_a_step": kernels}
    del params, entry
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "w8a8.json"))
    ap.add_argument("--sweep", action="store_true",
                    help="time the two routes against each other by rows")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_w8a8 needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import _kernels

    _kernels.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        out = {"root": ROOT, "card": smi, "shapes": bench_shapes(g)}
        if args.sweep:
            out["sweep"] = bench_sweep(g)
        out["step_int8"] = bench_step("int8")
        out["step_bf16"] = bench_step("bf16")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
