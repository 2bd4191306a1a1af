"""The two ways to run `greedy_generate`'s decode loop as CUDA graphs, side
by side on one card.

    python3 -m rag_inference_pipeline_tpu_torch.tools.bench_greedy_loop [--out PATH]

- `step`: the port's design (`models/qwen.py::greedy_generate`), one
  captured decode step replayed `max_new - 1` times, the output column
  carried in a device counter;
- `whole`: the whole `max_new - 1`-step loop captured as one graph over
  the same in-place state (`_GreedyState`, `_greedy_step`).

Qwen2.5-0.5B at full width, random bf16 weights from seed 0, B=8, right-
padded prompts of 384-512 tokens in a 512 bucket, 128 new tokens: the
shapes of `chip_smoke.py`'s decode_graph phase. The whole loop's tokens
must equal the step graph's bit for bit (the same kernels on the same
shapes). Prints ms per token of each (medians of `--rounds` alternated
rounds, host wall over a synchronised call, prefill included), each
graph's capture seconds and the memory its capture added to its pool, and
writes the line to `--out` (default `build/bench/greedy_loop.json`).
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ..models import decode_graph, qwen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, BUCKET, NEW = 8, 512, 128


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "greedy_loop.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_greedy_loop needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = qwen.QwenConfig.qwen25_05b()
    params = qwen.init_qwen_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                   dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(B)
    ids = rng.integers(1000, cfg.vocab_size - 1, (B, BUCKET)).astype(np.int32)
    lens = rng.integers(BUCKET * 3 // 4, BUCKET + 1, B)
    mask = (np.arange(BUCKET)[None] < lens[:, None]).astype(np.int32)
    ids, mask = torch.from_numpy(ids * mask).to(dev), torch.from_numpy(mask).to(dev)
    out: dict = {"card": card, "b": B, "prompt_bucket": BUCKET, "new_tokens": NEW}
    with torch.inference_mode():
        def step():
            return qwen.greedy_generate(params, cfg, ids, mask, NEW, eos_token_id=-1)

        graphs = decode_graph.graphs_of(params)
        ref = step()
        entry = graphs.entries()[0]
        s = BUCKET + NEW
        st = qwen._GreedyState(cfg, B, s, s, torch.bfloat16, dev)
        whole_graph = decode_graph.CapturedGraph(
            lambda: [qwen._greedy_step(params, cfg, st, -1) for _ in range(NEW - 1)], dev)

        def whole():
            st.cache.k.zero_()
            st.cache.v.zero_()
            st.start(params, cfg, ids, mask, -1)
            whole_graph.replay()
            return st.out[:, :NEW].clone()

        if not torch.equal(whole(), ref):
            raise RuntimeError("the whole-loop graph's tokens differ from the step graph's")
        walls: dict = {"step": [], "whole": []}
        for _ in range(args.rounds):
            for name, fn in (("step", step), ("whole", whole)):
                walls[name].append(_wall(fn))
        for name, graph in (("step", entry.graph), ("whole", whole_graph)):
            out[f"{name}_ms_per_token"] = statistics.median(walls[name]) / NEW * 1e3
            out[f"{name}_capture_s"] = graph.capture_s
            out[f"{name}_pool_mb"] = graph.pool_bytes / 2**20
        out["bit_identical"] = True
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
