"""K5 and K7 timed alone on seeded synthetic inputs, to compare checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_k5k7.py [--out PATH]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times, with CUDA events on one card:

- K5 (`ops/ivf.py::ivf_dedup_scores`) at B=8 and B=32 against a 4096 x 640
  x 768 bf16 listing, list sizes uniform in [0, 512) (a mean near the 1M
  layout's 244 rows), slots from random probes at nprobe 64 (512 and 2,048
  slots), queries random unit rows; beside it `torch.matmul` of the
  gathered slot buckets;
- K7 writing both caches of a layer at Qwen2.5-0.5B's B=8 cache (2 x 64
  bf16 heads, 384 positions): `kv_row_insert_pair` where the checkout has
  it, else two `kv_row_insert` launches; beside it the two `index_copy_`
  calls that write the same rows, in device ms and host us per call, each
  the median of 7 rounds that take the calls in turn.

To compare two checkouts in one call on the same card, copy this file into
the other checkout's `rag_inference_pipeline_tpu_torch/tools/` and run
both in turns (parent, change, change, parent). Prints one JSON line and
writes it to `--out` (default `build/bench/k5k7.json`); needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NLIST, CAP, DIM, NPROBE = 4096, 640, 768, 64


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def alternated(timer, fns: dict, iters: int, rounds: int = 7) -> dict:
    """The median of `rounds` timings of each function, taken in turn in
    every round (host-bound calls move with the host's load)."""
    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(timer(fn, iters))
    return {name: statistics.median(v) for name, v in runs.items()}


def bench_k5(g) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import ivf

    sizes = torch.randint(0, 512, (NLIST,), generator=g, device="cuda", dtype=torch.int32)
    buckets = torch.randn(NLIST, CAP, DIM, generator=g, device="cuda").to(torch.bfloat16)
    out = {}
    for b in (8, 32):
        q = torch.randn(b, DIM, generator=g, device="cuda")
        q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        probe = torch.randint(0, NLIST, (b, NPROBE), generator=g, device="cuda").int()
        slots, _ = ivf.dedup_probes(probe, NLIST, min(NLIST, b * NPROBE))
        args = (q, buckets, slots, sizes)
        err = (ivf.ivf_dedup_scores(*args) - ivf.ivf_dedup_scores_plain(*args)).abs().max()
        gathered = buckets[slots.long()]
        out[f"b{b}"] = {
            "slots": int(slots.numel()),
            "filled_rows": int(sizes[slots.long()].sum()),
            "max_abs_err": float(err),
            "ms": cuda_ms(lambda: ivf.ivf_dedup_scores(*args), 50),
            "matmul_ms": cuda_ms(lambda: torch.matmul(gathered, q.T), 50),
        }
        del gathered
    return out


def bench_k7(g) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import kv

    b, s, h, d = 8, 384, 2, 64
    ck, cv = (torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    nk, nv = (torch.randn(b, h, d, generator=g, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    pos = torch.arange(128, 128 + b, device="cuda", dtype=torch.int32)
    if hasattr(kv, "kv_row_insert_pair"):
        how = "pair"

        def insert():
            kv.kv_row_insert_pair(ck, cv, nk, nv, pos)
    else:
        how = "two singles"

        def insert():
            kv.kv_row_insert(ck, nk, pos)
            kv.kv_row_insert(cv, nv, pos)

    flat_k, flat_v = ck.view(b * s, h, d), cv.view(b * s, h, d)
    rows = torch.arange(b, device="cuda") * s + pos.long()

    def two_index_copies():
        flat_k.index_copy_(0, rows, nk)
        flat_v.index_copy_(0, rows, nv)

    fns = {"insert": insert, "two_index_copy": two_index_copies}
    if how == "pair":
        # the pair's host time by part: its checks; the launch helper with
        # the checked arguments; the bare ctypes call (and the CUDA launch
        # inside it) with the stream looked up beforehand
        from rag_inference_pipeline_tpu_torch.ops import _kernels

        args = kv._check("pair", ck, cv, nk, nv, pos)
        fn = _kernels.load_library().ragtorch_kv_row_insert
        stream = torch._C._cuda_getCurrentRawStream(args[0])
        fns["checks"] = lambda: kv._check("pair", ck, cv, nk, nv, pos)
        fns["launch_helper"] = lambda: _kernels.launch("ragtorch_kv_row_insert", *args)
        fns["bare_ctypes"] = lambda: fn(*args[1:], stream)
    dev = alternated(cuda_ms, {k: fns[k] for k in ("insert", "two_index_copy")}, 500)
    host = alternated(host_us, fns, 1000)
    return {"insert": how, "ms": dev["insert"], "two_index_copy_ms": dev["two_index_copy"],
            **{f"{k}_host_us": v for k, v in host.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "k5k7.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_k5k7 needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import _kernels

    _kernels.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        out = {"root": ROOT, "card": smi, "k5": bench_k5(g), "k7": bench_k7(g)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
