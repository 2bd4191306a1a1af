"""K4, K6 and the PQ4 search's flat top-k timed alone on seeded synthetic
inputs, to compare checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_k4k6.py [--out PATH]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times, with CUDA events on one card, at the
shapes `chip_smoke.py` phases k45 and k6 use (nlist 4096, cap 640, list
sizes uniform in [0, 512), a mean near the 1M layouts' 244 rows):

- K4 (`ops/ivf.py::ivf_scan_partial`) at B=64, nprobe 64, over a
  4096 x 640 x 768 bf16 listing, random probes and unit queries;
- K6 (`ops/pq.py::ivfpq4_adc_scores`) at B=8 and B=64 over PQ4 codes at
  m=192 (m_store 256), slots from random probes at nprobe 64, random bf16
  tables;
- `ops/topk.py::_topk` of [64, 4096 * 640] f32 at k=256 (the B=64 PQ4
  search's flat top-k when every list is a slot), and the whole
  `ivfpq4_search_dedup` at B=64 with its peak memory above the listing.

To compare two checkouts in one call on the same card, copy this file into
the other checkout's `rag_inference_pipeline_tpu_torch/tools/` (it needs
`tools/bench_k5k7.py` there, for the timing helpers) and run both in turns
(parent, change, change, parent). Prints one JSON line and writes it to
`--out` (default `build/bench/k4k6.json`); needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NLIST, CAP, DIM, NPROBE, PQ_M, TOPK = 4096, 640, 768, 64, 192, 256


def _unit(g, *shape):
    import torch

    x = torch.randn(*shape, generator=g, device="cuda")
    return x / x.norm(dim=-1, keepdim=True)


def bench_k4(g, sizes, cuda_ms) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import ivf

    buckets = torch.randn(NLIST, CAP, DIM, generator=g, device="cuda").to(torch.bfloat16)
    q = _unit(g, 64, DIM).to(torch.bfloat16)
    probe = torch.randint(0, NLIST, (64, NPROBE), generator=g, device="cuda").int()
    args = (q, buckets, probe, sizes)
    kv, _ = ivf.ivf_scan_partial(*args)
    pv, _ = ivf.ivf_scan_partial_plain(*args)
    pair_rows = int(sizes[probe.long()].clamp(max=CAP).sum())
    out = {
        "max_abs_err": float((kv - pv).abs().max()),
        "pair_gb": pair_rows * DIM * 2 / 1e9,
        "ms": cuda_ms(lambda: ivf.ivf_scan_partial(*args), 20),
    }
    del buckets
    return out


def bench_k6(g, sizes, cuda_ms) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import ivf, pq, topk

    codes = torch.zeros(NLIST, CAP, 256, dtype=torch.uint8, device="cuda")
    codes[:, :, :PQ_M] = torch.randint(0, 16, (NLIST, CAP, PQ_M), generator=g,
                                       device="cuda", dtype=torch.uint8)
    out = {}
    for b in (8, 64):
        probe = torch.randint(0, NLIST, (b, NPROBE), generator=g, device="cuda").int()
        slots, _ = ivf.dedup_probes(probe, NLIST, min(NLIST, b * NPROBE))
        lut = torch.randn(b, PQ_M * 16, generator=g, device="cuda").to(torch.bfloat16)
        args = (lut, codes, slots, sizes)
        err = (pq.ivfpq4_adc_scores(*args) - pq.ivfpq4_adc_scores_plain(*args)).abs().max()
        out[f"b{b}"] = {
            "slots": int(slots.numel()),
            "filled_rows": int(sizes[slots.long()].clamp(max=CAP).sum()),
            "max_abs_err": float(err),
            "ms": cuda_ms(lambda: pq.ivfpq4_adc_scores(*args), 20),
        }
    flat = torch.randn(64, NLIST * CAP, generator=g, device="cuda")
    out["topk64_ms"] = cuda_ms(lambda: topk._topk(flat, TOPK), 10)
    del flat
    # the whole B=64 search over a listing of these codes
    pos = torch.arange(CAP, device="cuda")
    ids = torch.where(pos[None, :] < sizes[:, None],
                      torch.arange(NLIST * CAP, device="cuda").view(NLIST, CAP), -1).int()
    lst = pq.IVFPQListing(_unit(g, NLIST, DIM), 0.1 * torch.randn(
        PQ_M, 16, DIM // PQ_M, generator=g, device="cuda"), codes, ids, sizes)
    queries = _unit(g, 64, DIM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pq.ivfpq4_search_dedup(lst, queries, TOPK, nprobe=NPROBE)
    torch.cuda.synchronize()
    out["search64_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["search64_ms"] = cuda_ms(
        lambda: pq.ivfpq4_search_dedup(lst, queries, TOPK, nprobe=NPROBE), 5)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "k4k6.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_k4k6 needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import _kernels
    from rag_inference_pipeline_tpu_torch.tools.bench_k5k7 import cuda_ms

    _kernels.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        sizes = torch.randint(0, 512, (NLIST,), generator=g, device="cuda", dtype=torch.int32)
        out = {"root": ROOT, "card": smi, "k4": bench_k4(g, sizes, cuda_ms),
               "k6": bench_k6(g, sizes, cuda_ms)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
