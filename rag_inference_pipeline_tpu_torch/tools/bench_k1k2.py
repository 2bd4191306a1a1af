"""K1, K2 and K3, the flat bin-max scans, timed alone on seeded synthetic
inputs, to compare checkouts.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_k1k2.py [--out PATH]

Imports `rag_inference_pipeline_tpu_torch` from the checkout this file sits
in, builds its kernels and times, with CUDA events on one card, at the
shapes `chip_smoke.py` phases k1, k2 and k3 use (1,000,777 rows of 768):

- K1 (`ops/topk.py::binmax_partial_topk_int8gs`) over int8 rows, ntotal
  1,000,333, nbins 1024, at B=8 (the fused `/query`), B=20 and B=33 (one
  query tile of 3 and of 5 n-tiles of 8 queries) and B=128 (the kernel
  lab's batch);
- K2 (`binmax_partial_topk`) over bf16 unit rows, ntotal 1,000,333, nbins
  512, at B=8 (the flat `/retrieve`);
- K3 (`binmax_partial_topk_int8`) over int8 rows with f32 scales, nbins
  512, at B=8.

Each line gives the kernel's ms, the bytes the function must move over
that time (TB/s), its bound (`chip_smoke.py::bound`'s rule) over that time,
and the number of passes over the rows (query tiles: at most the
library's `_kernels.binmax_tile()` queries a tile, 64, where the checkout
has it; 8 before).
At B=8 each kernel is also held against its plain version.

To compare two checkouts in one call on the same card, copy this file into
the other checkout's `rag_inference_pipeline_tpu_torch/tools/` (it needs
`tools/bench_k5k7.py` there, for the timing helpers) and run both in turns
(parent, change, change, parent). Prints one JSON line and writes it to
`--out` (default `build/bench/k1k2.json`); needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
N, NTOTAL, DIM = 1_000_777, 1_000_333, 768
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def _passes(b: int) -> int:
    from rag_inference_pipeline_tpu_torch.ops import _kernels

    tile = getattr(_kernels, "binmax_tile", None)
    return -(-b // (tile()[1] if tile is not None else 8))


def _line(ms: float, nbytes: float, ops: float, kind: str, passes: int, **extra) -> dict:
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]) * 1e3
    return {"ms": ms, "tb_per_s": nbytes / ms / 1e9, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms, "row_passes": passes, **extra}


def bench(g, cuda_ms) -> dict:
    import torch
    from rag_inference_pipeline_tpu_torch.ops import topk

    out = {}
    db = torch.randint(-127, 128, (N, DIM), generator=g, device="cuda", dtype=torch.int8)
    for b in (8, 20, 33, 128):
        q = torch.randint(-127, 128, (b, DIM), generator=g, device="cuda", dtype=torch.int8)
        args = dict(nbins=1024, ntotal=NTOTAL)
        extra = {}
        if b == 8:
            kv, ki = topk.binmax_partial_topk_int8gs(q, db, **args)
            pv, pi = topk.binmax_partial_topk_int8gs_plain(q, db, **args)
            extra["identical"] = bool(torch.equal(kv, pv) and torch.equal(ki, pi))
        ms = cuda_ms(lambda: topk.binmax_partial_topk_int8gs(q, db, **args), 20)
        out[f"k1_b{b}"] = _line(ms, NTOTAL * DIM + b * DIM + b * 1024 * 8,
                                2 * b * NTOTAL * DIM, "int8", _passes(b), **extra)
    scales = torch.exp(torch.rand(N, generator=g, device="cuda") * 10 - 8)
    q = torch.randint(-127, 128, (8, DIM), generator=g, device="cuda", dtype=torch.int8)
    kv, ki = topk.binmax_partial_topk_int8(q, db, scales, nbins=512)
    pv, pi = topk.binmax_partial_topk_int8_plain(q, db, scales, nbins=512)
    ms = cuda_ms(lambda: topk.binmax_partial_topk_int8(q, db, scales, nbins=512), 20)
    out["k3_b8"] = _line(ms, N * DIM + 4 * N + 8 * DIM + 8 * 512 * 8, 2 * 8 * N * DIM,
                         "int8", _passes(8),
                         identical=bool(torch.equal(kv, pv) and torch.equal(ki, pi)))
    del db, scales
    db = torch.randn(N, DIM, generator=g, device="cuda")
    db = (db / db.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn(8, DIM, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    args = dict(nbins=512, ntotal=NTOTAL)
    kv, ki = topk.binmax_partial_topk(q, db, **args)
    pv, pi = topk.binmax_partial_topk_plain(q, db, **args)
    ms = cuda_ms(lambda: topk.binmax_partial_topk(q, db, **args), 20)
    out["k2_b8"] = _line(ms, NTOTAL * DIM * 2 + 8 * DIM * 4 + 8 * 512 * 8,
                         2 * 8 * NTOTAL * DIM, "bf16", _passes(8),
                         max_abs_err=float((kv - pv).abs().max()),
                         picks_differ=float((ki != pi).float().mean()))
    del db
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "k1k2.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_k1k2 needs a CUDA card")
    from rag_inference_pipeline_tpu_torch.ops import _kernels
    from rag_inference_pipeline_tpu_torch.tools.bench_k5k7 import cuda_ms

    _kernels.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        out = {"root": ROOT, "card": smi, **bench(g, cuda_ms)}
    torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
