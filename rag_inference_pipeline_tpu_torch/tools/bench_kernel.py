"""Kernel lab for the int8 flat scan and the device-memory stream ceiling.

Port of `scripts/bench_kernel.py`, over the port's `fused_topk_int8gs`
(kernel K1, the production scan) and `stream_sum` (kernel K8):

  scan    one config: in-program, pipelined and fetch timing, recall@k
          against the exact scan of the bf16 rows
  ladder  the same over batch x nbins
  stream  K8 per chunk: every byte of the first N // chunk * chunk rows
          read once; GB/s from the in-program time
  tail    raw scan vs + top-k vs + re-score

    python -m rag_inference_pipeline_tpu_torch.tools.bench_kernel --mode stream
    python -m rag_inference_pipeline_tpu_torch.tools.bench_kernel --smoke --mode scan

Without `--smoke` it runs on the card and raises without one; `--smoke`
runs tiny shapes on the CPU (plain versions, host clock: no device
number). K1 has no `chunk` (its result and launch do not depend on the
reference's grid step), so `--chunks` sets the stream chunks alone; the
reference's `--mm` (the bf16 upcast) is not carried. Results go to
`build/bench/bench_kernel_<mode>.json`, or `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..bench import measure_rtt, time_fetch, time_inprogram, time_pipelined
from ..core.device import resolve_device
from ..ops.stream import stream_sum
from ..ops.topk import (
    binmax_partial_topk_int8gs,
    exact_topk,
    fused_topk_int8gs,
    quantize_global_int8,
)

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "bench",
)
_BLOCK = 1 << 20  # rows quantized per step
SMOKE = {"n": 3000, "d": 128, "batch": 8, "nbins": 128, "rescore": 32,
         "batches": "8,16", "nbins_list": "64,128", "chunks": "256,512"}


def build_corpus(args, dev: torch.device, g: torch.Generator):
    """Random bf16 rows padded to a multiple of the largest stream chunk,
    their global-scale int8 copy and its scale (from the first 2^20 rows);
    searches see only the first `args.n` rows."""
    chunk_max = max(args.chunk_list)
    n_pad = -(-args.n // chunk_max) * chunk_max
    db = torch.randn(n_pad, args.d, generator=g, device=dev).to(torch.bfloat16)
    _, db_scale = quantize_global_int8(db[: min(_BLOCK, n_pad)].float())
    db_i8 = torch.cat([
        torch.clamp(torch.round(db[i : i + _BLOCK].float() / db_scale), -127, 127)
        .to(torch.int8)
        for i in range(0, n_pad, _BLOCK)
    ])
    return db, db_i8, db_scale


def make_queries(args, db, g, b: int, n_variants: int = 4, stack: int = 8):
    """`n_variants` stacks of `stack` bf16 query batches: corpus rows plus
    N(0, 0.05^2) noise, a fresh draw for every batch."""
    rows = torch.randint(0, args.n, (b,), generator=g, device=db.device)
    base = db[rows].float()
    return [
        torch.stack([
            (base + 0.05 * torch.randn(b, args.d, generator=g, device=db.device))
            .to(torch.bfloat16)
            for _ in range(stack)
        ])
        for _ in range(n_variants)
    ]


def recall_of(args, search, db, q) -> float:
    _, ei = exact_topk(q, db, args.k, ntotal=args.n)
    _, fi = search(q)
    ei, fi = ei.cpu().tolist(), fi.cpu().tolist()
    return sum(len(set(a) & set(e)) / args.k for a, e in zip(fi, ei)) / len(ei)


def run_config(args, corpus, g, b: int, nbins: int, rescore_k: int) -> dict:
    """One (B, nbins) config of the production search."""
    db, db_i8, db_scale = corpus

    def search(q):
        return fused_topk_int8gs(
            q.float(), db_i8, db_scale, args.k, nbins=nbins,
            rescore_db=db if rescore_k else None, rescore_k=rescore_k,
            ntotal=args.n,
        )

    variants = make_queries(args, db, g, b)
    rec = recall_of(args, search, db, variants[0][0])
    ms_ip = time_inprogram(search, variants, reps=3)
    flat_inputs = list(variants[0]) + list(variants[1])
    rtt = measure_rtt(variants[0][0])
    ms_pipe = time_pipelined(search, flat_inputs)
    ms_fetch = time_fetch(search, flat_inputs[:4], rtt)
    qps = b / (ms_ip / 1e3)
    print(f"B={b:5d} nbins={nbins:5d}  inprog {ms_ip:8.4f} ms  pipe "
          f"{ms_pipe:8.4f}  fetch {ms_fetch:8.4f}  recall {rec:.4f}  "
          f"QPS(inprog) {qps:10.1f}", flush=True)
    return {
        "batch": b, "nbins": nbins, "rescore_k": rescore_k,
        "ms_inprogram": ms_ip, "ms_pipelined": ms_pipe,
        "ms_fetch_xcheck": ms_fetch, "recall": rec, "qps_inprogram": qps,
    }


def run_stream(args, db_i8) -> list[dict]:
    """K8 for each chunk, over all of `db_i8`'s rows: its checksum must be
    the sum of every byte of the rows streamed."""
    n, d = db_i8.shape
    out = []
    for chunk in args.chunk_list:
        rows = n // chunk * chunk
        qs = [torch.full((8, 128), i, dtype=torch.int32, device=db_i8.device)
              for i in range(8)]

        def fn(q, chunk=chunk):
            return stream_sum(q, db_i8, chunk)

        _, checksum = fn(qs[0])
        want = db_i8[:rows].sum(dtype=torch.int64)
        if not torch.equal(checksum, want):
            raise RuntimeError(f"stream chunk={chunk}: checksum {int(checksum)} "
                               f"is not the byte sum {int(want)}")
        ms_ip = time_inprogram(fn, [torch.stack(qs)], reps=3)
        ms_pipe = time_pipelined(fn, qs)
        ms_fetch = time_fetch(fn, qs[:4], measure_rtt(qs[0]))
        gbs = rows * d / (ms_ip / 1e3) / 1e9
        print(f"stream chunk={chunk:6d}: inprog {ms_ip:8.4f} ms  pipe "
              f"{ms_pipe:8.4f}  fetch {ms_fetch:8.4f} -> {gbs:8.1f} GB/s",
              flush=True)
        out.append({"chunk": chunk, "rows": rows, "bytes": rows * d,
                    "ms_inprogram": ms_ip, "ms_pipelined": ms_pipe,
                    "ms_fetch_xcheck": ms_fetch, "gb_per_s": gbs})
    return out


def run_tail(args, corpus, g) -> list[dict]:
    """The raw K1 scan, + its top-k, + the exact re-score, in-program."""
    db, db_i8, db_scale = corpus
    b, nbins = args.batch, args.nbins
    variants = make_queries(args, db, g, b)

    def q_i8(q):
        qf = q.float()
        qs = torch.clamp(qf.abs().amax(), min=1e-9) / 127.0
        return torch.clamp(torch.round(qf / qs), -127, 127).to(torch.int8)

    def raw(q):
        return binmax_partial_topk_int8gs(q_i8(q), db_i8, nbins=nbins, ntotal=args.n)

    def with_topk(q):
        return fused_topk_int8gs(q.float(), db_i8, db_scale, args.k,
                                 nbins=nbins, ntotal=args.n)

    def with_rescore(q):
        return fused_topk_int8gs(q.float(), db_i8, db_scale, args.k,
                                 nbins=nbins, ntotal=args.n, rescore_db=db,
                                 rescore_k=args.rescore)

    out = []
    for name, fn in (("raw scan", raw), ("+top_k", with_topk),
                     ("+top_k+rescore", with_rescore)):
        ms = time_inprogram(fn, variants, reps=3)
        print(f"{name:18s} {ms:8.4f} ms/call (in-program)", flush=True)
        out.append({"stage": name, "batch": b, "nbins": nbins, "ms_inprogram": ms})
    return out


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=["scan", "ladder", "stream", "tail"],
                    default="scan")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU (plain versions, host clock)")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nbins", type=int, default=1024)
    ap.add_argument("--rescore", type=int, default=64)
    ap.add_argument("--batches", default="128,256,512,1024")
    ap.add_argument("--nbins-list", default="512,1024")
    ap.add_argument("--chunks", default="4096,8192")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.smoke:
        for key, val in SMOKE.items():
            setattr(args, key, val)
    args.chunk_list = sorted({int(x) for x in args.chunks.split(",")})
    return args


def main(argv: Optional[list[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.smoke else None)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={kind} n={args.n} d={args.d} mode={args.mode}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        corpus = build_corpus(args, dev, g)
        if args.mode == "scan":
            results = [run_config(args, corpus, g, args.batch, args.nbins,
                                  args.rescore)]
        elif args.mode == "ladder":
            results = [
                run_config(args, corpus, g, int(b), int(nb), args.rescore)
                for b in args.batches.split(",")
                for nb in args.nbins_list.split(",")
            ]
        elif args.mode == "stream":
            results = run_stream(args, corpus[1])
        else:
            results = run_tail(args, corpus, g)
    payload = {"mode": args.mode, "n": args.n, "d": args.d, "device": kind,
               "results": results}
    path = args.out or os.path.join(OUT_DIR, f"bench_kernel_{args.mode}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
    print(f"wrote {path}", flush=True)
    return payload


if __name__ == "__main__":
    main()
