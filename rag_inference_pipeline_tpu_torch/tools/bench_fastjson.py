"""The native `/retrieve` JSON codec (`utils/fastjson.py`) timed against the
server's stdlib path on seeded bodies.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_fastjson.py \\
        [--batches 64 512] [--dim 768] [--out PATH]

For each batch B: a `/retrieve` body of B items of `--dim` random floats
(the strict shape, `json.dumps` of float64 lists, as a client sends it),
parsed by `parse_retrieve` and by the stdlib path (`json.loads`, then
`serve/runtime.py::_parse_retrieve`); and B id_only results of 10 ids and
f32 scores, encoded by `encode_results` and by `json.dumps` of the same
wire dicts. Each pair in turns for `--rounds` rounds; prints one JSON line
of median ms (with the body's MB and the card's name and power limit
where `nvidia-smi` answers) and writes it to `--out` (default
`build/bench/fastjson.json`). Host only. `--smoke` runs small bodies for
two rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 512])
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "fastjson.json"))
    args = ap.parse_args(argv)
    if args.smoke:
        args.batches, args.dim, args.rounds = [4, 16], 32, 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from rag_inference_pipeline_tpu_torch.serve.runtime import _parse_retrieve, _result_wire
    from rag_inference_pipeline_tpu_torch.tools.bench_rescore_host import alternated, card, host_cpu
    from rag_inference_pipeline_tpu_torch.utils import fastjson

    rng = np.random.default_rng(0)
    rows = {}
    for b in args.batches:
        emb = rng.standard_normal((b, args.dim))
        body = json.dumps({"items": [{"query": "", "embedding": e.tolist()} for e in emb],
                           "k": 10}).encode()
        fast = fastjson.parse_retrieve(body, args.dim)
        items, _ = _parse_retrieve(json.loads(body), args.dim)
        parse_same = fast is not None and all(
            np.array_equal(fast.embeddings[i], np.asarray(it["embedding"], np.float32))
            for i, it in enumerate(items))
        results = [{"ids": [int(x) for x in rng.integers(0, 10**6, 10)],
                    "scores": [float(np.float32(x)) for x in rng.standard_normal(10)]}
                   for _ in range(b)]
        wire = [_result_wire(r) for r in results]
        enc = json.loads(fastjson.encode_results(wire))
        encode_same = all(
            e["ids"] == r["ids"]
            and np.array_equal(np.float32(e["scores"]), np.float32(r["scores"]))
            for e, r in zip(enc["results"], results))
        parse = alternated({
            "native": lambda: fastjson.parse_retrieve(body, args.dim),
            "stdlib": lambda: _parse_retrieve(json.loads(body), args.dim),
        }, args.rounds)
        encode = alternated({
            "native": lambda: fastjson.encode_results([_result_wire(r) for r in results]),
            "stdlib": lambda: json.dumps(
                {"results": [_result_wire(r) for r in results]}).encode(),
        }, args.rounds)
        rows[f"b{b}"] = {
            "body_mb": len(body) / 1e6,
            "parse_native_ms": parse["native"], "parse_stdlib_ms": parse["stdlib"],
            "parse_stdlib_over_native": parse["stdlib"] / parse["native"],
            "encode_native_ms": encode["native"], "encode_stdlib_ms": encode["stdlib"],
            "encode_stdlib_over_native": encode["stdlib"] / encode["native"],
            "parse_same": parse_same, "encode_same": encode_same,
        }
    out = {"root": ROOT, "card": card(), "host_cpu": host_cpu(), "dim": args.dim,
           "rounds": args.rounds, "rows": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
