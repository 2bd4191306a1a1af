"""The host re-score (`utils/cpuscan.py`) timed against its plain numpy
version on seeded synthetic stores.

    python3 rag_inference_pipeline_tpu_torch/tools/bench_rescore_host.py \\
        [--n 1000000] [--d 768] [--batch 8] [--shortlists 64 4096] [--out PATH]

Builds an f16 store and an int8 store of `--n` x `--d` rows in host RAM
(seeded: f16 multiples of 2^-11 in [-1, 1), int8 the low bytes of the
same integers),
advises 2 MB pages for both (`madvise_hugepage`), then for each store and
each shortlist length S re-scores a [batch, S] shortlist of random ids to
the top 10: the native `rescore_f16` / `rescore_i8` and their numpy
versions `rescore_*_plain` in turns, on the same ids, for `--rounds`
rounds. Prints one JSON line (the median ms of each, the host's threads
and the vector extensions the native build used, the card's name and
power limit where `nvidia-smi` answers) and writes it to `--out` (default
`build/bench/rescore_host.json`). Host only: no card is needed.
`--smoke` runs a small store for two rounds.
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


def card() -> str | None:
    """`nvidia-smi`'s name and power limit of the first card, if any."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def host_cpu() -> str | None:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def alternated(fns: dict, rounds: int) -> dict:
    """Median ms of each function, the functions called in turn a round."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shortlists", type=int, nargs="+", default=[64, 4096])
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "rescore_host.json"))
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.d, args.shortlists, args.rounds = 20_000, 64, [64, 512], 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from rag_inference_pipeline_tpu_torch.utils import cpuscan, native

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    ints = rng.integers(-2048, 2048, (args.n, args.d), dtype=np.int16)
    store_f16 = ints.astype(np.float16)
    store_f16 *= np.float16(1 / 2048)  # [-1, 1) in steps of 2^-11: exact in f16
    store_i8 = ints.astype(np.int8)
    del ints
    build_s = time.perf_counter() - t0
    hugepages = [cpuscan.madvise_hugepage(store_f16), cpuscan.madvise_hugepage(store_i8)]
    q = rng.standard_normal((args.batch, args.d)).astype(np.float32)
    scale = 1.0 / 127
    rows = []
    for s in args.shortlists:
        ids = rng.integers(0, args.n, (args.batch, s), dtype=np.int32)
        ids[:, ::97] = -1  # a few masked slots, as a shortlist of empty bins has
        for kind, native_fn, plain_fn in (
            ("f16", lambda: cpuscan.rescore_f16(q, store_f16, ids, args.k),
             lambda: cpuscan.rescore_f16_plain(q, store_f16, ids, args.k)),
            ("i8", lambda: cpuscan.rescore_i8(q, store_i8, scale, ids, args.k),
             lambda: cpuscan.rescore_i8_plain(q, store_i8, scale, ids, k=args.k)),
        ):
            (ns, ni), (ps, pi) = native_fn(), plain_fn()
            valid = ni >= 0
            same = bool(np.allclose(ns[valid], ps[valid], rtol=1e-5, atol=1e-5)
                        and (np.sort(ni, 1) == np.sort(pi, 1)).all())
            ms = alternated({"native": native_fn, "plain": plain_fn}, args.rounds)
            rows.append({"kind": kind, "shortlist": s, "batch": args.batch,
                         "native_ms": ms["native"], "plain_ms": ms["plain"],
                         "plain_over_native": ms["plain"] / ms["native"],
                         "ns_per_row_native": ms["native"] * 1e6 / (args.batch * s),
                         "agree": same})
    out = {
        "root": ROOT, "card": card(), "host_cpu": host_cpu(), "n": args.n, "d": args.d,
        "threads": cpuscan.hw_threads(), "isa": native.isa(), "hugepages": hugepages,
        "store_build_s": build_s, "rounds": args.rounds, "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
