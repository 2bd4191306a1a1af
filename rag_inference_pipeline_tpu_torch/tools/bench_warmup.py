"""Bucket warm-up off and on, side by side on one card: the start-up and
the first requests of the three-node staged deployment.

    python3 -m rag_inference_pipeline_tpu_torch.tools.bench_warmup [--rounds 2] [--out PATH]

Builds a seeded 1M x 768 IVF-Flat index on the card (random unit rows,
nlist 4096, nprobe 64, cap factor 2.5, bf16 buckets) and a sqlite
documents.db of 48-word documents, then starts the three node processes
(`tools/start_pipeline.py`: gateway, retrieval, generation; full model
widths, random weights, MAX_TOKENS=128, COMPRESSION_ALGORITHM=none) with
WARMUP_BUCKETS=0 and with it unset (the serving default, on) in turns
(off, on, on, off for two rounds). Each start reports each node's seconds
until its `/health` answers 200, node 2's decode graphs (count, pool MB)
before the first `/query` and after the last, the first and the second
`/query` through the gateway (texts no start has sent), and the wall of 8
concurrent ones. Writes the lines to `--out` (default
`build/bench/warmup.json`). Needs a card; `--smoke` runs the same on the
CPU at tiny shapes with the fixture checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from ..core.config import load_settings
from ..index.ivf_flat import IVFFlatIndex
from ..utils.docstore import build_sqlite_store
from . import start_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FULL = dict(rows=1_000_000, dim=768, nlist=4096, nprobe=64, env={"MAX_TOKENS": "128"})
SMOKE = dict(rows=2000, dim=64, nlist=16, nprobe=4, env={
    "MODEL_WEIGHTS_DIR": os.path.join(ROOT, "tests", "fixtures", "weights"),
    "EMBEDDING_MODEL": "tiny-bert", "RERANKER_MODEL": "tiny-rerank",
    "LLM_MODEL": "tiny-qwen", "SENTIMENT_MODEL": "tiny-sent", "TOXICITY_MODEL": "tiny-tox",
    "ALLOW_RANDOM_WEIGHTS": "0", "INDEX_DIM": "64", "INDEX_PQ_M": "16",
    "PREFILL_BUCKETS": "64,128", "MAX_TOKENS": "4", "DEVICE_PLATFORM": "cpu",
    "OMP_NUM_THREADS": "2"})


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=600) as r:
        return json.loads(r.read())


def _query(port: int, text: str) -> float:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query", data=json.dumps({"query": text}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200:
            raise RuntimeError(f"/query: HTTP {r.status}")
        r.read()
    return time.perf_counter() - t0


def _free_base() -> int:
    """A base port with three consecutive ports free just now."""
    import random
    import socket

    for _ in range(100):
        base = random.randrange(20000, 60000)
        socks = [socket.socket() for _ in range(3)]
        try:
            for p, s in enumerate(socks):
                s.bind(("0.0.0.0", base + p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no three consecutive free ports")


def start_once(env: dict, tag: str, log_dir: str) -> dict:
    """One start of the three nodes: load seconds each, graphs, first,
    second and 8 concurrent /query."""
    base = _free_base()
    env = {**env, "BASE_PORT": str(base)}
    settings = load_settings(env)
    t0 = time.perf_counter()
    nodes = start_pipeline.start_nodes(3, env, log_dir)
    try:
        ready = [None] * 3
        while None in ready:
            for n, node in enumerate(nodes):
                if node.proc.poll() is not None:
                    raise RuntimeError(f"node {n} exited:\n{node.log_tail()}")
                if ready[n] is None:
                    try:
                        _get(f"{settings.node_url(n)}/health")
                        ready[n] = time.perf_counter() - t0
                    except OSError:
                        pass
            if time.perf_counter() - t0 > 900:
                raise TimeoutError("the nodes were not healthy within 900 s")
            time.sleep(0.2)
        graphs0 = _get(f"{settings.node_url(2)}/health")["decode_graphs"]
        texts = [f"{tag}: what does the corpus say about topic {i}?" for i in range(10)]
        first, second = _query(base, texts[0]), _query(base, texts[1])
        walls = [0.0] * 8
        threads = [threading.Thread(target=lambda i=i: walls.__setitem__(
            i, _query(base, texts[2 + i]))) for i in range(8)]
        tc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        conc = time.perf_counter() - tc
        graphs1 = _get(f"{settings.node_url(2)}/health")["decode_graphs"]
    finally:
        codes = start_pipeline.stop_nodes(nodes, 60)
    if any(c != 0 for c in codes):
        raise RuntimeError(f"node exit codes {codes}")
    return {"node_load_s": [round(x, 3) for x in ready], "first_s": round(first, 4),
            "second_s": round(second, 4), "concurrent8_wall_s": round(conc, 4),
            "graphs_before": graphs0, "graphs_after": graphs1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--smoke", action="store_true", help="tiny shapes on the CPU")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "bench", "warmup.json"))
    args = ap.parse_args(argv)
    cfg = SMOKE if args.smoke else FULL
    if args.smoke:
        card, dev = "cpu", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_warmup needs a CUDA card (or --smoke)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        dev = torch.device("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_warmup_", dir=os.path.join(ROOT, "build"))
    g = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn(cfg["rows"], cfg["dim"], generator=g, device=dev)
    rows /= rows.norm(dim=1, keepdim=True)
    ivf = IVFFlatIndex(cfg["dim"], cfg["nlist"], nprobe=cfg["nprobe"], device=dev)
    ivf.train_add(rows)
    del rows
    ivf.save(os.path.join(work, "ivf.npz"))
    del ivf
    rng = np.random.default_rng(6)
    pool = [" ".join(f"w{w}" for w in rng.integers(0, 5000, 48)) for _ in range(4096)]
    build_sqlite_store(os.path.join(work, "documents.db"),
                       ((i, f"doc {i}", pool[i % 4096]) for i in range(cfg["rows"])))
    env = {"TOTAL_NODES": "3", "INDEX_KIND": "ivf_flat", "INDEX_NPROBE": str(cfg["nprobe"]),
           "INDEX_PATH": os.path.join(work, "ivf.npz"), "DOC_STORE_BACKEND": "sqlite",
           "DOCUMENT_DB_PATH": os.path.join(work, "documents.db"), "MODEL_WEIGHTS_DIR": "",
           "RETRIEVAL_BATCH_SIZE": "64", "COMPRESSION_ALGORITHM": "none",
           "NODE_0_IP": "127.0.0.1", "NODE_1_IP": "127.0.0.1", "NODE_2_IP": "127.0.0.1",
           **cfg["env"]}
    os.environ.pop("WARMUP_BUCKETS", None)  # unset: the serving default
    runs = []
    order = [m for r in range(args.rounds) for m in (("off", "on") if r % 2 == 0 else ("on", "off"))]
    try:
        for i, mode in enumerate(order):
            run_env = {**env, **({"WARMUP_BUCKETS": "0"} if mode == "off" else {})}
            res = {"mode": mode, **start_once(run_env, f"start {i}",
                                              os.path.join(work, f"nodes{i}"))}
            print(json.dumps(res), flush=True)
            runs.append(res)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": card, "rows": cfg["rows"], "runs": runs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": card, "out": args.out}), flush=True)
    return out


if __name__ == "__main__":
    main()
