#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (rag_inference_pipeline_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line with its result and time; any failure raises
and exits non-zero before the last line:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles every kernel under rag_inference_pipeline_tpu_torch/csrc
             with nvcc for sm_90a (ptxas report included).
3. k1      — the int8 bin-max scan kernel against its plain PyTorch version on
             the card, bit for bit, at the main-path shape (B=8, D=768,
             1M rows plus a ragged tail, ntotal < N, nbins=1024) and on a
             small ragged case; kernel and plain times from CUDA events.
4. corpus  — a seeded 1M x 768 corpus and 48-token documents, saved through
             the port's FlatIndex.save and np.save.
5. serve   — the port's serve.runtime over that corpus with the default
             models at full width and random weights (BGE-base, Qwen2.5-0.5B,
             two BERT-base classifiers), MAX_TOKENS=128; 10 POST /query, 8 of
             them concurrent. The K1 launch count, zeroed just before, must
             rise.
6. step    — one 8-lane fused step with the kernel and with the plain scan:
             identical doc ids; retrieval recall@10 against the exact scan
             of the bf16 rescore copy.

Then one JSON line of kernel results, and last the device line that the
chip check reads.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "rag_inference_pipeline_tpu_torch"

DEVICE = "cuda"
# bench.py's corpus size at BGE-base width; scripts/create_test_docs.py's
# default document length; Qwen2.5's vocabulary for the doc tokens
N_ROWS, DIM, DOC_LEN, DOC_VOCAB = 1_000_000, 768, 48, 151936
MAIN_B, MAIN_NBINS = 8, 1024
# the served configuration: default model names at full width, random
# weights, the int8 flat index, 128 new tokens
SERVE_ENV = {
    "USE_FUSED_PIPELINE": "1", "INDEX_DTYPE": "int8", "MAX_TOKENS": "128",
    "DEVICE_PLATFORM": DEVICE, "MODEL_WEIGHTS_DIR": "",
}


def phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] ok {time.perf_counter() - t0:.3f}s {fields}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # a reference states both: full-f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0, kind=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def phase_build():
    from rag_inference_pipeline_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.load_library()
    build_s = time.perf_counter() - t0
    phase("build", t0, lib=os.path.relpath(_kernels.LIB_PATH, ROOT))
    return build_s


def phase_k1():
    import torch
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8gs as kernel,
        binmax_partial_topk_int8gs_plain as plain,
    )

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (B, N, ntotal, D, nbins): main path first
        (MAIN_B, N_ROWS + 777, N_ROWS + 333, DIM, MAIN_NBINS),
        (37, 5000, 4321, 64, 128),
        (5, 3000, 90, DIM, 128),  # ntotal < nbins: empty bins
    ]
    out = {}
    for i, (b, n, nt, d, nbins) in enumerate(cases):
        q = torch.randint(-127, 128, (b, d), generator=g, device="cuda",
                          dtype=torch.int8)
        db = torch.randint(-127, 128, (n, d), generator=g, device="cuda",
                           dtype=torch.int8)
        kv, ki = kernel(q, db, nbins=nbins, ntotal=nt)
        pv, pi = plain(q, db, nbins=nbins, ntotal=nt)
        torch.cuda.synchronize()
        err = max(
            (kv.long() - pv.long()).abs().max().item(),
            (ki.long() - pi.long()).abs().max().item(),
        )
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"K1 case {i} differs from its plain version (max err {err})")
        check(bool((ki[:, nt:] == -1).all()) if nt < nbins else True,
              f"K1 case {i}: bins past ntotal are not empty")
        if i == 0:
            out = {
                "max_abs_err": err,
                "ms": cuda_ms(lambda: kernel(q, db, nbins=nbins, ntotal=nt), 20),
                "plain_ms": cuda_ms(lambda: plain(q, db, nbins=nbins, ntotal=nt), 3),
            }
        del q, db
    torch.cuda.empty_cache()
    phase("k1", t0, cases=len(cases), bit_identical=True,
          main_ms=f"{out['ms']:.4f}", main_plain_ms=f"{out['plain_ms']:.4f}")
    return out


def phase_corpus(workdir: str) -> dict:
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(2)
    vecs = torch.randn(N_ROWS, DIM, generator=g, device=DEVICE)
    vecs /= vecs.norm(dim=1, keepdim=True)  # unit rows, like BGE embeddings
    idx = FlatIndex(DIM, device=torch.device(DEVICE))
    idx.add(vecs)
    del vecs
    index_path = os.path.join(workdir, "index.npz")
    idx.save(index_path)
    del idx
    torch.cuda.empty_cache()
    rng = np.random.default_rng(3)
    toks = rng.integers(1000, DOC_VOCAB, (N_ROWS, DOC_LEN), dtype=np.int32)
    lengths = rng.integers(8, DOC_LEN + 1, N_ROWS)
    mask = (np.arange(DOC_LEN)[None, :] < lengths[:, None]).astype(np.int32)
    toks *= mask
    tok_path = os.path.join(workdir, "doc_tokens.npy")
    np.save(tok_path, toks)
    np.save(tok_path.replace(".npy", "_mask.npy"), mask)
    phase("corpus", t0, rows=N_ROWS, dim=DIM, doc_len=DOC_LEN)
    return {"INDEX_PATH": index_path, "DOC_TOKENS_PATH": tok_path}


def _post(port: int, query: str, rid: str):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query",
        data=json.dumps({"query": query, "request_id": rid}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        return r.status, body, time.perf_counter() - t0


def phase_serve(paths: dict):
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.ops.topk import binmax_partial_topk_int8gs
    from rag_inference_pipeline_tpu_torch.serve import runtime

    t0 = time.perf_counter()
    settings = load_settings({**SERVE_ENV, **paths})
    server = runtime.make_server(settings, port=0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    load_s = time.perf_counter() - t0
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=60
        ) as r:
            health = json.loads(r.read())
        check(all(health["components"].values()), f"not loaded: {health}")
        queries = [f"what does the corpus say about topic {i}?" for i in range(10)]
        binmax_partial_topk_int8gs.launches = 0
        results = [_post(port, queries[0], "q0"), _post(port, queries[1], "q1")]
        conc = [None] * 8

        def ask(i):
            conc[i] = _post(port, queries[2 + i], f"q{2 + i}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        tc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a concurrent /query did not finish")
        conc_wall = time.perf_counter() - tc
        launches = binmax_partial_topk_int8gs.launches
        results += conc
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=60
        ) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=60)
    keys = {"request_id", "generated_response", "sentiment", "is_toxic"}
    for i, (status, body, _) in enumerate(results):
        check(status == 200, f"/query {i}: HTTP {status}")
        check(set(body) == keys, f"/query {i}: keys {sorted(body)}")
        check(body["request_id"] == f"q{i}", f"/query {i}: wrong request_id")
        check(isinstance(body["is_toxic"], bool), f"/query {i}: is_toxic")
    check(launches >= len(results), f"K1 launched {launches} times for "
          f"{len(results)} requests")
    check(health["kernel_launches"]["binmax_int8gs"] == launches,
          "/health disagrees with the launch count")
    lat = sorted(r[2] for r in results)
    stats = {
        "requests": len(results),
        "load_s": round(load_s, 3),
        "first_s": round(results[0][2], 4),
        "second_s": round(results[1][2], 4),
        "p50_s": round(statistics.median(lat), 4),
        "max_s": round(lat[-1], 4),
        "concurrent8_wall_s": round(conc_wall, 4),
        "k1_launches": launches,
    }
    phase("serve", t0, **stats)
    return server.executor, launches, stats


def phase_step(executor):
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.engine.fused_executor import pad_rows
    from rag_inference_pipeline_tpu_torch.models.bert import bert_embed
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8gs_plain,
        exact_topk,
    )

    t0 = time.perf_counter()
    pipe = executor._get_pipe()
    queries = [f"smoke query number {i} on retrieval" for i in range(MAIN_B)]
    qlen = executor._query_len()
    ids, mask = executor.embedder.tokenizer.encode_batch(queries, qlen)
    lm_ids, lm_mask = executor.llm.tokenizer.encode_batch(queries, qlen)
    ids, mask, lm_ids, lm_mask = (pad_rows(a, MAIN_B) for a in (ids, mask, lm_ids, lm_mask))
    t_k = time.perf_counter()
    out_k = pipe.step(ids, mask, lm_ids, lm_mask)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t_k
    t_p = time.perf_counter()
    out_p = pipe.step(ids, mask, lm_ids, lm_mask,
                      scan=binmax_partial_topk_int8gs_plain)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t_p
    check(out_k.doc_ids.shape == (MAIN_B, pipe.k), "doc_ids shape")
    check(out_k.tokens.shape == (MAIN_B, pipe.max_new_tokens), "tokens shape")
    check(bool(torch.isfinite(out_k.scores).all()), "non-finite scores")
    check(torch.equal(out_k.doc_ids, out_p.doc_ids),
          "fused step: kernel and plain scan retrieve different docs")
    same_tokens = torch.equal(out_k.tokens, out_p.tokens)
    # retrieval quality against the exact scan of the bf16 rescore copy
    with torch.inference_mode():
        q = torch.from_numpy(ids).to(DEVICE)
        m = torch.from_numpy(mask).to(DEVICE)
        emb = bert_embed(pipe.bert_params, pipe.bert_cfg, q, m)
        _, exact = exact_topk(emb, pipe.db, pipe.k, ntotal=pipe.ntotal)
    got = out_k.doc_ids.cpu().numpy()
    ref = exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(got, ref)]))
    check(recall >= 0.9, f"recall@{pipe.k} vs exact scan {recall:.3f} < 0.9")
    phase("step", t0, doc_ids_identical=True, tokens_identical=same_tokens,
          recall_at_k=f"{recall:.4f}", kernel_step_s=f"{t_k:.4f}",
          plain_step_s=f"{t_p:.4f}")
    return {"recall": recall, "step_s": t_k, "plain_step_s": t_p}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke.py: no {PKG}/ beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import rag_inference_pipeline_tpu_torch as pkg

    check(os.path.dirname(os.path.abspath(pkg.__file__)) == os.path.join(ROOT, PKG),
          f"{PKG} imported from outside this checkout: {pkg.__file__}")

    phase_device()
    phase_build()
    k1 = phase_k1()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        paths = phase_corpus(workdir)
        executor, launches, _ = phase_serve(paths)
        phase_step(executor)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m.split(".")[0] == "rag_inference_pipeline_tpu" for m in sys.modules),
          "the JAX package was imported")
    print(json.dumps({"kernels": [{
        "name": "binmax_int8gs",
        "route": "cuda",
        "source": f"{PKG}/csrc/binmax_int8gs.cu",
        "replaces": "rag_inference_pipeline_tpu/ops/topk.py:442",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
