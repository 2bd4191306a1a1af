"""Build a synthetic corpus for the port's servers: a doc store, an index
`.npz` and, with `--tokens`, the fused path's doc-token files.

    python -m rag_inference_pipeline_tpu_torch.tools.create_test_docs \\
        --out-dir artifacts/corpus --num-docs 100000 --kind flat --dtype int8 --tokens

Port of `scripts/create_test_docs.py`, with the same documents and, from
the same `--seed`, the same random vectors:

- `documents.ragdoc`, the native store (`--backend native`, the default,
  `DOC_STORE_BACKEND=native`; `native/docstore.cc`, built with g++ at
  first use), or `documents.db`, the sqlite store (`--backend sqlite`);
- `index.npz`: `--kind flat` (bf16, or int8 with a bf16 re-score copy of
  64, the fused path's index), `ivf_flat` or `ivf_pq`, built by the port's
  index classes on the card (`DEVICE_PLATFORM=cpu`: on the CPU);
- `doc_tokens.npy` and `doc_tokens_mask.npy` (`--tokens`): every document
  in the LLM's token space, through the LLM's tokenizer, which is the
  checkpoint's `tokenizer.json` when `MODEL_WEIGHTS_DIR` holds the LLM.

`--embed` embeds the documents with the port's `EmbedderComponent` (the
settings' `EMBEDDING_MODEL`, from its checkpoint or random weights) in
place of random vectors. Every file loads in the JAX package as in the
port. Model names, `MODEL_WEIGHTS_DIR` and `DEVICE_PLATFORM` come from the
environment, as the servers read them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np


def synth_doc(i: int, rng: np.random.Generator) -> tuple[int, str, str]:
    topics = [
        "climate", "medicine", "finance", "space", "history", "sports",
        "music", "cooking", "travel", "physics", "biology", "law",
    ]
    t = topics[i % len(topics)]
    words = rng.choice(
        ["analysis", "report", "study", "overview", "data", "results",
         "method", "review", "survey", "facts", "notes", "summary"],
        size=24,
    )
    content = f"A {t} document. " + " ".join(words) + f" Reference item {i}."
    return i, f"{t.title()} document {i}", content


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default="artifacts/corpus")
    p.add_argument("--num-docs", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--kind", choices=["flat", "ivf_flat", "ivf_pq"], default="flat")
    p.add_argument("--nlist", type=int, default=1024)
    p.add_argument("--pq-m", type=int, default=96)
    p.add_argument("--dtype", choices=["bfloat16", "int8"], default="bfloat16",
                   help="flat index storage (int8: the fused path's scan, with a "
                   "bf16 re-score copy)")
    p.add_argument("--embed", action="store_true",
                   help="embed the documents with the configured embedder "
                   "(else random unit vectors)")
    p.add_argument("--backend", choices=["native", "sqlite"], default="native")
    p.add_argument("--tokens", action="store_true",
                   help="also write doc_tokens.npy and its mask for the fused path")
    p.add_argument("--doc-tok-len", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..core.config import load_settings
    from ..core.device import resolve_device
    from ..utils.docstore import build_native_store, build_sqlite_store

    settings = load_settings()
    device = resolve_device(settings.device_platform)
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    t0 = time.time()
    docs = [synth_doc(i, rng) for i in range(args.num_docs)]
    if args.backend == "native":
        db_path = os.path.join(args.out_dir, "documents.ragdoc")
        build_native_store(db_path, docs)
    else:
        db_path = os.path.join(args.out_dir, "documents.db")
        build_sqlite_store(db_path, docs)
    print(f"doc store: {db_path} ({time.time() - t0:.1f}s)")

    t0 = time.time()
    if args.embed:
        from ..models.components import EmbedderComponent

        emb = EmbedderComponent(settings, device)
        emb.load()
        vectors = np.concatenate([
            emb.encode([d[2] for d in docs[s : s + 256]])
            for s in range(0, len(docs), 256)
        ])
        dim = vectors.shape[1]
        print(f"embedded {len(docs)} docs ({time.time() - t0:.1f}s)")
    else:
        dim = args.dim
        vectors = rng.standard_normal((args.num_docs, dim)).astype(np.float32)
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
        print(f"random vectors {vectors.shape}")

    t0 = time.time()
    if args.kind == "flat":
        from ..index.flat import FlatIndex

        idx = FlatIndex(dim, dtype=args.dtype, device=device,
                        rescore_k=64 if args.dtype == "int8" else 0)
        idx.add(vectors)
    elif args.kind == "ivf_flat":
        from ..index.ivf_flat import IVFFlatIndex

        idx = IVFFlatIndex(dim, nlist=args.nlist, device=device)
        idx.train_add(vectors)
    else:
        from ..index.ivf_pq import IVFPQIndex

        idx = IVFPQIndex(dim, nlist=args.nlist, m=args.pq_m, rescore_k=100,
                         device=device)
        idx.train_add(vectors)
    index_path = os.path.join(args.out_dir, "index.npz")
    idx.save(index_path)
    print(f"index ({args.kind}): {index_path} ({time.time() - t0:.1f}s)")

    env = (f"INDEX_PATH={index_path} DOCUMENT_DB_PATH={db_path} "
           f"DOC_STORE_BACKEND={args.backend} INDEX_DIM={dim}")
    if args.tokens:
        from ..models.components import LLMComponent
        from ..models.tokenizer import make_tokenizer

        llm = LLMComponent(settings, device)  # the tokenizer only: no weights
        tok = make_tokenizer(llm.model_name, settings.model_weights_dir,
                             vocab_size=llm.cfg.vocab_size, pad_id=0, eos_id=2)
        tok_ids, tok_mask = tok.encode_batch([d[2] for d in docs], args.doc_tok_len)
        tok_path = os.path.join(args.out_dir, "doc_tokens.npy")
        np.save(tok_path, tok_ids.astype(np.int32))
        # an explicit validity mask: id 0 can be a real token of a real
        # vocabulary, so `ids > 0` is no pad test
        np.save(os.path.join(args.out_dir, "doc_tokens_mask.npy"),
                tok_mask.astype(np.uint8))
        print(f"doc token store: {tok_path} {tok_ids.shape} (+mask)")
        env += f" DOC_TOKENS_PATH={tok_path}"
    print(f"\nServe with:\n  {env} python -m rag_inference_pipeline_tpu_torch.serve.runtime")
    return 0


if __name__ == "__main__":
    sys.exit(main())
