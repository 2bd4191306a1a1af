#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (rag_inference_pipeline_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line with its result and time; any failure raises
and exits non-zero before the last line:

1. device  — requires CUDA; prints the card's name and power limit.
2. build   — compiles every kernel under rag_inference_pipeline_tpu_torch/csrc
             with nvcc for sm_90a, one nvcc per source started together
             (ptxas report included).
3. k1      — the int8 bin-max scan kernel against its plain PyTorch version on
             the card, bit for bit, at the main-path shape (B=8, D=768,
             1M rows plus a ragged tail, ntotal < N, nbins=1024) and on
             small ragged cases; kernel and plain times from CUDA events,
             and the kernel at the kernel lab's B=128 over the same rows,
             bit for bit, timed with its passes over them (one per query
             tile). Phases k1, k2
             and k3 print each kernel's ms, its bound, the bytes of the
             bound over the time (TB/s) and its share of the bound.
4. k2      — the bf16 bin-max scan kernel against its plain version at
             B=8 x 1,000,777 rows (ntotal 1,000,333), D=768, nbins=512:
             integer-valued inputs bit for bit, random unit rows within
             rtol=atol=1e-5; times from CUDA events.
5. corpus  — a seeded 1M x 768 corpus and 48-token documents, saved through
             the port's FlatIndex.save and np.save.
6. serve   — the fused path: serve.runtime over that corpus with the
             default models at full width and random weights (BGE-base,
             Qwen2.5-0.5B, two BERT-base classifiers), MAX_TOKENS=128, with
             WARMUP_BUCKETS=1: the executor must warm exactly the buckets
             it dispatches (1, 2, 4, 8); then 10 POST /query, 8 of them
             concurrent. The K1 launch count, zeroed after /health (warm-up
             launches K1 too), must rise; no decode graph may be captured
             after warm-up. Warm-up seconds and first_s printed. Every
             other in-process server phase sets WARMUP_BUCKETS=0.
7. step    — one 8-lane fused step with the kernel and with the plain scan:
             identical doc ids; retrieval recall@10 against the exact scan
             of the bf16 rescore copy.
8. ivf_build — a seeded clustered 1M x 768 corpus (scripts/
             ivf_recall_oracle.py::clustered_corpus, the repo's 1M
             "realistic" oracle settings: 2048 topics, relative spread 0.7);
             IVFFlatIndex.train_add on the card (nlist 4096, cap factor
             2.5, bf16 buckets); 48-token docs in a sqlite documents.db; and
             .npz save/load parity of a 50k-row IVF (the 1M index goes to
             the server as built: its float32 artifact would be 8 GB).
9. k45     — the IVF bucket kernels against their plain versions over the
             1M listing: K5 at B=8 (the batch's 512 unique probed buckets)
             and at B=32 (2,048 slots, one z-tile of 32 queries), K4 at
             B=64, nprobe 64; the listing's own rows within rtol=atol=1e-5,
             integer-valued rows of the same layout bit for bit; kernel,
             plain and (for K5) torch.matmul times from CUDA events, and
             the K5 blocks that read rows; K4's pair bytes and their rate;
             K4 on a small ragged listing (B=5, nprobe 3, D=36, an empty
             list, a list probed twice), bit for bit.
10. serve_staged — the staged path (TOTAL_NODES=1, profile
             single_node_full) over the 1M IVF-Flat index at full width
             (BGE-base, bge-reranker-base, Qwen2.5-0.5B, the two BERT-base
             classifiers), MAX_TOKENS=32 (NODES_MAX_TOKENS): 10 POST /query,
             8 of them concurrent, then one 64-item /retrieve at
             RETRIEVAL_BATCH_SIZE=64.
             /health must show the K5 count rising on /query and the K4
             count on /retrieve; recall@10 of the /retrieve ids against
             the exact scan of the bf16 corpus.
11. retrieve_flat — PIPELINE_ROLE_PROFILE=retrieval_default over the flat
             bf16 index of the same corpus: /retrieve at B=8, the K2 count
             rising, ids equal to a search with the plain scan but for at
             most one swapped pair a query (or one exchange at the last
             rank) of candidates whose exact scores tie within the
             tolerance.
12. pq_build — IVFPQIndex.train_add on the card over the same corpus and
             lists (nlist 4096, cap factor 2.5): PQ4 at m=192 and PQ8 at
             m=96, each with an exact bf16 re-score of 256, and PQ4 with
             the int8 host refine store; build times, cap, imbalance and
             code bytes; .npz save/load parity of 50k-row PQ4 and PQ8
             indexes, saved, loaded, saved and loaded again.
13. k6     — the PQ4 ADC kernel against its plain version over the 1M PQ4
             listing at B=8 (the batch's ~512 unique probed buckets) and
             B=64 (all 4096): integer-valued tables bit for bit, the
             listing's own bf16 tables within rtol=atol=1e-5; kernel,
             plain and embedding_bag times from CUDA events, and the
             one-hot form's bf16 TFLOP/s; B=13 (a partly padded query
             tile) on integer tables bit for bit; the whole B=64 search's
             time and peak memory; its flat top-k (the exact selection)
             beside the stable sort it replaced, and the same indices as
             that sort on integer rows with NEG_INF ties.
14. serve_pq — the staged server over the PQ indexes: retrieval_pq4 (an
             8- and a 64-item /retrieve, K6 rising, ids equal to a search
             with the plain scan), retrieval_pq_host_refine and
             retrieval_ivfpq (8 items each), with recall@10 against the
             exact scan; then single_node_full with INDEX_KIND=ivf_pq at
             full model width: two /query, K6 rising.
15. k3     — the per-row-scale int8 bin-max kernel against its plain
             version, bit for bit, at B=8 x 1,000,777 x 768, nbins 512, with
             f32 scales over many binades (a negative, a zero and a NaN
             among them) and on two small ragged cases (B=37; N < nbins);
             then fused_topk_int8 (rescore_k=64) over 1M seeded unit rows,
             64 noisy queries: the K3 count, zeroed just before, must rise,
             its ids must equal those through the plain scan, and recall@10
             against the exact scan must reach 0.95.
16. k8     — the stream kernel against its plain version at 1M x 768 int8
             for chunk 4096 and 8192 (out and checksum identical), its GB/s
             beside the data sheet's 3.35 TB/s; then the kernel lab
             (tools/bench_kernel.py): its stream mode (K8 count zeroed
             just before, must rise), its scan and tail modes at B=128,
             nbins 1024.
17. k7     — the decode-anatomy probe (tools/bench_decode_anatomy.py) at
             full width: Qwen2.5-0.5B, random bf16 weights, B in {1, 8},
             prompt 128, cache 384, every variant, eager and as one
             replayed CUDA graph of the call (tokens bit for bit); --length
             and --reps cut to ANATOMY_ARGS for the time limit. The K7 pair
             count, zeroed just before, must equal 24 layers x steps x
             batches x (eager calls + the capture's eager warm-up): one
             launch per layer for K and V, counted by the wrapper, which a
             capture and its replays do not call. One replay of the kernel
             variant's graph must run 24 x steps K7 launches, counted by
             name in a torch.profiler trace. The single and pair inserts
             against their plain versions, bit for bit, on the probe's own
             B=8 caches (one position past the end, one below 0); the pair
             against the two index_copy_ calls that write the same rows,
             in device ms and host us per call (medians of 7 alternated
             rounds: the calls are host-bound).

18. serve_spec — the fused path of phase 6 with USE_SPECULATIVE_DECODING=1
             (gamma 8): 10 POST /query, 8 of them concurrent; the K1 count,
             zeroed just before, must rise.
19. engine_serve — the staged server of phase 10 with
             USE_CONTINUOUS_BATCHING=1 (32 lanes, cache 1024, segment 8),
             then with USE_SPECULATIVE_DECODING=1 too: a second /query alone,
             16 concurrent /query of mixed lengths (answers capped at
             MAX_TOKENS=128); the K5 count, zeroed just before, must rise; the
             engine's segments, tokens and peak lanes.
20. decode_graph — greedy_generate at Qwen2.5-0.5B width (bf16, random
             weights), prompt bucket 512 (384-512 live tokens), 128 new tokens,
             at B=8 and B=1 (_greedy_against_eager): the step graph against
             greedy_generate_eager over the first 32 of them (the eager loop
             on the graph's cache length), tokens bit for bit, ms per token of the
             eager call and of a second graph call, the graph's capture
             seconds, pool and state MB, the device's peak over the first
             call, no W8A8 launch; at B=8 a torch.profiler trace of 8 step
             replays (the device's busy share, kernels a step).
21. spec   — ngram_speculative_generate against greedy_generate in float32
             at B=8, gamma 8, 128 tokens: a row may leave greedy only at a
             step whose two top logits lie within NEAR_TIE (each such gap
             printed); then, in bf16, the benchmark-only injected acceptance
             at p in {0.7, 0.9}: ms per token and commits per call.
22. engine — a DecodeEngine at full width in float32 (32 lanes, cache 1024,
             segment 8), plain and speculative, over 16 prompts of 64-512
             tokens with budgets of 16-128 (_engine_against_greedy): every
             sequence held to a solo greedy_generate under the near-tie
             rule; wall, segments, tokens, capture seconds and pool MB.
23. w8a8   — the W8A8 kernels (ops/w8a8.py) against their plain versions,
             bit for bit: the small-row quantize-and-GEMM (csrc/w8a8_gemm.cu),
             the large-row wgmma GEMM (csrc/w8a8_wgmma.cu) and the
             activation quantize (csrc/w8a8_quant.cu), each called directly
             on ragged cases (M 1, 5, 17, M* and M* + 1, 64, 65, 72, 300; K
             36, 896, 4,864; the wgmma GEMM where K % 16 == 0), then
             `w8a8_dense` at every shape of the int8 path (Qwen2.5-0.5B's
             decode groups q/k/v and gate/up, o, down and the tied head at
             B = 8 and 1, a verify round's q/o, q/k/v, gate/up, down and
             head at 72 rows, the engine's speculative q/k/v and down at 288
             rows, a B = 1 prefill's q/k/v and down at 128 rows, prefill
             q/k/v, gate/up and down at 8 x 512 tokens, a BERT-base FFN at
             8 x 512, a classifier, the engine step's products at 32
             lanes) on the route `_route` picks, and on the small-row route
             the kernel `_qgemm_short` picks, each kernel
             there against its plain version (the wgmma GEMM a weight and
             for the whole group in one launch); per shape the route and
             the wgmma GEMM's plan (`_gemm_plan`) and its kind
             (`_plan_kind`: wide, bands, shared, few_rows, few_tiles; the
             kernels line times each kind at a W8A8_MAIN shape, the new
             ones at Llama-3.1-8B's), each kernel's device time
             (CUDA events over replays of one captured graph of many calls:
             an eager loop of microsecond launches times the host), the
             plain version's time, the bound and the share of it, and, as a
             yardstick only, torch._int_mm where M > 16 (a call a weight
             beside a group's one launch; on the small-row route, after
             quantize_rows); the wrapper's host us a call. The kernels
             line has an entry for each small-row kernel: the short-K one
             at Qwen2.5-0.5B's decode gate/up, the streaming one at
             Llama-3.1-8B's decode down.
             Then the s32 kind (a row-parallel shard's exact sum) on both
             kernels at Qwen2.5-0.5B's tp = 2 shapes (W8A8_TP_SHAPES: decode
             o and down, the verify round's down, prefill down; decode o
             on the short-K kernel), bit for bit against its plain twin,
             µs, bound and torch._int_mm. Runs
             after k2.
24. serve_w8a8 — the fused server of phase 6 with LLM_WEIGHT_QUANT=int8 and
             ENCODER_WEIGHT_QUANT=int8: 10 POST /query, 8 of them
             concurrent; the K1 count and each W8A8 kernel's (small-row,
             wgmma, quantize), zeroed just before, must rise. Runs after
             serve_spec.
25. decode_w8a8 — greedy_generate over Qwen2.5-0.5B with int8 weights
             quantized at the source (seeded random bf16 draws), B = 8,
             prompt bucket 512, 128 new tokens (_greedy_against_eager): the
             step graph against the eager loop, tokens bit for bit; ms per
             token of each beside
             decode_graph's bf16 figures; each W8A8 kernel's launches (the
             prefill's and the capture's warm-up: a replay counts none),
             exactly those the route rule gives; the B = 8 step's busy
             share, kernels and W8A8 kernels from 8 traced replays; the pool
             MB. Then ngram_speculative_generate over int8 weights at B = 8,
             gamma 8 (the verify round's 72 rows on the wgmma GEMM's plan
             for few row tiles): in float32 activations its rows held to
             int8 greedy's under the near-tie rule, its W8A8 launches by
             route and plan (counted from zero just before the call) equal
             to the route rule's, one replayed round's W8A8 kernels from a
             trace; in bf16, ms per token and commits per call beside
             greedy's. Runs after spec.

26. checkpoint — runs after step, on phase serve's corpus and trees: the
             four served models (BGE-base, Qwen2.5-0.5B in BF16 with its
             tied head omitted and its layers in two shards, the two
             BERT-base classifiers under `bert.`) written under HF names
             with the port's safetensors writer, no tokenizer.json. Each
             read back through the loader alone (load s, GB, GB/s, the
             rise of the host's RSS, sampled every ms); Qwen quantized on
             load on the card, bit for bit against quantize_qwen_params of
             the bf16 tree, with its device peak beside the bf16 tree's
             size; then the fused server with
             MODEL_WEIGHTS_DIR and ALLOW_RANDOM_WEIGHTS=0 (phase line
             checkpoint_serve): /health shows no random weights and each
             model's checkpoint dir, every served leaf equals its source
             bit for bit, the 10 /query bodies equal phase serve's, K1's
             count rises, and one 8-lane fused step gives the same doc ids,
             scores and tokens as phase serve's executor.

27. serve_3node — runs after serve_staged, over its 1M IVF-Flat index (saved
             to the workdir as .npz) and its sqlite docs: three node
             processes through tools/start_pipeline.py (TOTAL_NODES=3, the
             built-in gateway_default, retrieval_default and
             generation_default profiles, NODE_*_IP=127.0.0.1, a free
             BASE_PORT, serve_staged's INDEX_KIND, nprobe,
             RETRIEVAL_BATCH_SIZE=64 and MAX_TOKENS=32; models at full
             width, random seeded weights; COMPRESSION_ALGORITHM zstd where
             zstandard imports, else none). Through the gateway: the two
             sequential /query of serve_staged, whose bodies must be
             identical to serve_staged's, then 8 concurrent /query, then
             /clear_cache, whose reply must list the cascade to both peers.
             On node 1: the 64-item /retrieve as one embeddings_b64 block,
             whose ids must equal serve_staged's /retrieve ids. Node 1's
             /health must show K5 launched by the /query calls and K4 by
             the /retrieve. Every node must still run, and then exit 0
             within 60 s of SIGTERM. Times beside serve_staged's. The
             nodes take the serving default, warm-up on: each node's load
             seconds; node 2's decode graphs (4 batch buckets x 3 prefill
             buckets) and their pool MB, the same before the first /query
             and after the last. After the 10 /query, /metrics on each
             node: all 16 metrics with HELP and TYPE, the gateway's ok
             count equal to the requests, RPC times to both peers, node 1's
             embed, search and fetch stages, node 2's rerank, llm,
             sentiment and toxicity (the breakdown printed). A
             /profile/start on nodes 1 and 2 (a second start 409), one more
             /query, /profile/stop (a second stop 409): node 1's trace must
             name K5's kernel, node 2's a kernel of a replayed decode
             graph. A CORS preflight to the gateway answers 204 with the
             Origin echoed; the 64-item /retrieve sent again with
             Accept-Encoding: gzip decodes to the same reply.

28. flash  — runs after k2: the encoder flash kernel (csrc/
             flash_attention.cu) against its plain version at B=4 over
             the four mask kinds (a full row, 70% valid, one valid token,
             none): bge-base's heads (H 12, Dh 64) in bf16 at T 1024, 2048
             and 4096, Dh 128 (H 6) and Dh 256 (H 3) at T 1024, f16 and f32
             at T 1024; each case's max abs error, kernel, plain and SDPA
             ms (SDPA with the boolean segment-equality mask, timed only),
             SDPA over the kernel, the bound (f32: six bf16 products, the
             kernel's split) and the CUDA-core floor (tools/bench_flash.py's
             count from the SASS; null where it fails: no figure fails the
             phase). Then bert_embed at bge-base width (12 layers, random
             seeded bf16 weights, max_positions 2048) at B=4 and T 1024 and
             2048, once with int8 weights and once with f32 weights at T
             1024: the kernel
             count, zeroed just before, must rise by exactly 12 a forward;
             the CLS embeddings against the same forward through the plain
             version (max abs error, min cosine); ms a forward.

29. host_stores — runs after retrieve_flat, over its 1M x 768 corpus,
             queries and sqlite docs: the host-side native layer (built by
             g++ from native/*.cc; the vector extensions of the build
             printed first). The native doc store of the same documents
             (build_native_store); the int8 flat index with its f16
             rescore copy in host RAM (rescore_store="host", rescore_k 64)
             and with its bf16 copy on the card, the device bytes of each
             (torch.cuda.memory_allocated around the build). Then
             PIPELINE_ROLE_PROFILE=retrieval_default over the host store
             with DOC_STORE_BACKEND and FAST_JSON unset (the defaults:
             native, on), INDEX_RESCORE_STORE=host: an 8- and a 64-item
             /retrieve in id_only mode, again with FAST_JSON=0, and in
             full mode. K1 must launch; ids must equal the plain pipeline's
             (K1's plain scan, then the numpy re-score, over the batches
             the server searched) but for near-ties within TOL; recall@10
             against the exact f32 scan must reach the device store's; the
             fast reply must read back as the stdlib one (ids, f32 scores);
             the documents must be sqlite's. Printed: the native re-score
             against numpy at S 64 and 4,096 (B 8, alternated), native
             get_batch against sqlite at 64 ids, the native parse and
             encode of the 64-item body against the stdlib, the /retrieve
             latencies and index/host_refine from /metrics.

30. mesh_retrieve — runs after serve_pq, on its corpus, queries and
             indexes: data parallelism on the one card, dp = 4 positions
             repeating cuda:0 (core/mesh.py::force_host_devices): the int8
             flat index with the bf16 re-score on the card and with the f16
             store in host RAM, the bf16 flat index, IVF-Flat (serve_staged's
             listing, sharded) and IVF-PQ4 (pq_build's, sharded), each
             searched at B=64 beside the same index at dp = 1. Per kind:
             each shard's device bytes; K1, K2, K5 or K6, zeroed just
             before, launched exactly once a shard; ids equal to the same
             sharded search through the kernel's plain version (bf16 and
             IVF-Flat: but for near-ties within TOL; PQ4: its 256-deep ADC
             shortlist before the re-score, near-ties looked up in the
             plain one searched deeper); recall@10 against the exact f32
             scan, at or above the dp = 1 index's. K1 at B=8: the four
             shards' times summed beside one launch over all the rows; the
             IVF searches warm, with the kernel and with the plain version.
31. mesh_fused — the fused /query server of phase 6 on a dp = 2 mesh of
             cuda:0 (make_server(mesh=...)): full-width BGE-base and
             Qwen2.5-0.5B, the 1M int8 index loaded into 2 row shards. Two
             /query (K1 twice a step); then one 8-lane step with the kernel
             and with the plain scan: doc ids and tokens identical.
32. spmd   — two processes of the serving entry point on cuda:0
             (DIST_NUM_PROCESSES=2, gloo on localhost), each holding half of
             phase corpus's 1M int8 index (retrieval_default, id_only): an
             8-item /retrieve through process 0, its ids identical to the
             in-process dp = 2 sharded search; K1 launched once on process
             0 for it (its /health), and on the worker once a search (the
             counts it logs as it leaves, against process 0's total);
             SIGINT on process 0 sends OP_STOP, and both processes exit 0,
             having imported no jax.
33. mesh_tp — runs after mesh_fused: the attention over a shard's 7
             heads against those heads of the 14-head call, bit for bit
             (decode and prefill shapes); Qwen2.5-0.5B at tp = 2 on cuda:0
             (parallel/sharding.py::place_params), bf16 and W8A8: a shard's
             split elements against the arithmetic (bf16), the MiB the
             split adds; greedy at B=8, prompt bucket 512, 128 tokens as a
             graph against tp = 1 and against its own eager loop (16
             tokens, bit for bit). W8A8: every token and the logits over 32
             decode steps forced to tp = 1's tokens bit for bit tp = 1's.
             bf16: the forced logits' RMS distance to f32 activations
             within TP_BF16_RMS x tp = 1's, a planted dropped partial
             beyond it; the rows that leave tp = 1's, reported. ms a token
             (alternated) and kernels a step (torch.profiler) at tp 1 and
             2; the s32 launches of the timed calls (the wrappers' prefill
             launches and each replay's from the trace). The W8A8 engine
             at tp = 2 over 16 prompts: every sequence tp = 1's. The fused
             W8A8 server through make_server at MESH_TP=2: /health's mesh,
             every model split, two /query bodies equal to serve_w8a8's.
34. tp_encode — bge-base (T 1024, B 4, bf16, attention weights at 3x the
             init's std) at tp 2 and 4: the flash kernel 12 x tp times a
             forward, the pooled embeddings within TP_EMB_ATOL of tp = 1
             (cosine >= TP_MIN_COS) and a planted dropped partial outside,
             ms a forward (alternated, 20 a round).
35. sp     — bert_encode_sp at sp 2 and 4 (T 2048, B 2, row 1 valid to
             1500, the same weights' scale): the valid rows against
             bert_encode's within SP_ATOL (cosine >= SP_MIN_COS), a planted
             gather of position 0's keys only outside, ms a forward beside
             bert_encode's.

The Llama family at full width and depth, random weights from a seed
(phase w8a8 also holds every W8A8 kernel at the Llama-3.1-8B's and the
Llama-3.2-1B's products, the `l8b_`/`l1b_` rows of W8A8_SHAPES: the 8B's
decode step, verify round, prefill, engine step and engine verify round,
the 1B's decode step, prefill and tied head):

36. llama_serve — runs after spmd, over phase corpus's 1M x 768 int8 index
             and 48-token documents drawn in the 8B's 128,256-token
             vocabulary (phase line llama_doc_tokens): the fused server of
             phase serve with LLM_MODEL=meta-llama/Llama-3.1-8B-Instruct and
             LLM_WEIGHT_QUANT=int8, warm-up on: phase serve's /query, two
             then 4 concurrent, well-formed bodies, K1 and every W8A8 kernel
             launching; first and second /query, warm-up, graphs and the
             ladder clamped to the card's free memory (/health's
             llm_ladder), the buckets warmed within it.
37. llama_8b_bf16, llama_8b_int8 — run after engine: Llama-3.1-8B (32
             layers, an untied head) in bf16, then W8A8 quantized at the
             source: greedy at B = 8 and 1, bucket 512, 128 tokens, the
             step graph against the eager loop over the first 16, tokens
             bit for bit; ms a
             token of each, capture s, pool MB, the device's peak GB at load
             and in the first call; each W8A8 kernel's launches the route
             rule's (_greedy_against_eager); at B = 8 a trace of 8 step
             replays (kernels and W8A8 kernels a step). bf16: speculation (gamma 8)
             ms a token and commits a call. W8A8: decode_w8a8's int8
             speculation and its hold (_int8_speculation) on the 8B; both
             over LLAMA_SPEC_NEW tokens.
38. llama_8b_f32_spec — Llama-3.1-8B in float32 from seed 1: speculation
             at B = 8, gamma 8, LLAMA_SPEC_NEW tokens, against greedy, rows
             held by the near-tie rule of phase spec; then on this tree
             (phase line llama_8b_f32_engine) phase engine's DecodeEngine,
             plain and speculative, over the first 8 of its prompts in the
             8B's vocabulary, every sequence held to a solo greedy_generate
             under the near-tie rule (32 layers x 8 kv heads x 128).
39. llama_engine — within llama_8b_int8, on its tree: a DecodeEngine (32
             lanes, cache 1024, segment 8), plain and speculative, over 16
             prompts of 64-512 tokens: every sequence its budget long, in
             the vocabulary, the W8A8 kernels launching; then one segment
             replayed as the graph against the eager body from the same
             admitted state, every state tensor bit for bit (the emission
             buffer but the verify rounds' scratch column). Its launches
             join the kernels line; the hold on the 8B engine's tokens is
             llama_8b_f32_engine's.
40. llama_1b — Llama-3.2-1B (16 layers, tied head), bf16 and W8A8: greedy
             at B = 8 as llama_8b's.

Then one JSON line of kernel results (each with its bound: the bytes or
operations of the function over the card's peak rates, and the time of one
PyTorch call computing the same function where there is one), and last the
device line that the chip check reads.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
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
LAB_B = 128  # the kernel lab's scan batch (BASELINE.json's in-program QPS)
# K5's widest batch on the served route: the dedup path is taken up to
# B ~ 40 at nprobe 64 and cap 640 (the 1 GB gate of index/ivf_flat.py)
K5_WIDE_B = 32
# the served configuration: default model names at full width, random
# weights, the int8 flat index, 128 new tokens; no warm-up (phase serve and
# the three node processes of serve_3node turn it on), so that every other
# server phase's figures compare with earlier runs'
SERVE_ENV = {
    "USE_FUSED_PIPELINE": "1", "INDEX_DTYPE": "int8", "MAX_TOKENS": "128",
    "DEVICE_PLATFORM": DEVICE, "MODEL_WEIGHTS_DIR": "", "WARMUP_BUCKETS": "0",
}
# the staged configuration: one node, IVF-Flat at the reference's defaults
# (nlist 4096, nprobe 64, cap factor 2.5, bf16 buckets), a sqlite doc store,
# 64-item retrieval batches (the size at which the K4 route is taken)
STAGED_ENV = {
    "TOTAL_NODES": "1", "INDEX_KIND": "ivf_flat", "MAX_TOKENS": "128",
    "DEVICE_PLATFORM": DEVICE, "MODEL_WEIGHTS_DIR": "", "WARMUP_BUCKETS": "0",
    "DOC_STORE_BACKEND": "sqlite", "RETRIEVAL_BATCH_SIZE": "64",
}
# serve_staged's and serve_3node's answers (the three nodes' bodies held to
# serve_staged's): 32 tokens, so node 2's traced /query replays a quarter
# of the 128 steps' ~240,000 kernels
NODES_MAX_TOKENS = "32"
# the fused executor's dispatched buckets at FUSED_CHUNK_LANES=8, which
# phase serve warms
FUSED_WARM_BUCKETS = (1, 2, 4, 8)
# the 16 metrics of telemetry/metrics.py, as /metrics names them
METRIC_NAMES = (
    "pipeline_requests_total", "pipeline_request_latency_seconds",
    "pipeline_stage_duration_seconds", "pipeline_batch_size", "pipeline_batch_flush_total",
    "pipeline_batch_wait_seconds", "pipeline_queue_depth", "pipeline_cache_events_total",
    "pipeline_rpc_duration_seconds", "pipeline_errors_total", "pipeline_compression_ratio",
    "pipeline_memory_rss_bytes", "pipeline_device_memory_bytes",
    "pipeline_tokens_generated_total", "pipeline_engine_lanes_active",
    "pipeline_engine_segments_total",
)
NLIST, NPROBE = 4096, 64
# the repo's 1M "realistic" IVF oracle corpus (artifacts/round3/
# ivf_oracle_1m_realistic_cap25.json): 2048 topics, relative spread 0.7,
# queries = corpus rows + N(0, 0.0108^2) per coordinate
IVF_CLUSTERS, IVF_SPREAD, QUERY_NOISE = 2048, 0.7, 0.0108
RETRIEVE_B = 64
# IVF recall@10 of /retrieve (K4 route) against the exact scan: 0.9969
# measured on one H100 with these settings; the bar leaves room for a
# near-tie, not for a fault
RECALL_BAR = 0.95
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 sums of bf16 products, another order
# IVF-PQ on the same corpus and lists: PQ4 at m=192 (configs/retrieval_pq4.yaml
# doubles PQ8's m for equal bits per row), PQ8 at m=96 (the settings' default),
# both re-scoring a 256-deep ADC shortlist (INDEX_PQ_RESCORE_K)
PQ4_M, PQ8_M, PQ_RESCORE_K = 192, 96, 256
# recall@10 of the PQ /retrieve calls against the exact scan, measured on one
# H100 with these settings: PQ4 + exact re-score 0.9844 (64 queries), PQ4 +
# host int8 refine 0.9375 and PQ8 + exact 0.9875 (8 queries each, so one id
# is 0.0125). The bars leave room for a few near-ties, not for a fault.
PQ_RECALL_BAR = {"pq4": 0.95, "pq4_host": 0.9, "pq8": 0.95}
# the least time the card could take: bytes over the HBM rate, operations
# over the peak rate of their type (NVIDIA's H100 SXM data sheet, dense).
# The sheet's 67 TFLOP/s of float32 counts an FMA as two operations, so
# plain f32 adds issue at half that.
HBM_BYTES_PER_S = 3.35e12
# the anatomy probe's --length 128 and --reps 3, cut to fit the time limit
# (the tensor-parallel phases took the probe's length from 32 to 8, the
# Llama phases its reps from 2 to 1)
ANATOMY_ARGS = ["--length", "8", "--reps", "1"]
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32_add": 67e12 / 2}
# the decode slice: the staged ladder's largest prefill bucket, MAX_TOKENS,
# alternated eager/graph rounds (one, for the time limit: PERF.md §4);
# speculation at the settings' gamma and the benchmark-only acceptance
# rates of VERDICT.md item 4; a sequence may leave greedy's only at a step
# whose two top f32 logits lie within NEAR_TIE; the engine at the
# settings' defaults (32 lanes, cache 1024, segment 8)
DECODE_BUCKET, DECODE_NEW, DECODE_ROUNDS = 512, 128, 1
# the greedy checks' eager loops run the first DECODE_EAGER_NEW of the
# graph's DECODE_NEW tokens (Qwen2.5-0.5B: ~45 ms a token eagerly)
DECODE_EAGER_NEW = 32
SPEC_GAMMA, INJECT_P, NEAR_TIE = 8, (0.7, 0.9), 1e-4
# the largest |difference| of the int8 decoder's f32 logits between the
# verify round and the decode step on the same tokens, at most this many
# times what a 2-ulp nudge of the embeddings moves them (decode_w8a8)
INT8_PATH_NOISE = 4.0
ENGINE_REQUESTS, ENGINE_LANES, ENGINE_CACHE, ENGINE_SEGMENT = 16, 32, 1024, 8
# tensor and sequence parallelism on the one card (positions repeat cuda:0):
# Qwen2.5-0.5B at tp = 2 (its 2 kv heads allow no other tp); its engine over
# TP_ENGINE_REQUESTS prompts; bge-base at tp 2 and 4 (T 1024, B 4) and
# sequence-parallel at sp 2 and 4 (T 2048, B 2, row 1 valid to SP_VALID)
TP, TP_ENCODE, SP_SIZES = 2, (2, 4), (2, 4)
TP_ENGINE_REQUESTS, TP_ENGINE_LANES, TP_ENGINE_CACHE = 16, 16, 640
TP_ENCODE_T, TP_ENCODE_B, SP_T, SP_B, SP_VALID = 1024, 4, 2048, 2, 1500
# tp_encode and sp draw bge-base's attention weights (q, k, v, o) at
# ATTN_SCALE x the init's std of 0.02: at the init the scores are near
# uniform and a layer's attention adds ~1% to its residual, so a fault in
# the head split or in the K/V gather reads as rounding (4 layers, T 512,
# f32 on a CPU: each sp position attending position 0's keys only moves
# the valid rows 0.088 from bert_encode at the init's scale, against bf16's
# own 0.074; at 3x 0.479 against 0.039)
ATTN_SCALE = 3.0
# each limit lies between the sound reading and a planted fault's, both
# printed every run (PERF.md): tp_encode's pooled embeddings (unit norm)
# against tp = 1, the fault row_dense dropping every shard's partial but
# the first (on an H100: sound 2.3e-3, cosine 0.99984; fault 0.18-0.20,
# cosine 0.01); sp's valid rows against bert_encode (its flash branch), the
# fault each position attending position 0's keys only (sound 0.047,
# cosine 0.999923; fault 0.17-0.32, cosine 0.99534-0.99875: the limits at
# the geometric means)
TP_EMB_ATOL, TP_MIN_COS = 1e-2, 0.999
SP_ATOL, SP_MIN_COS = 0.09, 0.9997
# mesh_tp: W8A8 at tp = 2 is tp = 1 bit for bit (the row-parallel sums
# exact in s32, the attention's products of one kv head's group the same
# shapes at any tp), so its tokens, its logits over TP_FORCED_STEPS decode
# steps forced to tp = 1's tokens, the engine's and the served bodies must
# equal tp = 1's. bf16 sums its row-parallel partials in f32 before one
# cast where tp = 1 casts one product's sum: another rounding, as the
# reference's psum over tp is. Its tokens are reported; its forced logits'
# RMS distance to the same tree with f32 activations must stay within
# TP_BF16_RMS times tp = 1's (a split no less precise than the whole
# product; set before the first run that checked it, and a planted dropped
# partial must exceed it). The tp = 2 graph is held to its eager loop over
# TP_EAGER_TOKENS tokens
TP_FORCED_STEPS, TP_BF16_RMS, TP_EAGER_TOKENS = 32, 1.25, 16
# timing: the encoder's eager forwards, alternated, TP_TIME_ITERS a round
TP_TIME_ITERS, TP_TIME_ROUNDS = 20, 3
# Qwen2.5-0.5B at tp = 2 by arithmetic: the split weight elements a shard
# holds (q/k/v, o, gate/up, down of 24 layers, halved) and its q/k/v biases
TP_SPLIT_WEIGHTS, TP_SPLIT_BIASES = 178_913_280, 13_824
# the encoder's flash kernel: bge-base's heads (12 x 64) at three lengths,
# its width as 6 x 128 and 3 x 256 heads, and the other two dtypes, at B=4
# over the four mask kinds; the long-context path (bert_embed at bge-base
# width, max_positions 2048) at two lengths
FLASH_B = 4
FLASH_CASES = [
    (1024, 12, 64, "bfloat16"), (2048, 12, 64, "bfloat16"), (4096, 12, 64, "bfloat16"),
    (1024, 6, 128, "bfloat16"), (1024, 3, 256, "bfloat16"),
    (1024, 12, 64, "float16"), (1024, 12, 64, "float32"),
]
FLASH_PATH_T = (1024, 2048)
# kernel against plain version (atol, rtol): the q.k and p.v sums in f32
# in another order move a score by ~1e-7 of its size; in bf16 and f16 that
# can round a p to its neighbour before p.v and flip the output's last bit
FLASH_TOL = {"bfloat16": (1e-3, 2**-7), "float16": (2.5e-4, 2**-10),
             "float32": (1e-5, 1e-5)}
# the path's CLS embeddings (unit norm, bf16 weights, 12 layers) through the
# kernel against the same forward through the plain version: last-bit
# differences of the attention carried through 12 post-LN layers
FLASH_PATH_MIN_COS = 0.999


def phase(name: str, t0: float, **info) -> None:
    fields = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[{name}] ok {time.perf_counter() - t0:.3f}s {fields}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def zero_launches() -> None:
    """Every kernel wrapper's launch count to 0, just before a path runs."""
    from rag_inference_pipeline_tpu_torch.ops import (
        flash_attention, ivf, kv, pq, stream, topk, w8a8)

    for fn in (topk.binmax_partial_topk_int8gs, topk.binmax_partial_topk,
               topk.binmax_partial_topk_int8, ivf.ivf_scan_partial,
               ivf.ivf_dedup_scores, pq.ivfpq4_adc_scores, kv.kv_row_insert,
               kv.kv_row_insert_pair, stream.stream_sum, w8a8.quantize_rows,
               w8a8.w8a8_gemm, w8a8.w8a8_qgemm, w8a8.w8a8_gemm_s32,
               flash_attention.flash_encoder_attention):
        fn.launches = 0
    w8a8.w8a8_gemm_s32.wgmma_launches = 0
    w8a8.w8a8_gemm.few_tile_launches = w8a8.w8a8_gemm_s32.few_tile_launches = 0
    for fn in (w8a8.w8a8_gemm, w8a8.w8a8_gemm_s32):
        fn.plan_launches = dict.fromkeys(w8a8.PLAN_KINDS, 0)
    w8a8.quantize_rows.long_row_launches = 0
    w8a8.w8a8_qgemm.short_launches = w8a8.w8a8_gemm_s32.short_launches = 0


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """`bound_ms`: the larger of the bytes the function must move (inputs
    read once, outputs written once) over the HBM rate and its operations
    over the peak rate for `kind`; `bound_by` says which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_bytes": nbytes,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rate(tag: str, m: dict) -> dict:
    """A kernel's ms and bound, the bytes its bound counts over that time
    (TB/s) and its share of the bound, each under a name that starts with
    `tag`."""
    nbytes = m["bound_bytes"]
    return {f"{tag}_ms": f"{m['ms']:.4f}", f"{tag}_bound_ms": f"{m['bound_ms']:.4f}",
            f"{tag}_tb_per_s": f"{nbytes / m['ms'] / 1e9:.3f}",
            f"{tag}_of_bound": f"{m['bound_ms'] / m['ms']:.3f}"}


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


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device ms per call of `fn`: `iters` calls captured as one CUDA
    graph, replayed, timed with CUDA events. An eager loop of small
    launches times the host's launch rate instead (tens of us a call on
    the card's host)."""
    import torch

    fn()  # warm up: the library, the allocator's blocks
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


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
    from rag_inference_pipeline_tpu_torch.ops import _kernels
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
                # rows below ntotal, the queries, (value, row) per bin
                **bound(nt * d + b * d + b * nbins * 8, 2 * b * nt * d, "int8"),
                "library_ms": None,  # a positional bin max: no one call
            }
            # the kernel lab's batch over the same rows, bit for bit, then
            # timed: one pass over the rows per query tile
            wide = torch.randint(-127, 128, (LAB_B, d), generator=g, device="cuda",
                                 dtype=torch.int8)
            wv, wi = kernel(wide, db, nbins=nbins, ntotal=nt)
            pv, pi = plain(wide, db, nbins=nbins, ntotal=nt)
            check(torch.equal(wv, pv) and torch.equal(wi, pi),
                  f"K1 at B={LAB_B} differs from its plain version")
            b128 = {"ms": cuda_ms(lambda: kernel(wide, db, nbins=nbins, ntotal=nt), 10),
                    **bound(nt * d + LAB_B * d + LAB_B * nbins * 8,
                            2 * LAB_B * nt * d, "int8")}
            row_passes = -(-LAB_B // _kernels.binmax_tile()[1])
            del wide, wv, wi, pv, pi
        del q, db
    torch.cuda.empty_cache()
    phase("k1", t0, cases=len(cases) + 1, bit_identical=True,
          main_plain_ms=f"{out['plain_ms']:.4f}", **rate("main", out),
          **rate("b128", b128), b128_row_passes=row_passes)
    return out


def _values(g, integer: bool, *shape, dtype=None):
    """Integer-valued entries in [-8, 8] (every f32 sum of their products
    is exact for D <= 768) or random unit rows."""
    import torch

    if integer:
        x = torch.randint(-8, 9, shape, generator=g, device=DEVICE).float()
    else:
        x = torch.randn(shape, generator=g, device=DEVICE)
        x /= x.norm(dim=-1, keepdim=True)
    return x if dtype is None else x.to(dtype)


def _hold(name: str, integer: bool, kv, pv, k_choice=None, p_choice=None) -> float:
    """Kernel against plain: bit for bit on integer inputs; on random ones
    values within TOL and the same choices (row, slot) but for near-ties
    in at most 0.1% of the outputs. Returns the max abs value error."""
    import torch

    err = (kv.float() - pv.float()).abs().max().item() if kv.numel() else 0.0
    if integer:
        check(torch.equal(kv, pv), f"{name}: integer case differs (max err {err})")
        if k_choice is not None:
            check(torch.equal(k_choice, p_choice), f"{name}: integer case picks differ")
    else:
        check(torch.allclose(kv, pv, **TOL), f"{name}: values off by {err}")
        if k_choice is not None:
            frac = (k_choice != p_choice).float().mean().item()
            check(frac < 1e-3, f"{name}: {frac:.2e} of the picks differ")
    return err


def phase_k2():
    import torch
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk as kernel,
        binmax_partial_topk_plain as plain,
    )

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(4)
    b, n, nt, nbins = MAIN_B, N_ROWS + 777, N_ROWS + 333, 512
    out = {"max_abs_err": 0.0}
    for integer in (True, False):
        q = _values(g, integer, b, DIM)
        db = _values(g, integer, n, DIM, dtype=torch.bfloat16)
        db[nbins + 5] = db[5]  # a tie: the earlier row keeps the bin
        kv, ki = kernel(q, db, nbins=nbins, ntotal=nt)
        pv, pi = plain(q, db, nbins=nbins, ntotal=nt)
        torch.cuda.synchronize()
        err = _hold("K2", integer, kv, pv, ki, pi)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if not integer:
            out["ms"] = cuda_ms(lambda: kernel(q, db, nbins=nbins, ntotal=nt), 20)
            out["plain_ms"] = cuda_ms(lambda: plain(q, db, nbins=nbins, ntotal=nt), 3)
            # bf16 rows below ntotal, f32 queries, (value, row) per bin
            out.update(bound(nt * DIM * 2 + b * DIM * 4 + b * nbins * 8,
                             2 * b * nt * DIM, "bf16"))
            out["library_ms"] = None  # a positional bin max: no one call
        del q, db
    torch.cuda.empty_cache()
    phase("k2", t0, integer_bit_identical=True, max_abs_err=out["max_abs_err"],
          main_plain_ms=f"{out['plain_ms']:.4f}", **rate("main", out))
    return out


def flash_masks(b: int, t: int):
    """[B, T] int32 rows cycling through the four mask kinds: every token
    valid, the first 70%, one token, none."""
    import torch

    valid = torch.tensor([t, int(0.7 * t), 1, 0] * (b // 4 + 1), device=DEVICE)[:b]
    return (torch.arange(t, device=DEVICE)[None, :] < valid[:, None]).int()


def flash_floors():
    """(b, h, t, dh, dtype name) -> the kernel's CUDA-core floor in ms
    (tools/bench_flash.py: its main loop's FP32-pipe and MUFU instructions
    a score from the built library's SASS, at the SM clock nvidia-smi
    reports), or None where the count fails: a figure that never fails the
    phase."""
    from rag_inference_pipeline_tpu_torch.ops import _kernels
    from rag_inference_pipeline_tpu_torch.tools import bench_flash

    try:
        sass, clock = bench_flash.flash_sass(_kernels.build()), bench_flash.sm_clock_mhz()
    except (OSError, RuntimeError, ValueError, subprocess.SubprocessError) as err:
        print(f"[flash] no CUDA-core floor: {err!r}", flush=True)
        return lambda *case: None
    counts = {}

    def floor(b, h, t, dh, dtype_name):
        if (dtype_name, dh) not in counts:
            try:
                counts[dtype_name, dh] = bench_flash.per_score(sass, dtype_name, dh)
            except ValueError as err:
                print(f"[flash] no CUDA-core floor at {dtype_name} Dh {dh}: {err!r}",
                      flush=True)
                counts[dtype_name, dh] = None
        c = counts[dtype_name, dh]
        return None if c is None else bench_flash.cuda_core_floor_ms(
            b, h, t, c["fp32_per_score"], c["mufu_per_score"], clock)

    return floor


def phase_flash():
    """The encoder flash kernel against its plain version at every case of
    FLASH_CASES, with its time, the plain version's, SDPA's (and SDPA over
    the kernel), the bound and the CUDA-core floor; then bert_embed at
    bge-base width through it at FLASH_PATH_T (and once with int8 weights,
    once with f32 weights), 12 launches a forward, against the same forward
    through the plain version."""
    import torch
    import torch.nn.functional as F
    from rag_inference_pipeline_tpu_torch.models import bert as tbert
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa
    from rag_inference_pipeline_tpu_torch.tools import bench_flash

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(14)
    b, cases, main, main_f32 = FLASH_B, {}, None, None
    floors = flash_floors()
    for t, h, dh, dtype_name in FLASH_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn((b, t, h, dh), generator=g, device=DEVICE).to(dtype)
                   for _ in range(3))
        seg = flash_masks(b, t)
        out = fa.flash_encoder_attention(q, k, v, seg, seg)
        ref = fa.flash_encoder_attention_plain(q, k, v, seg, seg).float()
        torch.cuda.synchronize()
        err = (out.float() - ref).abs()
        atol, rtol = FLASH_TOL[dtype_name]
        check(bool((err <= atol + rtol * ref.abs()).all()),
              f"flash kernel differs from its plain version at T={t} H={h} Dh={dh} "
              f"{dtype_name}: max abs err {err.max().item():.3e}")
        m = {"max_abs_err": err.max().item(),
             "ms": cuda_ms(lambda: fa.flash_encoder_attention(q, k, v, seg, seg), 20),
             "plain_ms": cuda_ms(lambda: fa.flash_encoder_attention_plain(
                 q, k, v, seg, seg), 3)}
        # yardstick only: SDPA over [B, H, T, Dh] views with the boolean
        # segment-equality mask (every query sees itself, so no row is empty)
        allowed = seg[:, None, :, None] == seg[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        m["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed), 20)
        # f32: each product six bf16 products of the kernel's split
        products = bench_flash.F32_PRODUCTS if dtype == torch.float32 else 1
        m.update(bound(4 * b * t * h * dh * q.element_size() + 2 * b * t * 4,
                       4.0 * b * h * t * t * dh * products, "bf16"))
        name = f"t{t}_h{h}_d{dh}_{dtype_name}"
        floor = floors(b, h, t, dh, dtype_name)
        cases[name] = {"max_abs_err": m["max_abs_err"], "ms": round(m["ms"], 5),
                       "plain_ms": round(m["plain_ms"], 3),
                       "library_ms": round(m["library_ms"], 5),
                       "library_over_kernel": round(m["library_ms"] / m["ms"], 3),
                       "bound_ms": round(m["bound_ms"], 5),
                       "of_bound": round(m["bound_ms"] / m["ms"], 3),
                       "bound_by": m["bound_by"],
                       "cuda_core_floor_ms": None if floor is None else round(floor, 5)}
        if main is None:  # bge-base heads, bf16, the gate's first length
            main = m
        if dtype == torch.float32:  # the f32 kernel's line: bge-base heads, T 1024
            main_f32 = m
        del q, k, v, out, ref, err, allowed, qt, kt, vt
        torch.cuda.empty_cache()

    # the path: bert_embed at bge-base width (random seeded bf16 weights,
    # their int8 tree, and f32 weights), max_positions 2048, through
    # encoder_attention's flash branch
    cfg = tbert.BertConfig(max_positions=max(FLASH_PATH_T))
    params = tbert.init_bert_params(cfg, generator=g, dtype=torch.bfloat16, device=DEVICE)
    qparams = tbert.quantize_bert_params(params)
    inputs = {}
    for t in FLASH_PATH_T:
        mask = flash_masks(b, t)
        ids = torch.randint(1, cfg.vocab_size, (b, t), generator=g, device=DEVICE)
        inputs[t] = (ids * mask, mask)
    f32params = tbert.init_bert_params(cfg, generator=g, dtype=torch.float32, device=DEVICE)
    t_int8 = FLASH_PATH_T[0]
    runs = [(f"t{t}", params, t) for t in FLASH_PATH_T] + [
        (f"int8_t{t_int8}", qparams, t_int8), (f"f32_t{t_int8}", f32params, t_int8)]
    embs, per_forward = {}, {}
    zero_launches()
    with torch.inference_mode():
        for name, p, t in runs:
            before = fa.flash_encoder_attention.launches
            embs[name] = tbert.bert_embed(p, cfg, *inputs[t])
            torch.cuda.synchronize()
            per_forward[name] = fa.flash_encoder_attention.launches - before
    launches = fa.flash_encoder_attention.launches
    check(all(n == cfg.layers for n in per_forward.values()),
          f"flash launches a forward {per_forward}, not {cfg.layers}")
    stats = {"launches": launches}
    flash_attn = tbert.encoder_attention
    try:  # the same forwards with the plain version in the kernel's place
        tbert.encoder_attention = (
            lambda q, k, v, m: fa.flash_encoder_attention_plain(q, k, v, m, m))
        with torch.inference_mode():
            for name, p, t in runs:
                ref = tbert.bert_embed(p, cfg, *inputs[t])
                err = (embs[name] - ref).abs().max().item()
                cos = F.cosine_similarity(embs[name], ref, dim=-1).min().item()
                check(bool(torch.isfinite(embs[name]).all()) and cos >= FLASH_PATH_MIN_COS,
                      f"bert_embed {name} through the kernel: min cosine {cos:.6f} "
                      f"to the plain version's")
                stats[f"{name}_max_abs_err"] = f"{err:.3e}"
                stats[f"{name}_min_cos"] = f"{cos:.6f}"
    finally:
        tbert.encoder_attention = flash_attn
    with torch.inference_mode():
        for name, p, t in runs:
            ms = cuda_ms(lambda: tbert.bert_embed(p, cfg, *inputs[t]), 3)
            stats[f"{name}_forward_ms"] = f"{ms:.3f}"
    del params, qparams, f32params, inputs, embs
    gc.collect()
    torch.cuda.empty_cache()
    phase("flash", t0, launches_per_forward=cfg.layers, **stats,
          cases=json.dumps(cases, separators=(",", ":")))
    main_f32["launches"] = per_forward[f"f32_t{t_int8}"]
    main["launches"] = launches - main_f32["launches"]
    return main, main_f32


# the int8 path's products (Qwen2.5-0.5B: H 896, kv 2 x 64, I 4,864, V
# 151,936; BERT-base: H 768, I 3,072): name, M, K, the N of each weight
# sharing x, a bias on each; the head's output is f32, every other one bf16
W8A8_SHAPES = [
    ("decode_qkv", 8, 896, (896, 128, 128), True), ("decode_qo_b1", 1, 896, (896,), True),
    ("decode_o", 8, 896, (896,), False), ("decode_gate_up", 8, 896, (4864, 4864), False),
    ("decode_down", 8, 4864, (896,), False), ("decode_head_b1", 1, 896, (151936,), False),
    ("decode_head", 8, 896, (151936,), False), ("verify_qo", 72, 896, (896,), True),
    ("verify_qkv", 72, 896, (896, 128, 128), True),
    ("verify_gate_up", 72, 896, (4864, 4864), False), ("verify_down", 72, 4864, (896,), False),
    ("verify_head", 72, 896, (151936,), False),
    ("engine_qkv", 288, 896, (896, 128, 128), True), ("engine_down", 288, 4864, (896,), False),
    ("prefill_b1_qkv", 128, 896, (896, 128, 128), True),
    ("prefill_b1_down", 128, 4864, (896,), False),
    ("prefill_qkv", 4096, 896, (896, 128, 128), True),
    ("prefill_gate_up", 4096, 896, (4864, 4864), False),
    ("prefill_down", 4096, 4864, (896,), False),
    ("encoder_ffn_in", 4096, 768, (3072,), True), ("classifier", 8, 768, (5,), True),
    # the engine's step at 32 lanes
    ("lanes32_qkv", 32, 896, (896, 128, 128), True), ("lanes32_o", 32, 896, (896,), False),
    ("lanes32_gate_up", 32, 896, (4864, 4864), False),
    ("lanes32_down", 32, 4864, (896,), False), ("lanes32_head", 32, 896, (151936,), False),
    # Llama-3.1-8B (H 4,096, kv 8 x 128, I 14,336, an untied 128,256-row
    # head; no biases): its decode step at 8 lanes (the head at 1 too), a
    # verify round's 72 rows, a prefill of 8 x 512 tokens, the engine's
    # step at 32 lanes and its verify round (32 x 9 rows); Llama-3.2-1B
    # (H 2,048, kv 8 x 64, I 8,192, a tied head): its decode step at 8
    # lanes and its prefill of 8 x 512 tokens
    ("l8b_decode_qkv", 8, 4096, (4096, 1024, 1024), False),
    ("l8b_decode_o", 8, 4096, (4096,), False),
    ("l8b_decode_gate_up", 8, 4096, (14336, 14336), False),
    ("l8b_decode_down", 8, 14336, (4096,), False),
    ("l8b_decode_head", 8, 4096, (128256,), False),
    ("l8b_decode_head_b1", 1, 4096, (128256,), False),
    ("l8b_verify_qkv", 72, 4096, (4096, 1024, 1024), False),
    ("l8b_verify_o", 72, 4096, (4096,), False),
    ("l8b_verify_gate_up", 72, 4096, (14336, 14336), False),
    ("l8b_verify_down", 72, 14336, (4096,), False),
    ("l8b_verify_head", 72, 4096, (128256,), False),
    ("l8b_prefill_gate_up", 4096, 4096, (14336, 14336), False),
    ("l8b_prefill_down", 4096, 14336, (4096,), False),
    ("l8b_engine_qkv", 32, 4096, (4096, 1024, 1024), False),
    ("l8b_engine_o", 32, 4096, (4096,), False),
    ("l8b_engine_gate_up", 32, 4096, (14336, 14336), False),
    ("l8b_engine_down", 32, 14336, (4096,), False),
    ("l8b_engine_head", 32, 4096, (128256,), False),
    ("l8b_engine_verify_qkv", 288, 4096, (4096, 1024, 1024), False),
    ("l8b_engine_verify_down", 288, 14336, (4096,), False),
    ("l1b_decode_qkv", 8, 2048, (2048, 512, 512), False),
    ("l1b_decode_o", 8, 2048, (2048,), False),
    ("l1b_decode_gate_up", 8, 2048, (8192, 8192), False),
    ("l1b_decode_down", 8, 8192, (2048,), False),
    ("l1b_decode_head", 8, 2048, (128256,), False),
    ("l1b_prefill_qkv", 4096, 2048, (2048, 512, 512), False),
    ("l1b_prefill_o", 4096, 2048, (2048,), False),
    ("l1b_prefill_gate_up", 4096, 2048, (8192, 8192), False),
    ("l1b_prefill_down", 4096, 8192, (2048,), False),
]
# the kernels line's shape of each kernel: the decode step's gate/up group
# on the short-K kernel (24 launches a step), Llama-3.1-8B's decode down on
# the streaming small-row kernel, the prefill's down on the wgmma GEMM's wide plan and
# the prefill's gate/up activation quantize, the verify round's o on its
# 64 x 64 tiles; Llama-3.1-8B's shapes on the wgmma GEMM's other plan
# kinds: the prefill's gate/up group in bands of column tiles, the engine's
# verify down on a weight tile shared by its row tiles, the verify round's
# down on 128-column tiles with K split over a cluster; the s32 kind's at
# tp = 2: decode o on the short-K kernel, decode down on the streaming one,
# prefill down on the wgmma route
W8A8_MAIN = {"short": "decode_gate_up", "small": "l8b_decode_down",
             "wgmma": "prefill_down",
             "quant": "prefill_gate_up", "few_tiles": "verify_qo",
             "bands": "l8b_prefill_gate_up", "shared": "l8b_engine_verify_down",
             "few_rows": "l8b_verify_down",
             "short_s32": "decode_o_tp2", "small_s32": "decode_down_tp2",
             "wgmma_s32": "prefill_down_tp2"}
# the plan kind (ops/w8a8.py::_plan_kind) each W8A8_MAIN shape of the wgmma
# GEMM must take
W8A8_MAIN_KINDS = {"wgmma": "wide", "few_tiles": "few_tiles", "bands": "bands",
                   "shared": "shared", "few_rows": "few_rows"}
# `quantize_rows` on its long-row kernel at Llama-3.1-8B's down (K 14,336):
# the engine step's 32 rows, a verify round's 72, the engine's verify
# round's 288 and a prefill's 4,096 in bf16; 72 and 4,096 rows in f32 (the
# int8 speculation hold's activations); the kernels line's is the prefill's
W8A8_LONG_K = 14336
W8A8_LONG_ROWS = [(32, "bfloat16"), (72, "bfloat16"), (288, "bfloat16"),
                  (4096, "bfloat16"), (72, "float32"), (4096, "float32")]
W8A8_LONG_MAIN = (4096, "bfloat16")
# the row-parallel products of Qwen2.5-0.5B at tp = 2 (each shard's columns
# of the int8 rows by its weight rows, exact s32): name, M, K/tp, N
W8A8_TP_SHAPES = [("decode_o_tp2", 8, 448, 896), ("decode_down_tp2", 8, 2432, 896),
                  ("verify_down_tp2", 72, 2432, 896), ("prefill_down_tp2", 4096, 2432, 896)]


def _w8a8_weights(g, k, ns, has_bias, out_dtype):
    import torch

    weights = [(torch.randint(-127, 128, (n, k), generator=g, device=DEVICE,
                              dtype=torch.int8),
                torch.rand(n, generator=g, device=DEVICE) * 1e-3) for n in ns]
    biases = [torch.randn(n, generator=g, device=DEVICE).to(out_dtype) if has_bias else None
              for n in ns]
    return weights, biases


def phase_w8a8():
    """The small-row, wgmma and quantize kernels against their plain
    versions, bit for bit, on ragged cases and at the int8 path's shapes on
    the route each takes, with times, bounds and `torch._int_mm`."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(23)
    cases = 0
    # ragged: tails in M, N and K, 4-byte copies at K = 36, m tiles of 8 to
    # 64 rows and several of them, 1 to 3 row tiles of the wgmma GEMM
    for m in sorted({1, 5, 17, w8a8.M_STAR, w8a8.M_STAR + 1, 64, 65, 72, 300}):
        for k in (36, 896, 4864):
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn(m, k, generator=g, device=DEVICE) * 3).to(dtype)
                q, sc = w8a8.quantize_rows(x)
                pq, ps = w8a8.quantize_rows_plain(x)
                check(torch.equal(q, pq) and torch.equal(sc, ps),
                      f"quantize_rows differs from its plain version at {m}x{k} {dtype}")
                weights, _ = _w8a8_weights(g, k, (3, 128), False, dtype)
                biases = [torch.randn(n, generator=g, device=DEVICE).to(dtype)
                          for n in (3, 128)]
                for bs in (None, biases):
                    want = w8a8.w8a8_dense_plain(x, weights, bs, out_dtype=dtype)
                    got = w8a8.w8a8_qgemm(x, weights, bs, out_dtype=dtype)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"the small-row kernel differs from its plain version at M={m} "
                          f"K={k} {dtype} bias={bs is not None}")
                    cases += 1
                    if k % 16 == 0:
                        for (wq, ws), b, w in zip(weights, bs or (None, None), want):
                            got = w8a8.w8a8_gemm(q, sc, wq, ws, b, out_dtype=dtype)
                            check(torch.equal(got, w), f"the wgmma GEMM differs from its "
                                  f"plain version at M={m} N={wq.shape[0]} K={k} {dtype}")
                            cases += 1
    rows, out, host = {}, {}, {}
    for name, m, k, ns, has_bias in W8A8_SHAPES:
        out_dtype = torch.float32 if "head" in name else torch.bfloat16
        x = torch.randn(m, k, generator=g, device=DEVICE).to(torch.bfloat16)
        weights, biases = _w8a8_weights(g, k, ns, has_bias, out_dtype)
        route = w8a8._route(m, k, True)
        big = m * sum(ns) * k > 1e10
        it, pit = (20, 3) if big else (100, 20)
        q, sc = w8a8.quantize_rows_plain(x)
        want = w8a8.w8a8_dense_plain(x, weights, biases, out_dtype=out_dtype)
        got = w8a8.w8a8_dense(x, weights, biases, out_dtype=out_dtype)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"w8a8_dense differs from its plain version at {name}")
        esz = 4 if out_dtype == torch.float32 else 2
        nbytes = sum(n * k + 4 * n + m * n * esz + (n * esz if has_bias else 0) for n in ns)
        ops = 2.0 * m * k * sum(ns)
        row = {"route": route}
        if route == "qgemm":
            km = {"ms": graph_ms(lambda: w8a8.w8a8_qgemm(x, weights, biases,
                                                         out_dtype=out_dtype), it),
                  "plain_ms": cuda_ms(lambda: w8a8.w8a8_dense_plain(
                      x, weights, biases, out_dtype=out_dtype), pit),
                  "max_abs_err": 0.0,
                  # yardstick only, where _int_mm takes the rows: the
                  # quantize, then the library's s8 GEMM a weight
                  "library_ms": graph_ms(lambda: [
                      torch._int_mm(q8, w.t()) for q8 in (w8a8.quantize_rows(x)[0],)
                      for w, _ in weights], it) if m > 16 else None}
            km.update(bound(m * k * 2 + nbytes, ops, "int8"))
            short = w8a8._qgemm_short(k, ns)
            plan = (w8a8._qshort_plan if short else w8a8._qgemm_plan)(m, k, ns, w8a8._sms(0))
            row.update({"small_ms": round(km["ms"], 5), "small_bound_ms": round(km["bound_ms"], 5),
                        "small_of_bound": round(km["bound_ms"] / km["ms"], 3),
                        "small_plain_ms": round(km["plain_ms"], 4),
                        "small_kernel": "short_k" if short else "streaming",
                        "small_plan": [int(v) for v in plan]})
            if km["library_ms"] is not None:
                row["small_int_mm_ms"] = round(km["library_ms"], 5)
            key = "short" if short else "small"
            if name == W8A8_MAIN[key]:
                out[key] = km
        else:
            xq, xs = w8a8.quantize_rows(x)
            check(torch.equal(xq, q) and torch.equal(xs, sc),
                  f"quantize_rows differs from its plain version at {name}")
            (wq, ws), b = weights[0], biases[0]
            check(torch.equal(w8a8.w8a8_gemm(xq, xs, wq, ws, b, out_dtype=out_dtype), want[0]),
                  f"the wgmma GEMM differs from its plain version at {name}")
            group = w8a8._gemm_launch(xq, xs, weights, biases, out_dtype)
            check(all(torch.equal(a, b) for a, b in zip(group, want)),
                  f"the wgmma GEMM's launch for the group differs from its plain version "
                  f"at {name}")
            n = ns[0]
            gm = {"ms": graph_ms(lambda: w8a8.w8a8_gemm(xq, xs, wq, ws, b,
                                                        out_dtype=out_dtype), it),
                  "plain_ms": cuda_ms(lambda: w8a8.w8a8_gemm_plain(xq, xs, wq, ws, b,
                                                                   out_dtype=out_dtype), pit),
                  "max_abs_err": 0.0,
                  # yardstick only: the library's s8 GEMM (int32 out, no epilogue)
                  "library_ms": graph_ms(lambda: torch._int_mm(xq, wq.t()), it)}
            gm.update(bound(m * k + 4 * m + n * k + 4 * n + m * n * esz
                            + (n * esz if has_bias else 0), 2.0 * m * n * k, "int8"))
            qm = {"ms": graph_ms(lambda: w8a8.quantize_rows(x), it),
                  "plain_ms": cuda_ms(lambda: w8a8.quantize_rows_plain(x), pit),
                  "max_abs_err": 0.0, "library_ms": None}
            qm.update(bound(2 * m * k + m * k + 4 * m, 0, "int8"))
            plan = w8a8._gemm_plan(m, k, ns, w8a8._sms(0))
            kind = w8a8._plan_kind(plan, ns)
            row.update({"plan": [int(v) for v in plan[:6]], "plan_kind": kind,
                        "wgmma_us": round(gm["ms"] * 1e3, 3),
                        "wgmma_bound_us": round(gm["bound_ms"] * 1e3, 3),
                        "wgmma_of_bound": round(gm["bound_ms"] / gm["ms"], 3),
                        "wgmma_plain_ms": round(gm["plain_ms"], 4),
                        "int_mm_us": round(gm["library_ms"] * 1e3, 3),
                        "quant_us": round(qm["ms"] * 1e3, 3),
                        "quant_bound_us": round(qm["bound_ms"] * 1e3, 3),
                        "quant_of_bound": round(qm["bound_ms"] / qm["ms"], 3),
                        "quant_plain_ms": round(qm["plain_ms"], 4)})
            if len(ns) > 1:  # the group in one launch, beside _int_mm a weight
                gp = {"ms": graph_ms(lambda: w8a8._gemm_launch(xq, xs, weights, biases,
                                                               out_dtype), it),
                      "plain_ms": cuda_ms(lambda: [w8a8.w8a8_gemm_plain(
                          xq, xs, w, s, bb, out_dtype=out_dtype)
                          for (w, s), bb in zip(weights, biases)], pit)
                      if name == W8A8_MAIN["bands"] else None,
                      "max_abs_err": 0.0,
                      "library_ms": graph_ms(lambda: [
                          torch._int_mm(xq, w.t()) for w, _ in weights], it)}
                gp.update(bound(m * k + 4 * m + nbytes, ops, "int8"))
                row.update({"group_us": round(gp["ms"] * 1e3, 3),
                            "group_bound_us": round(gp["bound_ms"] * 1e3, 3),
                            "group_of_bound": round(gp["bound_ms"] / gp["ms"], 3),
                            "group_int_mm_us": round(gp["library_ms"] * 1e3, 3)})
            if name == W8A8_MAIN["quant"]:
                out["quant"] = qm
            for key, want_kind in W8A8_MAIN_KINDS.items():
                if name == W8A8_MAIN[key]:
                    check(kind == want_kind, f"{name} is not on the {want_kind} plan: {plan}")
                    out[key] = gp if len(ns) > 1 else gm
        # the product as the model runs it, on its route
        row["dense_ms"] = round(graph_ms(lambda: w8a8.w8a8_dense(
            x, weights, biases, out_dtype=out_dtype), it), 5)
        if name == "decode_qkv":  # the wrapper's host cost, eagerly
            host = {"dense_host_us": round(host_us(lambda: w8a8.w8a8_dense(
                x, weights, biases, out_dtype=out_dtype), 1000), 2)}
        rows[name] = row
        del x, weights, biases, q, sc, want, got
        torch.cuda.empty_cache()
    long_rows = {}
    for m, dtype in W8A8_LONG_ROWS:
        k, dt = W8A8_LONG_K, getattr(torch, dtype)
        x = (torch.randn(m, k, generator=g, device=DEVICE) * 3).to(dt)
        plan = w8a8._quant_plan(m, k, w8a8._IN_KINDS[dt], w8a8._sms(0))
        check(plan[0] == w8a8._Q_LONG, f"{m} x {k} {dtype} is not on the long-row "
              f"kernel: {plan}")
        q, sc = w8a8.quantize_rows(x)
        pq, ps = w8a8.quantize_rows_plain(x)
        check(torch.equal(q, pq) and torch.equal(sc, ps),
              f"quantize_rows' long-row kernel differs from its plain version at {m} x {k} "
              f"{dtype} on {plan}")
        it, pit = (20, 3) if m >= 4096 else (100, 20)
        km = {"ms": graph_ms(lambda: w8a8.quantize_rows(x), it),
              "plain_ms": cuda_ms(lambda: w8a8.quantize_rows_plain(x), pit),
              "max_abs_err": 0.0, "library_ms": None}
        km.update(bound(m * k * (dt.itemsize + 1) + 4 * m, 0, "int8"))
        long_rows[f"{dtype}_m{m}"] = {
            "plan": list(plan), "us": round(km["ms"] * 1e3, 3),
            "bound_us": round(km["bound_ms"] * 1e3, 3),
            "of_bound": round(km["bound_ms"] / km["ms"], 3),
            "plain_ms": round(km["plain_ms"], 4), "bit_identical": True}
        if (m, dtype) == W8A8_LONG_MAIN:
            out["quant_long"] = km
        del x, q, sc, pq, ps
    torch.cuda.empty_cache()
    # the s32 kind (a row-parallel shard's partial) on both routes, at
    # every row-parallel shape, bit for bit against its plain twin
    s32 = {}
    for name, m, k, n in W8A8_TP_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device=DEVICE, dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=g, device=DEVICE, dtype=torch.int8)
        want = w8a8.w8a8_acc_plain(xq, wq)
        calls = {"qgemm": lambda: w8a8._qgemm_launch(xq, [(wq, None)], [None],
                                                     torch.int32)[0],
                 "wgmma": lambda: w8a8._gemm_launch(xq, None, [(wq, None)], [None],
                                                    torch.int32)[0]}
        got = w8a8.w8a8_gemm_s32(xq, wq)
        check(torch.equal(got, want), f"the s32 product differs from its plain twin at {name}")
        row = {"route": w8a8._route(m, k, True),
               "plan": [int(v) for v in w8a8._gemm_plan(m, k, (n,), w8a8._sms(0))[:6]]}
        big = m > 1000
        it, pit = (20, 3) if big else (100, 20)
        plain_ms = cuda_ms(lambda: w8a8.w8a8_acc_plain(xq, wq), pit)
        library_ms = graph_ms(lambda: torch._int_mm(xq, wq.t()), it) if m > 16 else None
        b = bound(m * k + n * k + 4 * m * n, 2.0 * m * n * k, "int8")
        for route, fn in calls.items():
            check(torch.equal(fn(), want),
                  f"the s32 kind of the {route} kernel differs from its plain twin at {name}")
            km = {"ms": graph_ms(fn, it), "plain_ms": plain_ms, "max_abs_err": 0.0,
                  "library_ms": library_ms, **b}
            row.update({f"{route}_us": round(km["ms"] * 1e3, 3),
                        f"{route}_of_bound": round(km["bound_ms"] / km["ms"], 3)})
            key = ("wgmma" if route == "wgmma" else "short" if w8a8._qgemm_short(k, (n,))
                   else "small") + "_s32"
            if name == W8A8_MAIN[key]:
                out[key] = km
        row.update({"bound_us": round(b["bound_ms"] * 1e3, 3),
                    "plain_ms": round(plain_ms, 4),
                    "int_mm_us": None if library_ms is None else round(library_ms * 1e3, 3)})
        s32[name] = row
        del xq, wq, want, got
    torch.cuda.empty_cache()
    phase("w8a8", t0, bit_identical=True, ragged_cases=cases, m_star=w8a8.M_STAR,
          main=json.dumps(W8A8_MAIN, separators=(",", ":")), **host,
          shapes=json.dumps(rows, separators=(",", ":")),
          quant_long_rows=json.dumps(long_rows, separators=(",", ":")),
          s32_tp2=json.dumps(s32, separators=(",", ":")))
    return out


def clustered_corpus(g, n: int, d: int, n_clusters: int, spread: float):
    """Mixture-of-Gaussians unit rows, as scripts/ivf_recall_oracle.py::
    clustered_corpus(rel=True): `spread` is the relative noise norm, so a
    row's cosine to its cluster center is ~1/sqrt(1+spread^2)."""
    import torch

    centers = torch.randn(n_clusters, d, generator=g, device=DEVICE)
    centers /= centers.norm(dim=1, keepdim=True)
    which = torch.randint(0, n_clusters, (n,), generator=g, device=DEVICE)
    x = centers[which]
    x += (spread / d ** 0.5) * torch.randn(n, d, generator=g, device=DEVICE)
    x /= x.norm(dim=1, keepdim=True)
    return x


def ivf_documents():
    """The IVF corpus's documents: 48 words each, from a pool of 4096 word
    sequences, as (id, title, content) rows."""
    import numpy as np

    rng = np.random.default_rng(6)
    pool = [" ".join(f"w{w}" for w in rng.integers(0, 5000, DOC_LEN))
            for _ in range(4096)]
    return ((i, f"doc {i}", pool[i % 4096]) for i in range(N_ROWS))


def phase_ivf_build(workdir: str):
    import torch
    from rag_inference_pipeline_tpu_torch.index.base import load_index
    from rag_inference_pipeline_tpu_torch.index.ivf_flat import IVFFlatIndex
    from rag_inference_pipeline_tpu_torch.utils.docstore import build_sqlite_store

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(5)
    corpus = clustered_corpus(g, N_ROWS, DIM, IVF_CLUSTERS, IVF_SPREAD)
    rows = torch.randint(0, N_ROWS, (RETRIEVE_B,), generator=g, device=DEVICE)
    queries = corpus[rows] + QUERY_NOISE * torch.randn(
        RETRIEVE_B, DIM, generator=g, device=DEVICE)
    queries /= queries.norm(dim=1, keepdim=True)
    torch.cuda.synchronize()
    tb = time.perf_counter()
    ivf = IVFFlatIndex(DIM, NLIST, nprobe=NPROBE, device=torch.device(DEVICE))
    ivf.train_add(corpus)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    nlist, cap, _ = ivf._listing.buckets.shape
    ids = ivf._listing.ids
    check(int((ids >= 0).sum()) == N_ROWS, "IVF build lost or duplicated rows")
    td = time.perf_counter()
    db_path = os.path.join(workdir, "documents.db")
    build_sqlite_store(db_path, ivf_documents())
    docs_s = time.perf_counter() - td
    # .npz save/load parity on a smaller IVF built the same way
    ts = time.perf_counter()
    small = IVFFlatIndex(DIM, 256, nprobe=16, device=torch.device(DEVICE))
    small.train_add(corpus[:50_000], iters=5)
    path = os.path.join(workdir, "ivf_small.npz")
    small.save(path)
    back = load_index(path, torch.device(DEVICE))
    for a, b_ in zip(small._listing, back._listing):
        check(torch.equal(a, b_), "IVF .npz round trip changed the listing")
    s1, i1 = small.search(queries[:8], 10)
    s2, i2 = back.search(queries[:8], 10)
    check(torch.equal(i1, i2) and torch.equal(s1, s2), "reloaded IVF searches differ")
    roundtrip_s = time.perf_counter() - ts
    phase("ivf_build", t0, rows=N_ROWS, nlist=nlist, cap=cap,
          clusters=IVF_CLUSTERS, spread=IVF_SPREAD, build_s=f"{build_s:.3f}",
          imbalance=f"{ivf.imbalance:.4f}",
          bucket_gb=f"{ivf._listing.buckets.numel() * 2 / 1e9:.3f}",
          docs_s=f"{docs_s:.3f}", small_npz_roundtrip_s=f"{roundtrip_s:.3f}")
    return corpus, ivf, queries, db_path


def _k4_ragged(g) -> float:
    """K4 against its plain version on a small ragged listing, integer
    rows bit for bit: B=5, nprobe 3, D=36 (72-byte rows: 4-byte copies), a
    list of size 0, a full list, and a list probed twice (a tie between
    probes: the earlier slot wins)."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import ivf as ops

    nlist, cap, d, b = 16, 128, 36, 5
    sizes = torch.randint(1, cap, (nlist,), generator=g, device=DEVICE, dtype=torch.int32)
    sizes[:2] = torch.tensor([0, cap], device=DEVICE, dtype=torch.int32)
    filled = (torch.arange(cap, device=DEVICE)[None, :] < sizes[:, None])[:, :, None]
    buckets = _values(g, True, nlist, cap, d, dtype=torch.bfloat16) * filled
    q = _values(g, True, b, d, dtype=torch.bfloat16)
    probe = torch.randint(0, nlist, (b, 3), generator=g, device=DEVICE, dtype=torch.int32)
    probe[:, 1] = probe[:, 0]
    probe[0] = torch.tensor([0, 1, 1], device=DEVICE, dtype=torch.int32)
    args = (q, buckets, probe, sizes)
    kv, kw = ops.ivf_scan_partial(*args)
    pv, pw = ops.ivf_scan_partial_plain(*args)
    torch.cuda.synchronize()
    err = _hold("K4 ragged", True, kv, pv, kw, pw)
    check(not bool((kw[1:] == 1).any()) and not bool((kw[0] == 2).any()),
          "K4 ragged: a repeated list won from the later slot")
    return err


def phase_k45(ivf, queries):
    import torch
    from rag_inference_pipeline_tpu_torch.ops import ivf as ops

    t0 = time.perf_counter()
    lst = ivf._listing
    nlist, cap = lst.buckets.shape[:2]
    # K5's slots at B=8 (the main path) and B=32 (its widest served batch)
    k5_cases = {}
    for key, b in (("k5", MAIN_B), ("k5_b32", K5_WIDE_B)):
        probe = ops.coarse_probe(lst, queries[:b].contiguous(), NPROBE)
        k5_cases[key] = (b, ops.dedup_probes(probe, nlist, min(nlist, b * NPROBE))[0])
    probe64 = ops.coarse_probe(lst, queries, NPROBE)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    pos = torch.arange(cap, device=DEVICE)
    filled = (pos[None, :] < lst.list_sizes[:, None])[:, :, None]
    out = {key: {"max_abs_err": 0.0} for key in (*k5_cases, "k4")}
    for integer in (False, True):
        if integer:  # the same layout, integer-valued rows and queries
            buckets = _values(g, True, *lst.buckets.shape, dtype=torch.bfloat16) * filled
            qs = _values(g, True, RETRIEVE_B, DIM, dtype=torch.bfloat16)
        else:
            buckets, qs = lst.buckets, queries.to(torch.bfloat16)
        for key, (b, slots) in k5_cases.items():
            q5 = qs[:b].contiguous()
            args5 = (q5, buckets, slots, lst.list_sizes)
            kv = ops.ivf_dedup_scores(*args5)
            pv = ops.ivf_dedup_scores_plain(*args5)
            torch.cuda.synchronize()
            r = out[key]
            r["max_abs_err"] = max(r["max_abs_err"], _hold(f"K5 B={b}", integer, kv, pv))
            del kv, pv
            if not integer:
                r["ms"] = cuda_ms(lambda: ops.ivf_dedup_scores(*args5), 20)
                r["plain_ms"] = cuda_ms(lambda: ops.ivf_dedup_scores_plain(*args5), 3)
                # the yardstick: one batched matmul of the slot buckets,
                # gathered outside the timing, against the queries
                gathered = buckets[slots.long()]
                r["library_ms"] = cuda_ms(lambda: torch.matmul(gathered, q5.T), 20)
                del gathered
        args4 = (qs, buckets, probe64, lst.list_sizes)
        kv, kw = ops.ivf_scan_partial(*args4)
        pv, pw = ops.ivf_scan_partial_plain(*args4)
        torch.cuda.synchronize()
        out["k4"]["max_abs_err"] = max(out["k4"]["max_abs_err"], _hold("K4", integer, kv, pv, kw, pw))
        if not integer:
            out["k4"]["ms"] = cuda_ms(lambda: ops.ivf_scan_partial(*args4), 10)
            out["k4"]["plain_ms"] = cuda_ms(lambda: ops.ivf_scan_partial_plain(*args4), 2)
            out["k4"]["library_ms"] = None  # a positional max: no one call
        del buckets, kv, pv
    out["k4"]["ragged_err"] = _k4_ragged(g)
    sizes = lst.list_sizes.long()
    for key, (b, slots) in k5_cases.items():
        n_slots = slots.shape[0]
        filled5 = int(sizes[slots.long()].clamp(max=cap).sum())
        # K5: the unique slots' filled rows once, queries, [n_slots, B, cap] f32
        out[key].update(bound(filled5 * DIM * 2 + b * DIM * 2 + n_slots * b * cap * 4,
                              2 * b * DIM * filled5, "bf16"))
        z_tiles, _ = ops.dedup_query_tiles(b)
        out[key]["slots"] = n_slots
        # blocks that read rows, of the n_slots x ceil(cap / 128) x z grid
        out[key]["row_blocks"] = z_tiles * ops.dedup_filled_tiles(slots, lst.list_sizes, cap)
        out[key]["grid_blocks"] = z_tiles * n_slots * -(-cap // ops.K5_ROWS)
    # K4: the filled rows of the lists the batch probes, once; the products
    # of every (query, probed list) pair; (value, slot) per position
    filled4 = int(sizes[torch.unique(probe64.long())].sum())
    pairs4 = int(sizes[probe64.long()].sum())
    out["k4"].update(bound(filled4 * DIM * 2 + RETRIEVE_B * DIM * 2 + probe64.numel() * 4
                           + RETRIEVE_B * cap * 8, 2 * DIM * pairs4, "bf16"))
    out["k4"]["pair_gb"] = pairs4 * DIM * 2 / 1e9  # what the kernel reads
    torch.cuda.empty_cache()
    k5, w5, k4 = out["k5"], out["k5_b32"], out["k4"]
    phase("k45", t0, integer_bit_identical=True,
          k5_slots=k5["slots"], k5_ms=f"{k5['ms']:.4f}", k5_plain_ms=f"{k5['plain_ms']:.4f}",
          k5_matmul_ms=f"{k5['library_ms']:.4f}", k5_bound_ms=f"{k5['bound_ms']:.4f}",
          k5_row_blocks=f"{k5['row_blocks']}/{k5['grid_blocks']}", k5_err=k5["max_abs_err"],
          k5_b32_slots=w5["slots"], k5_b32_ms=f"{w5['ms']:.4f}",
          k5_b32_plain_ms=f"{w5['plain_ms']:.4f}", k5_b32_matmul_ms=f"{w5['library_ms']:.4f}",
          k5_b32_bound_ms=f"{w5['bound_ms']:.4f}",
          k5_b32_row_blocks=f"{w5['row_blocks']}/{w5['grid_blocks']}",
          k5_b32_err=w5["max_abs_err"],
          k4_ms=f"{k4['ms']:.4f}", k4_plain_ms=f"{k4['plain_ms']:.4f}",
          k4_bound_ms=f"{k4['bound_ms']:.4f}", k4_pair_gb=f"{k4['pair_gb']:.3f}",
          k4_pair_tb_per_s=f"{k4['pair_gb'] / k4['ms']:.3f}", k4_err=k4["max_abs_err"],
          k4_ragged_bit_identical=True)
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


def phase_serve(paths: dict, extra: dict | None = None, name: str = "serve",
                concurrent: int = 8):
    """A fused server on `paths` with `extra` settings: two /query, then
    `concurrent` at once; bodies, K1 and the W8A8 launches, warm-up."""
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.ops import w8a8
    from rag_inference_pipeline_tpu_torch.ops.topk import binmax_partial_topk_int8gs
    from rag_inference_pipeline_tpu_torch.serve import runtime

    t0 = time.perf_counter()
    settings = load_settings({**SERVE_ENV, **paths, **(extra or {})})
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
        graphs_before = health["decode_graphs"]
        queries = [f"what does the corpus say about topic {i}?" for i in range(2 + concurrent)]
        # warm-up launched the kernels too: the counts start after /health
        zero_launches()
        results = [_post(port, queries[0], "q0"), _post(port, queries[1], "q1")]
        conc = [None] * concurrent

        def ask(i):
            conc[i] = _post(port, queries[2 + i], f"q{2 + i}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(concurrent)]
        tc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a concurrent /query did not finish")
        conc_wall = time.perf_counter() - tc
        launches = binmax_partial_topk_int8gs.launches
        w8a8_launches = _w8a8_counts()
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
        f"concurrent{concurrent}_wall_s": round(conc_wall, 4),
        "k1_launches": launches,
        "w8a8_small_launches": w8a8_launches[0],
        "w8a8_wgmma_launches": w8a8_launches[1],
        "quantize_rows_launches": w8a8_launches[2],
        "w8a8_few_tile_launches": w8a8_launches[3],
        "quantize_rows_long_launches": w8a8_launches[4],
        "w8a8_bands_launches": w8a8_launches[5],
        "w8a8_shared_launches": w8a8_launches[6],
        "w8a8_few_rows_launches": w8a8_launches[7],
        "w8a8_short_launches": w8a8_launches[8],
        "llm_ladder": ",".join(map(str, health["llm_ladder"])),
    }
    ex = server.executor
    if settings.warmup_buckets:
        # the chunks pad to the LLM's ladder as /health reports it (a
        # prefix of the configured one), up to the bucket of the chunk lanes
        want = tuple(b for b in FUSED_WARM_BUCKETS if b <= max(health["llm_ladder"]))
        check(ex.warmed_buckets == want,
              f"warmed buckets {ex.warmed_buckets}, not {want} (/health's ladder "
              f"{health['llm_ladder']})")
        check(health["decode_graphs"]["count"] == graphs_before["count"],
              f"decode graphs captured after warm-up: {graphs_before} -> "
              f"{health['decode_graphs']}")
        stats.update({"warmup_s": round(ex.warmup_s, 3),
                      "warmed_buckets": ",".join(map(str, ex.warmed_buckets)),
                      "decode_graphs": health["decode_graphs"]["count"],
                      "graph_pool_mb": health["decode_graphs"]["pool_mb"]})
    phase(name, t0, **stats)
    return server.executor, launches, stats, [r[1] for r in results], health


def _step_inputs(executor):
    """The fused pipeline of `executor` and the token arrays of MAIN_B
    queries for one step of it."""
    from rag_inference_pipeline_tpu_torch.engine.fused_executor import pad_rows

    queries = [f"smoke query number {i} on retrieval" for i in range(MAIN_B)]
    qlen = executor._query_len()
    ids, mask = executor.embedder.tokenizer.encode_batch(queries, qlen)
    lm_ids, lm_mask = executor.llm.tokenizer.encode_batch(queries, qlen)
    return executor._get_pipe(), [pad_rows(a, MAIN_B) for a in (ids, mask, lm_ids, lm_mask)]


def phase_step(executor):
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.models.bert import bert_embed
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8gs_plain,
        exact_topk,
    )

    t0 = time.perf_counter()
    pipe, (ids, mask, lm_ids, lm_mask) = _step_inputs(executor)
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


def _hf(t):
    """A tree leaf as HF stores it: a linear weight [in, out] -> [out, in]."""
    return t.t() if t.dim() == 2 else t


def bert_to_hf(params, prefix: str) -> dict:
    """A BERT tree under HF names (the inverse of `bert_params_from_hf`):
    `prefix` (`bert.` for the published classifiers, none for BGE) on the
    backbone, the pooler as `pooler.dense`, the head as `classifier`."""
    from rag_inference_pipeline_tpu_torch.models.weights import BERT_EMBED_HF, BERT_LAYER_HF

    sd = params.state_dict()
    out = {f"{prefix}embeddings.{hf}": sd[f"embeddings.{k}"] for k, hf in BERT_EMBED_HF.items()}
    for i in range(len(params.layers)):
        for k, hf in BERT_LAYER_HF.items():
            out[f"{prefix}encoder.layer.{i}.{hf}"] = _hf(sd[f"layers.{i}.{k}"])
    out[f"{prefix}pooler.dense.weight"] = _hf(sd["pooler.w"])
    out[f"{prefix}pooler.dense.bias"] = sd["pooler.b"]
    if "classifier.w" in sd:
        out["classifier.weight"] = _hf(sd["classifier.w"])
        out["classifier.bias"] = sd["classifier.b"]
    return out


def qwen_to_hf(params) -> list[dict]:
    """A decoder tree under HF names (`model.` prefix, no `lm_head`: the
    head is tied), in two shards of layers as a sharded checkpoint ships:
    the inverse of `qwen_params_from_hf`."""
    from rag_inference_pipeline_tpu_torch.models.weights import QWEN_LAYER_HF

    sd = params.state_dict()
    n = len(params.layers)
    shards = [{"model.embed_tokens.weight": sd["embed"]},
              {"model.norm.weight": sd["final_ln"]}]
    for i in range(n):
        for k, hf in QWEN_LAYER_HF.items():
            if f"layers.{i}.{k}" in sd:
                shards[2 * i // n][f"model.layers.{i}.{hf}"] = _hf(sd[f"layers.{i}.{k}"])
    return shards


def _bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _trees_equal(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(_bits_equal(sa[k], sb[k]) for k in sa)


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


class RssPeak:
    """The process's resident set sampled every millisecond on a thread:
    `rise_mb` is its peak over its size at entry."""

    def __enter__(self) -> "RssPeak":
        self.base = self.peak = _rss_mb()
        self._done = threading.Event()
        self._th = threading.Thread(target=self._sample, daemon=True)
        self._th.start()
        return self

    def _sample(self) -> None:
        while not self._done.wait(0.001):
            self.peak = max(self.peak, _rss_mb())

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._th.join(timeout=10)
        self.peak = max(self.peak, _rss_mb())

    @property
    def rise_mb(self) -> float:
        return self.peak - self.base


def phase_checkpoint(executor, paths: dict, serve_bodies: list, workdir: str, smi: str):
    """The serve phase's own trees written as HF safetensors and served
    back through MODEL_WEIGHTS_DIR: the same leaves, the same answers."""
    import resource

    import torch
    from rag_inference_pipeline_tpu_torch.models.qwen import quantize_qwen_params
    from rag_inference_pipeline_tpu_torch.models.safetensors import (
        load_safetensors_dict,
        save_safetensors,
    )
    from rag_inference_pipeline_tpu_torch.models.weights import (
        bert_params_from_hf,
        qwen_params_from_hf,
    )

    t0 = time.perf_counter()
    wdir = os.path.join(workdir, "weights")
    ex = executor
    models = {  # component -> (the component, its HF files)
        "embedder": (ex.embedder, [bert_to_hf(ex.embedder.params, "")]),
        "llm": (ex.llm, qwen_to_hf(ex.llm.params)),
        "sentiment": (ex.sentiment, [bert_to_hf(ex.sentiment.params, "bert.")]),
        "toxicity": (ex.toxicity, [bert_to_hf(ex.toxicity.params, "bert.")]),
    }
    dirs, info = {}, {}
    t_w, written = time.perf_counter(), 0
    for name, (comp, shards) in models.items():
        d = dirs[name] = os.path.join(wdir, comp.model_name.replace("/", "__"))
        os.makedirs(d)
        for i, shard in enumerate(shards):
            fname = (f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
                     if len(shards) > 1 else "model.safetensors")
            written += save_safetensors(shard, os.path.join(d, fname))
    info["write_s"] = f"{time.perf_counter() - t_w:.3f}"
    info["written_gb"] = f"{written / 1e9:.3f}"
    check(ex.llm.params.embed.dtype == torch.bfloat16, "the served decoder is not bf16")

    # each model through the loader alone (its file in the page cache, just
    # written): seconds, bytes, rate, the rise of the host's RSS
    for name, (comp, _) in models.items():
        mapper = qwen_params_from_hf if name == "llm" else bert_params_from_hf
        torch.cuda.synchronize()
        tl = time.perf_counter()
        with RssPeak() as rss, load_safetensors_dict(dirs[name]) as raw:
            loaded = mapper(raw, comp.cfg, device=torch.device(DEVICE), dtype=torch.bfloat16)
            torch.cuda.synchronize()
            nbytes = raw.nbytes
        dt = time.perf_counter() - tl
        check(_trees_equal(loaded, comp.params), f"checkpoint: {name} leaves differ")
        del loaded
        info[f"{name}_load_s"] = f"{dt:.4f}"
        info[f"{name}_gb"] = f"{nbytes / 1e9:.3f}"
        info[f"{name}_gb_per_s"] = f"{nbytes / dt / 1e9:.3f}"
        info[f"{name}_rss_rise_mb"] = f"{rss.rise_mb:.1f}"

    # quantize-on-load on the card, against quantize_qwen_params of the
    # loaded bf16 tree; the device peak against the bf16 tree's size
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tl = time.perf_counter()
    with load_safetensors_dict(dirs["llm"]) as raw:
        q = qwen_params_from_hf(raw, ex.llm.cfg, device=torch.device(DEVICE),
                                dtype=torch.bfloat16, quantize=True)
        bf16_bytes = raw.nbytes
    torch.cuda.synchronize()
    info["int8_load_s"] = f"{time.perf_counter() - tl:.4f}"
    info["int8_load_peak_mb"] = f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f}"
    info["bf16_tree_mb"] = f"{bf16_bytes / 2**20:.1f}"
    check(_trees_equal(q, quantize_qwen_params(ex.llm.params)),
          "checkpoint: quantize-on-load differs from quantize_qwen_params")
    del q
    info["ru_maxrss_mb"] = f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.1f}"

    # the fused server from the checkpoints: no random weights, the same
    # leaves, the same answers, K1 launched (phase_serve checks the count)
    served, _, stats, bodies, health = phase_serve(
        paths, {"MODEL_WEIGHTS_DIR": wdir, "ALLOW_RANDOM_WEIGHTS": "0"}, "checkpoint_serve")
    check(health["random_weights"] == [], f"checkpoint: random weights {health}")
    for name, d in dirs.items():
        w = health["weights"][name]
        check(w == {"random_weights": False, "checkpoint_dir": d},
              f"checkpoint: /health says {name} loaded {w}")
        check(_trees_equal(getattr(served, name).params, models[name][0].params),
              f"checkpoint: the served {name} leaves differ from the source tree")
    check(bodies == serve_bodies, "checkpoint: /query answers differ from phase serve's")
    # random toxicity heads may filter every answer: hold the step's doc ids,
    # scores and generated tokens themselves
    pipe, args = _step_inputs(ex)
    pipe2, args2 = _step_inputs(served)
    a, b = pipe.step(*args), pipe2.step(*args2)
    check(all(_bits_equal(getattr(a, f), getattr(b, f))
              for f in ("doc_ids", "scores", "tokens")),
          "checkpoint: the fused step's ids, scores or tokens differ")
    del served, pipe2
    gc.collect()
    torch.cuda.empty_cache()
    phase("checkpoint", t0, leaves_bit_identical=True, responses_identical=True,
          step_bit_identical=True, int8_bit_identical=True, k1_launches=stats["k1_launches"],
          serve_load_s=stats["load_s"], second_s=stats["second_s"],
          card=f'"{smi}"', **info)


def _get_health(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
        return json.loads(r.read())


def _retrieve(port: int, queries) -> tuple[dict, float]:
    body = {"items": [{"embedding": q} for q in queries.float().cpu().tolist()]}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/retrieve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"/retrieve: HTTP {r.status}")
        return json.loads(r.read()), time.perf_counter() - t0


def _serve(env: dict, index):
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.serve import runtime

    server = runtime.make_server(load_settings(env), port=0, index=index)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    return server, th


def _stop(server, th) -> None:
    server.shutdown()
    server.server_close()
    th.join(timeout=60)
    check(not th.is_alive(), "the server thread did not stop")


def phase_serve_staged(ivf, corpus, queries, db_path: str):
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.ops.ivf import ivf_dedup_scores, ivf_scan_partial
    from rag_inference_pipeline_tpu_torch.ops.topk import exact_topk

    t0 = time.perf_counter()
    env = {**STAGED_ENV, "DOCUMENT_DB_PATH": db_path, "MAX_TOKENS": NODES_MAX_TOKENS}
    server, th = _serve(env, ivf)
    port = server.server_address[1]
    load_s = time.perf_counter() - t0
    try:
        health = _get_health(port)
        check(health["status"] == "ok", f"not loaded: {health}")
        check(health["profile"] == "single_node_full", f"profile {health['profile']}")
        zero_launches()
        texts = [f"what does the corpus say about topic {i}?" for i in range(10)]
        results = [_post(port, texts[0], "s0"), _post(port, texts[1], "s1")]
        conc = [None] * 8

        def ask(i):
            conc[i] = _post(port, texts[2 + i], f"s{2 + i}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        tc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a concurrent /query did not finish")
        conc_wall = time.perf_counter() - tc
        results += conc
        k5_query = ivf_dedup_scores.launches
        k4_query = ivf_scan_partial.launches
        mid = _get_health(port)["kernel_launches"]
        zero_launches()
        ret, retrieve_s = _retrieve(port, queries)
        k4_retrieve = ivf_scan_partial.launches
        end = _get_health(port)["kernel_launches"]
    finally:
        _stop(server, th)
    keys = {"request_id", "generated_response", "sentiment", "is_toxic"}
    for i, (status, body, _) in enumerate(results):
        check(status == 200, f"/query {i}: HTTP {status}")
        check(set(body) == keys, f"/query {i}: keys {sorted(body)}")
        check(body["request_id"] == f"s{i}", f"/query {i}: wrong request_id")
    check(k5_query >= 1 and k4_query == 0,
          f"/query ran K5 {k5_query} and K4 {k4_query} times")
    check(k4_retrieve >= 1, "the 64-item /retrieve did not run K4")
    check(mid["ivf_dedup"] == k5_query and end["ivf_scan"] == k4_retrieve,
          f"/health disagrees with the launch counts: {mid}, {end}")
    res = ret["results"]
    check(len(res) == RETRIEVE_B and all(len(r["ids"]) == 10 for r in res),
          "/retrieve: 64 results of 10 ids expected")
    check(all(len(r["documents"]) == 10 and r["documents"][0]["title"] == f"doc {r['ids'][0]}"
              for r in res), "/retrieve: documents do not match their ids")
    check(all(np.isfinite(r["scores"]).all() for r in res), "non-finite scores")
    with torch.inference_mode():
        _, exact = exact_topk(queries, corpus.to(torch.bfloat16), 10)
    ref = exact.cpu().numpy()
    recall = float(np.mean([len(set(r["ids"]) & set(e)) / 10 for r, e in zip(res, ref)]))
    check(recall >= RECALL_BAR, f"IVF recall@10 {recall:.4f} < {RECALL_BAR}")
    lat = sorted(r[2] for r in results)
    stats = {
        "requests": len(results), "load_s": round(load_s, 3),
        "first_s": round(results[0][2], 4), "second_s": round(results[1][2], 4),
        "p50_s": round(statistics.median(lat), 4), "max_s": round(lat[-1], 4),
        "concurrent8_wall_s": round(conc_wall, 4),
        "retrieve64_s": round(retrieve_s, 4), "recall_at_10": round(recall, 4),
        "k5_launches": k5_query, "k4_launches": k4_retrieve,
    }
    phase("serve_staged", t0, **stats)
    return {**stats, "bodies": [r[1] for r in results[:2]],
            "retrieve_ids": [r["ids"] for r in res]}


def _free_base(n: int = 3) -> int:
    """A base port with `n` consecutive ports free just now."""
    import random
    import socket

    for _ in range(100):
        base = random.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no three consecutive free ports")


def _post_json(port: int, path: str, body: dict) -> tuple[dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, f"{path}: HTTP {r.status}")
        return json.loads(r.read()), time.perf_counter() - t0


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _scrape(port: int) -> tuple[str, list]:
    """/metrics of a node: the text and its samples [(name, labels, value)]
    (the exposition format read without prometheus_client, which the card
    need not have)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        check(r.headers["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8",
              f"/metrics content type {r.headers['Content-Type']}")
        text = r.read().decode()
    samples = []
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m and not line.startswith("#"):
            samples.append((m[1], dict(_LABEL.findall(m[2] or "")), float(m[3])))
    return text, samples


def _total(samples, name: str, **labels) -> float:
    return sum(v for n, lab, v in samples
               if n == name and all(lab.get(k) == w for k, w in labels.items()))


def _trace_kernels(path: str) -> tuple[list, list]:
    """The kernel names in a torch.profiler Chrome trace: all of them, and
    those a replayed CUDA graph launched (correlated with a
    cudaGraphLaunch call)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    graph_calls = {e.get("args", {}).get("correlation") for e in events
                   if e.get("name") == "cudaGraphLaunch"}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return ([k["name"] for k in kernels],
            [k["name"] for k in kernels if k.get("args", {}).get("correlation") in graph_calls])


def _request(port: int, method: str, path: str, body=None, headers=None):
    """(status, headers, raw body) of one request; `body` a dict or the
    JSON bytes."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        conn.request(method, path, body=data, headers={
            **({"Content-Type": "application/json"} if data else {}), **(headers or {})})
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, resp.read()
    finally:
        conn.close()


def _wait_each(settings, nodes, t0: float, timeout_s: float) -> list:
    """Seconds from t0 until each node's /health first answers 200."""
    ready = [None] * len(nodes)
    while None in ready:
        for i, node in enumerate(nodes):
            if ready[i] is not None:
                continue
            check(node.proc.poll() is None,
                  f"node {node.number} exited ({node.proc.returncode}):\n{node.log_tail()}")
            try:
                with urllib.request.urlopen(
                        f"{settings.node_url(node.number)}/health", timeout=2.0) as r:
                    if r.status == 200:
                        ready[i] = time.perf_counter() - t0
            except OSError:
                pass  # not listening yet, or not loaded (503)
        check(time.perf_counter() - t0 < timeout_s, f"nodes not healthy within {timeout_s} s")
        time.sleep(0.2)
    return ready


def phase_serve_3node(ivf, queries, db_path: str, workdir: str, staged: dict):
    import base64
    import gzip

    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.tools import start_pipeline

    t0 = time.perf_counter()
    index_path = os.path.join(workdir, "ivf.npz")
    ivf.save(index_path)
    save_s = time.perf_counter() - t0
    base = _free_base()
    # the nodes take the serving default: WARMUP_BUCKETS unset is on
    env = {k: v for k, v in STAGED_ENV.items() if k != "WARMUP_BUCKETS"}
    env.update({"TOTAL_NODES": "3", "BASE_PORT": str(base), "MAX_TOKENS": NODES_MAX_TOKENS,
                "NODE_0_IP": "127.0.0.1", "NODE_1_IP": "127.0.0.1", "NODE_2_IP": "127.0.0.1",
                "INDEX_PATH": index_path, "INDEX_NPROBE": str(ivf.nprobe),
                "DOCUMENT_DB_PATH": db_path,
                "COMPRESSION_ALGORITHM": os.environ["COMPRESSION_ALGORITHM"]})
    settings = load_settings(env)
    gw, n1, n2 = base, base + 1, base + 2
    tl = time.perf_counter()
    nodes = start_pipeline.start_nodes(3, env, os.path.join(workdir, "nodes"))
    traces = []
    try:
        node_load_s = _wait_each(settings, nodes, tl, 600)
        load_s = time.perf_counter() - tl
        healths = [_get_health(base + n) for n in range(3)]
        for n, h in enumerate(healths):
            want = (n, ("gateway", "retrieval", "generation")[n],
                    ("gateway_default", "retrieval_default", "generation_default")[n])
            check((h["node"], h["role"], h["profile"]) == want, f"node {n}: {h}")
            check(h["status"] == "ok" and h["device"].startswith("cuda"), f"node {n}: {h}")
        # warm-up: {1, 2, 4, 8} (GENERATION_BATCH_SIZE=8) x prefill {128, 256, 512}
        graphs_before = healths[2]["decode_graphs"]
        check(graphs_before["count"] == 4 * 3, f"node 2 warmed {graphs_before}")
        before = healths[1]["kernel_launches"]
        texts = [f"what does the corpus say about topic {i}?" for i in range(10)]
        results = [_post(gw, texts[0], "s0"), _post(gw, texts[1], "s1")]
        conc = [None] * 8

        def ask(i):
            conc[i] = _post(gw, texts[2 + i], f"s{2 + i}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        tc = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a concurrent /query did not finish")
        conc_wall = time.perf_counter() - tc
        results += conc
        mid = _get_health(n1)["kernel_launches"]
        scraped = [_scrape(base + n) for n in range(3)]
        # a device trace on nodes 1 and 2 over one more /query
        tt = time.perf_counter()
        for port in (n1, n2):
            status, _, body = _request(port, "POST", "/profile/start")
            check(status == 200 and json.loads(body)["status"] == "tracing", f"{port}: {body}")
        check(_request(n2, "POST", "/profile/start")[0] == 409, "a second trace started")
        check(_post(gw, "what does the corpus say about tracing?", "t0")[0] == 200,
              "the traced /query failed")
        for port in (n1, n2):
            status, _, body = _request(port, "POST", "/profile/stop")
            check(status == 200, f"/profile/stop on {port}: {body}")
            traces.append(json.loads(body)["trace"])
        check(_request(n2, "POST", "/profile/stop")[0] == 409, "a stop with no trace")
        trace_s = time.perf_counter() - tt
        graphs_after = _get_health(n2)["decode_graphs"]
        rows = queries.float().cpu().numpy().astype("<f4")
        b64 = {"embeddings_b64": base64.b64encode(rows.tobytes()).decode()}
        ret, retrieve_s = _post_json(n1, "/retrieve", b64)
        end = _get_health(n1)["kernel_launches"]
        # the reference's outer middleware: a CORS preflight, gzip
        status, pre, _ = _request(gw, "OPTIONS", "/query", headers={
            "Origin": "https://ui.example", "Access-Control-Request-Method": "POST"})
        status_gz, gz_h, gz = _request(n1, "POST", "/retrieve", b64, {"Accept-Encoding": "gzip"})
        cleared, _ = _post_json(gw, "/clear_cache", {})
        for node in nodes:
            check(node.proc.poll() is None,
                  f"node {node.number} died ({node.proc.returncode}):\n{node.log_tail()}")
    finally:
        ts = time.perf_counter()
        codes = start_pipeline.stop_nodes(nodes, 60)
        stop_s = time.perf_counter() - ts
        os.remove(index_path)
    for node, code in zip(nodes, codes):
        check(code == 0, f"node {node.number} exited with {code}:\n{node.log_tail()}")
    keys = {"request_id", "generated_response", "sentiment", "is_toxic"}
    for i, (status_q, body, _) in enumerate(results):
        check(status_q == 200, f"/query {i}: HTTP {status_q}")
        check(set(body) == keys, f"/query {i}: keys {sorted(body)}")
        check(body["request_id"] == f"s{i}", f"/query {i}: wrong request_id")
    for i, want in enumerate(staged["bodies"]):
        got = results[i][1]
        if json.dumps(got) != json.dumps(want):
            print(f"[serve_3node] /query {i} three nodes: {json.dumps(got)}", flush=True)
            print(f"[serve_3node] /query {i} serve_staged: {json.dumps(want)}", flush=True)
            check(False, f"/query {i}: the three nodes answer otherwise than serve_staged")
    check(graphs_after == graphs_before,
          f"node 2 captured decode graphs after warm-up: {graphs_before} -> {graphs_after}")
    k5 = mid["ivf_dedup"] - before["ivf_dedup"]
    k4_query = mid["ivf_scan"] - before["ivf_scan"]
    k4 = end["ivf_scan"] - mid["ivf_scan"]
    check(k5 >= 1 and k4_query == 0, f"node 1: /query ran K5 {k5} and K4 {k4_query} times")
    check(k4 >= 1, "node 1: the 64-item /retrieve did not run K4")
    res = ret["results"]
    check([r["ids"] for r in res] == staged["retrieve_ids"],
          "node 1: /retrieve ids differ from serve_staged's")
    check(all(r["documents"][0]["title"] == f"doc {r['ids'][0]}" for r in res),
          "node 1: /retrieve documents do not match their ids")
    check(cleared == {"cleared": ["query"],
                      "cascade": {"retrieval": True, "generation": True}},
          f"/clear_cache: {cleared}")
    # /metrics after the 10 /query
    for n, (text, _) in enumerate(scraped):
        for name in METRIC_NAMES:
            check(f"# HELP {name} " in text and f"# TYPE {name} " in text,
                  f"node {n}: /metrics lacks {name}")
    gw_s, n1_s, n2_s = (smp for _, smp in scraped)
    ok = _total(gw_s, "pipeline_requests_total", node="0", service="gateway", status="ok")
    check(ok == len(results), f"gateway counted {ok} ok requests of {len(results)}")
    for target in ("retrieval", "generation"):
        check(_total(gw_s, "pipeline_rpc_duration_seconds_count", target=target) >= 1,
              f"gateway: no RPC timed to {target}")
    breakdown = {}
    for node, smp, service, stages in (
            (1, n1_s, "retrieval", ("embed", "search", "fetch")),
            (2, n2_s, "generation", ("rerank", "llm", "sentiment", "toxicity"))):
        for stage in stages:
            lab = dict(node=str(node), service=service, stage=stage)
            count = _total(smp, "pipeline_stage_duration_seconds_count", **lab)
            check(count >= 1, f"node {node}: no {stage} stage timed")
            breakdown[f"{service}/{stage}"] = {
                "count": count,
                "sum_s": round(_total(smp, "pipeline_stage_duration_seconds_sum", **lab), 4)}
    rpc = {t: {"count": _total(gw_s, "pipeline_rpc_duration_seconds_count", target=t),
               "sum_s": round(_total(gw_s, "pipeline_rpc_duration_seconds_sum", target=t), 4)}
           for t in ("retrieval", "generation")}
    print(f"[serve_3node] stages {json.dumps({'stages': breakdown, 'rpc': rpc})}", flush=True)
    # the device traces
    tr = time.perf_counter()
    (n1_all, _), (n2_all, n2_graph) = (_trace_kernels(p) for p in traces)
    trace_read_s = time.perf_counter() - tr
    for p in traces:
        os.remove(p)
    check(any("ivf_dedup" in k for k in n1_all),
          f"node 1's trace names no K5 kernel: {sorted(set(n1_all))[:10]}")
    check(len(n2_graph) >= 1, "node 2's trace names no kernel of a replayed decode "
          f"graph: {sorted(set(n2_all))[:10]}")
    top = statistics.multimode(n2_graph)[0][:60] if n2_graph else ""
    # CORS and gzip
    check(status == 204 and pre.get("access-control-allow-origin") == "https://ui.example"
          and pre.get("vary") == "Origin", f"preflight: {status} {pre}")
    check(status_gz == 200 and gz_h.get("content-encoding") == "gzip"
          and json.loads(gzip.decompress(gz)) == ret, "/retrieve with gzip")
    lat = sorted(r[2] for r in results)
    stats = {
        "nodes": 3, "compression": env["COMPRESSION_ALGORITHM"],
        "save_s": round(save_s, 3), "load_s": round(load_s, 3),
        "node_load_s": ",".join(f"{x:.3f}" for x in node_load_s),
        "first_s": round(results[0][2], 4), "second_s": round(results[1][2], 4),
        "p50_s": round(statistics.median(lat), 4), "max_s": round(lat[-1], 4),
        "concurrent8_wall_s": round(conc_wall, 4), "retrieve64_s": round(retrieve_s, 4),
        "stop_s": round(stop_s, 3), "k5_launches": k5, "k4_launches": k4,
        "decode_graphs": graphs_after["count"], "graph_pool_mb": graphs_after["pool_mb"],
        "trace_s": round(trace_s, 3), "trace_read_s": round(trace_read_s, 3),
        "trace_kernels_n1": len(n1_all), "trace_kernels_n2": len(n2_all),
        "trace_graph_kernels_n2": len(n2_graph), "trace_top_graph_kernel": repr(top),
        "gzip_bytes": len(gz), "bodies_identical": True, "retrieve_ids_identical": True,
    }
    stats.update({f"staged_{k}": staged[k] for k in (
        "load_s", "first_s", "second_s", "p50_s", "concurrent8_wall_s", "retrieve64_s")})
    phase("serve_3node", t0, **stats)
    return stats


def phase_retrieve_flat(corpus, queries, db_path: str):
    import torch
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk,
        binmax_partial_topk_plain,
        fused_topk,
    )

    t0 = time.perf_counter()
    flat = FlatIndex(DIM, dtype="bfloat16", device=torch.device(DEVICE))
    flat.add(corpus)
    env = {**STAGED_ENV, "DOCUMENT_DB_PATH": db_path, "INDEX_KIND": "flat",
           "PIPELINE_ROLE_PROFILE": "retrieval_default"}
    server, th = _serve(env, flat)
    port = server.server_address[1]
    q8 = queries[:MAIN_B]
    try:
        check(_get_health(port)["profile"] == "retrieval_default", "profile")
        zero_launches()
        ret, retrieve_s = _retrieve(port, q8)
        launches = binmax_partial_topk.launches
    finally:
        _stop(server, th)
    check(launches >= 1, "/retrieve over the flat bf16 index did not run K2")
    ps, pi = fused_topk(q8, flat._db, 10, nbins=flat.nbins, ntotal=flat.ntotal,
                        scan=binmax_partial_topk_plain)
    got = torch.tensor([r["ids"] for r in ret["results"]], device=DEVICE)
    got_s = torch.tensor([r["scores"] for r in ret["results"]], device=DEVICE)
    differ = got != pi
    # the kernel sums in another order than the plain scan: a query's ids
    # may differ only by one swapped pair of neighbouring ranks, or at the
    # last rank, and only where the candidates tie within the tolerance by
    # their exact (float64) scores over the bf16 values
    check(torch.allclose(got_s, ps, **TOL), "K2 route: scores differ from the plain scan")
    k = got.shape[1]
    for b in range(got.shape[0]):
        at = differ[b].nonzero().flatten().tolist()
        swap = (len(at) == 2 and at[1] == at[0] + 1
                and got[b, at[0]] == pi[b, at[1]] and got[b, at[1]] == pi[b, at[0]])
        check(not at or swap or at == [k - 1],
              f"K2 route: query {b}'s ids differ at ranks {at}, not one swapped pair")
    qd = q8.to(torch.bfloat16).double()[:, None, :]

    def exact(ids):
        return (flat._db[ids.long()].double() * qd).sum(-1)

    gaps = (exact(got) - exact(pi)).abs()[differ].tolist()
    check(all(g <= TOL["atol"] for g in gaps),
          f"K2 route: ids differ from the plain scan beyond a near-tie: gaps {gaps}")
    phase("retrieve_flat", t0, k2_launches=launches, retrieve8_s=f"{retrieve_s:.4f}",
          ids_identical=not bool(differ.any()), ids_differ=int(differ.sum()),
          near_tie_gaps=gaps)
    return {"launches": launches}


def host_ms(fn, iters: int) -> float:
    """Host milliseconds per call of a function that runs on the host."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_host_stores(corpus, queries, db_path: str, workdir: str):
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8gs,
        binmax_partial_topk_int8gs_plain,
        exact_topk,
        fused_topk_int8gs,
    )
    from rag_inference_pipeline_tpu_torch.serve.runtime import _parse_retrieve, _result_wire
    from rag_inference_pipeline_tpu_torch.utils import cpuscan, docstore, fastjson, native

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    print(f"[host_stores] native isa={','.join(native.isa())} "
          f"threads={cpuscan.hw_threads()} gxx={native._gxx()}", flush=True)
    # the native doc store of the IVF corpus's documents
    tb = time.perf_counter()
    ragdoc = os.path.join(workdir, "documents.ragdoc")
    docstore.build_native_store(ragdoc, ivf_documents())
    ragdoc_s = time.perf_counter() - tb
    # the int8 flat index twice: the f16 rescore copy in host RAM, and the
    # bf16 copy on the card; the device bytes each leaves allocated
    def flat_int8(store: str):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        idx = FlatIndex(DIM, dtype="int8", device=dev, rescore_store=store, rescore_k=64)
        idx.add(corpus)
        torch.cuda.synchronize()
        return idx, torch.cuda.memory_allocated() - before

    tb = time.perf_counter()
    host, host_bytes = flat_int8("host")
    host_build_s = time.perf_counter() - tb
    devstore, dev_bytes = flat_int8("device")
    check(host._db is None and host._host_rescore.dtype == np.float16,
          "the host store put a rescore copy on the card")
    print(f"[host_stores] device bytes: host store {host_bytes}, device store {dev_bytes}, "
          f"saved {dev_bytes - host_bytes}", flush=True)

    # /retrieve under the defaults: DOC_STORE_BACKEND and FAST_JSON unset
    env = {k: v for k, v in STAGED_ENV.items() if k != "DOC_STORE_BACKEND"}
    env.update(DOCUMENT_DB_PATH=ragdoc, INDEX_KIND="flat", INDEX_DTYPE="int8",
               INDEX_RESCORE_STORE="host", PIPELINE_ROLE_PROFILE="retrieval_default")
    out, lat = {}, {}
    host_refine = None
    for mode, fast in (("id_only", None), ("id_only", "0"), ("full", None)):
        menv = {**env, "DOCUMENTS_PAYLOAD_MODE": mode, **({"FAST_JSON": fast} if fast else {})}
        server, th = _serve(menv, host)
        port = server.server_address[1]
        tag = mode + ("_stdlib" if fast else "")
        try:
            s = server.app.settings
            check(s.doc_store_backend == "native" and s.fast_json == (fast is None),
                  f"settings: doc store {s.doc_store_backend}, fast_json {s.fast_json}")
            trunc = s.truncate_length
            check(_get_health(port)["status"] == "ok", "host-store server not healthy")
            zero_launches()
            for b in (MAIN_B, RETRIEVE_B):
                body = json.dumps({"items": [{"embedding": q} for q in
                                             queries[:b].float().cpu().tolist()]}).encode()
                ts = time.perf_counter()
                status, _, raw = _request(port, "POST", "/retrieve", body)
                lat[f"{tag}_retrieve{b}_s"] = round(time.perf_counter() - ts, 4)
                check(status == 200, f"/retrieve {tag} {b}: HTTP {status}")
                out[(tag, b)] = raw
            launches = binmax_partial_topk_int8gs.launches
            check(launches >= 1, f"/retrieve {tag} over the host store did not run K1")
            if host_refine is None:
                _, samples = _scrape(port)
                labels = dict(service="index", stage="host_refine")
                host_refine = (
                    _total(samples, "pipeline_stage_duration_seconds_count", **labels),
                    _total(samples, "pipeline_stage_duration_seconds_sum", **labels))
        finally:
            _stop(server, th)
    check(host_refine[0] >= 2, f"index/host_refine observed {host_refine[0]} times")

    # ids against the plain pipeline: K1's plain scan, then the numpy
    # re-score, over the batches the server searched (one query scale a
    # batch): the 8 items, then the 56 of the 64 that its cache missed
    k = 10
    s_k = min(max(host.rescore_k, k + 32), host.nbins)
    fast_res = {b: json.loads(out[("id_only", b)])["results"] for b in (MAIN_B, RETRIEVE_B)}
    check(fast_res[RETRIEVE_B][:MAIN_B] == fast_res[MAIN_B], "cached results differ")
    differ, gaps = 0, []
    store = host._host_rescore
    for lo, hi in ((0, MAIN_B), (MAIN_B, RETRIEVE_B)):
        q = queries[lo:hi]
        _, short = fused_topk_int8gs(q, host._db_i8, host._db_gscale, s_k, nbins=host.nbins,
                                     ntotal=host.ntotal, scan=binmax_partial_topk_int8gs_plain)
        qn = q.float().cpu().numpy()
        _, pi = cpuscan.rescore_f16_plain(qn, store, short.cpu().numpy(), k)
        for r, irow, qv in zip(fast_res[RETRIEVE_B][lo:hi], pi, qn):
            want = [int(i) for i in irow if i >= 0]
            if r["ids"] == want:
                continue
            # the native sums in another order: a swap only between ids
            # whose exact f16 scores tie within the tolerance
            exact = {i: float(store[i].astype(np.float64) @ qv.astype(np.float64))
                     for i in set(r["ids"]) | set(want)}
            for a, w in zip(r["ids"], want):
                if a != w:
                    differ += 1
                    gaps.append(abs(exact[a] - exact[w]))
    check(all(g <= TOL["atol"] for g in gaps),
          f"host store: ids differ from the plain pipeline beyond a near-tie: {gaps}")
    # recall@10 against the exact f32 scan: the 64 queries as one batch
    # through each store, and as the server batched them
    with torch.inference_mode():
        _, exact_ids = exact_topk(queries, corpus, k)
        _, dev_ids = devstore.search(queries, k)
        _, host_ids = host.search(queries, k)
    ref = exact_ids.cpu().numpy()
    recall_host = _recall([{"ids": r} for r in host_ids.cpu().tolist()], ref)
    recall_dev = _recall([{"ids": r} for r in dev_ids.cpu().tolist()], ref)
    recall_served = _recall(fast_res[RETRIEVE_B], ref)
    check(recall_host >= recall_dev,
          f"host store recall@10 {recall_host:.4f} < device store's {recall_dev:.4f}")
    # the fast reply reads back as the stdlib one; documents are sqlite's
    for b in (MAIN_B, RETRIEVE_B):
        fast_b, slow_b = out[("id_only", b)], out[("id_only_stdlib", b)]
        check(b", " not in fast_b and b", " in slow_b, "the fast encoder did not answer")
        for rf, rs in zip(json.loads(fast_b)["results"], json.loads(slow_b)["results"],
                          strict=True):
            check(rf["ids"] == rs["ids"] and np.array_equal(
                np.float32(rf["scores"]), np.float32(rs["scores"])),
                "fast and stdlib /retrieve replies differ")
    sql = docstore._SqliteBackend(db_path, False)
    for r in json.loads(out[("full", RETRIEVE_B)])["results"]:
        want = sql.get_batch(r["ids"])
        got = [{f: d[f] for f in ("id", "title", "content")} for d in r["documents"]]
        check(got == [{**w, "content": w["content"][:trunc]} for w in want],
              "native documents differ from sqlite's")
    # the host layer's figures: re-score, fetch, JSON
    rng = np.random.default_rng(7)
    qn = queries[:MAIN_B].float().cpu().numpy()
    rescore = {}
    for sl in (64, 4096):
        ids = rng.integers(0, N_ROWS, (MAIN_B, sl), dtype=np.int32)
        ms = alternated(host_ms, {
            "native": lambda: cpuscan.rescore_f16(qn, store, ids, k),
            "plain": lambda: cpuscan.rescore_f16_plain(qn, store, ids, k)}, 1, 5)
        rescore[f"s{sl}_native_ms"] = round(ms["native"], 4)
        rescore[f"s{sl}_plain_ms"] = round(ms["plain"], 4)
    nat = docstore._NativeBackend(ragdoc, False)
    ids64 = [int(i) for i in rng.integers(0, N_ROWS, RETRIEVE_B)]
    check(nat.get_batch(ids64) == sql.get_batch(ids64), "native get_batch differs from sqlite's")
    fetch = alternated(host_ms, {"native": lambda: nat.get_batch(ids64),
                                 "sqlite": lambda: sql.get_batch(ids64)}, 1)
    nat.close()
    sql.close()
    body64 = json.dumps({"items": [{"embedding": q} for q in
                                   queries.float().cpu().tolist()]}).encode()
    wire = [_result_wire(r) for r in fast_res[RETRIEVE_B]]
    parse = alternated(host_ms, {
        "native": lambda: fastjson.parse_retrieve(body64, DIM),
        "stdlib": lambda: _parse_retrieve(json.loads(body64), DIM)}, 1)
    encode = alternated(host_ms, {
        "native": lambda: fastjson.encode_results(wire),
        "stdlib": lambda: json.dumps({"results": wire}).encode()}, 1)
    del host, devstore
    stats = {
        "ragdoc_build_s": round(ragdoc_s, 3), "host_index_build_s": round(host_build_s, 3),
        "device_bytes_host_store": host_bytes, "device_bytes_device_store": dev_bytes,
        "device_bytes_saved": dev_bytes - host_bytes,
        "k1_launches": launches, "ids_differ": differ, "near_tie_gaps": gaps,
        "recall_at_10_host": round(recall_host, 4), "recall_at_10_device": round(recall_dev, 4),
        "recall_at_10_served": round(recall_served, 4),
        **lat, "host_refine_count": int(host_refine[0]),
        "host_refine_mean_ms": round(host_refine[1] / max(host_refine[0], 1) * 1e3, 4),
        **{f"rescore_{k_}": v for k_, v in rescore.items()},
        "fetch64_native_ms": round(fetch["native"], 4),
        "fetch64_sqlite_ms": round(fetch["sqlite"], 4),
        "parse64_native_ms": round(parse["native"], 4),
        "parse64_stdlib_ms": round(parse["stdlib"], 4),
        "encode64_native_ms": round(encode["native"], 4),
        "encode64_stdlib_ms": round(encode["stdlib"], 4),
        "body64_mb": round(len(body64) / 1e6, 3),
    }
    phase("host_stores", t0, **stats)
    return stats


def phase_pq_build(corpus, queries, workdir: str):
    import torch
    from rag_inference_pipeline_tpu_torch.index.base import load_index
    from rag_inference_pipeline_tpu_torch.index.ivf_pq import IVFPQIndex

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    built, info = {}, {}
    for name, m, ksub, kind in (("pq4", PQ4_M, 16, "exact"), ("pq8", PQ8_M, 256, "exact"),
                                ("pq4_host", PQ4_M, 16, "host_int8")):
        tb = time.perf_counter()
        idx = IVFPQIndex(DIM, NLIST, m, nprobe=NPROBE, rescore_k=PQ_RESCORE_K, ksub=ksub,
                         rescore_kind=kind, device=dev)
        idx.train_add(corpus)
        torch.cuda.synchronize()
        lst = idx._listing
        sizes = lst.list_sizes.float()
        check(int((lst.ids >= 0).sum()) == N_ROWS, f"{name}: build lost or duplicated rows")
        check(int(lst.code_buckets[..., m:].count_nonzero()) == 0 and
              int(lst.code_buckets.max()) < ksub, f"{name}: codes out of range")
        info[f"{name}_build_s"] = f"{time.perf_counter() - tb:.3f}"
        info[f"{name}_cap"] = lst.code_buckets.shape[1]
        info[f"{name}_imbalance"] = f"{(sizes.max() / sizes.mean()).item():.4f}"
        info[f"{name}_codes_gb"] = f"{lst.code_buckets.numel() / 1e9:.3f}"
        built[name] = idx
    # .npz parity on 50k-row IVF-PQ indexes built the same way: save, load,
    # save the loaded one and load it again
    ts = time.perf_counter()
    for name, m, ksub in (("pq4", PQ4_M, 16), ("pq8", PQ8_M, 256)):
        small = IVFPQIndex(DIM, 256, m, nprobe=16, rescore_k=64, ksub=ksub, device=dev)
        small.train_add(corpus[:50_000], kmeans_iters=5, pq_iters=5)
        ref = small.search(queries[:8], 10)
        for hop in range(2):
            path = os.path.join(workdir, f"{name}_small_{hop}.npz")
            small.save(path)
            back = load_index(path, dev)
            for a, b_ in zip(small._listing, back._listing):
                check(torch.equal(a, b_), f"{name} .npz round trip changed the listing")
            check(torch.equal(small._vectors, back._vectors), f"{name}: re-score rows changed")
            out = back.search(queries[:8], 10)
            check(all(torch.equal(a, b_) for a, b_ in zip(ref, out)),
                  f"reloaded {name} searches differ")
            small = back
    info["small_npz_roundtrips_s"] = f"{time.perf_counter() - ts:.3f}"
    phase("pq_build", t0, **info)
    return built


def phase_k6(pq4, queries):
    import torch
    import torch.nn.functional as F
    from rag_inference_pipeline_tpu_torch.ops import ivf, pq
    from rag_inference_pipeline_tpu_torch.ops.topk import NEG_INF, _topk

    t0 = time.perf_counter()
    lst = pq4._listing
    nlist, cap, _ = lst.code_buckets.shape
    m = lst.codebooks.shape[0]
    codes, sizes = lst.code_buckets, lst.list_sizes
    g = torch.Generator(device=DEVICE).manual_seed(8)
    res = {}
    for b in (MAIN_B, RETRIEVE_B):
        q = queries[:b]
        probe = _topk(ivf.coarse_scores(lst.centroids, q), NPROBE)[1].int()
        slots, _ = ivf.dedup_probes(probe, nlist, min(nlist, b * NPROBE))
        b_pad = -(-b // 8) * 8
        own = F.pad(pq.pq_lut(q, lst.codebooks), (0, 0, 0, b_pad - b)).to(torch.bfloat16)
        integer = torch.randint(-8, 9, own.shape, generator=g, device=DEVICE).to(torch.bfloat16)
        r = {"max_abs_err": 0.0}
        for is_int, lut in ((True, integer), (False, own)):
            kv = pq.ivfpq4_adc_scores(lut, codes, slots, sizes)
            pv = pq.ivfpq4_adc_scores_plain(lut, codes, slots, sizes)
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"], _hold(f"K6 B={b}", is_int, kv, pv))
            if not is_int:
                plain_out = pv
            del kv, pv
        r["ms"] = cuda_ms(lambda: pq.ivfpq4_adc_scores(own, codes, slots, sizes), 20)
        r["plain_ms"] = cuda_ms(lambda: pq.ivfpq4_adc_scores_plain(own, codes, slots, sizes), 2)
        # the yardstick: one embedding_bag over the filled rows' codes
        # (offset by 16 per subspace, gathered outside the timing) into the
        # bf16-rounded tables held in f32
        sl = slots.long()
        filled = torch.arange(cap, device=DEVICE)[None, :] < sizes[sl][:, None]
        idx = codes[sl][filled][:, :m].long() + 16 * torch.arange(m, device=DEVICE)
        weight = own.float().T.contiguous()
        lib = F.embedding_bag(idx, weight, mode="sum")
        check(torch.allclose(lib, plain_out.permute(0, 2, 1)[filled], **TOL),
              f"K6 B={b}: the embedding_bag yardstick disagrees")
        r["library_ms"] = cuda_ms(lambda: F.embedding_bag(idx, weight, mode="sum"), 10)
        rows = idx.shape[0]
        # the filled rows' m code bytes once, the tables, the slot ids and
        # sizes, [n_slots, b_pad, cap] f32 out; one f32 add per lookup
        r.update(bound(rows * m + own.numel() * 2 + (sl.numel() + nlist) * 4
                       + sl.numel() * b_pad * cap * 4, b_pad * m * rows, "f32_add"))
        r["slots"], r["filled_rows"] = int(sl.numel()), rows
        # the one-hot form's bf16 flops: 2 * 16 columns per (query, row, subspace)
        r["onehot_tflops"] = 2 * 16 * b_pad * m * rows / (r["ms"] * 1e-3) / 1e12
        res[b] = r
        del idx, weight, lib, plain_out, filled
    # B=13: a partly padded query tile (b_pad 16), integer tables bit for bit
    probe = _topk(ivf.coarse_scores(lst.centroids, queries[:13]), NPROBE)[1].int()
    slots13, _ = ivf.dedup_probes(probe, nlist, min(nlist, 13 * NPROBE))
    lut13 = torch.randint(-8, 9, (16, m * 16), generator=g, device=DEVICE).to(torch.bfloat16)
    kv = pq.ivfpq4_adc_scores(lut13, codes, slots13, sizes)
    pv = pq.ivfpq4_adc_scores_plain(lut13, codes, slots13, sizes)
    torch.cuda.synchronize()
    _hold("K6 B=13", True, kv, pv)
    del kv, pv
    # the whole B=64 search (K6 + the flat top-k of [64, n_slots * cap])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pq.ivfpq4_search_dedup(lst, queries, PQ_RESCORE_K, nprobe=NPROBE)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    search_ms = cuda_ms(lambda: pq.ivfpq4_search_dedup(lst, queries, PQ_RESCORE_K,
                                                       nprobe=NPROBE), 5)
    # the selection beside the stable sort it replaced, at the search's shape
    width = res[RETRIEVE_B]["slots"] * cap
    flat = torch.randn(RETRIEVE_B, width, generator=g, device=DEVICE)
    topk_ms = cuda_ms(lambda: _topk(flat, PQ_RESCORE_K), 5)
    sort_ms = cuda_ms(lambda: torch.sort(flat, dim=-1, descending=True, stable=True), 5)
    # the same indices as the stable sort on integer-valued rows (long runs
    # of ties) and on rows of NEG_INF fill with fewer valid entries than k
    flat = torch.randint(-3, 4, flat.shape, generator=g, device=DEVICE).float()
    flat[RETRIEVE_B // 2:, 100:] = NEG_INF
    sel = _topk(flat, PQ_RESCORE_K)[1]
    ref = torch.sort(flat, dim=-1, descending=True, stable=True)[1][:, :PQ_RESCORE_K]
    check(torch.equal(sel, ref), "_topk differs from the stable sort on ties")
    del flat, sel, ref
    torch.cuda.empty_cache()
    b8, b64 = res[MAIN_B], res[RETRIEVE_B]
    phase("k6", t0, integer_bit_identical=True, b13_bit_identical=True,
          b8_slots=b8["slots"], b8_ms=f"{b8['ms']:.4f}", b8_plain_ms=f"{b8['plain_ms']:.4f}",
          b8_library_ms=f"{b8['library_ms']:.4f}", b8_bound_ms=f"{b8['bound_ms']:.4f}",
          b8_onehot_tflops=f"{b8['onehot_tflops']:.1f}",
          b64_slots=b64["slots"], b64_ms=f"{b64['ms']:.4f}",
          b64_plain_ms=f"{b64['plain_ms']:.4f}", b64_library_ms=f"{b64['library_ms']:.4f}",
          b64_bound_ms=f"{b64['bound_ms']:.4f}", b64_onehot_tflops=f"{b64['onehot_tflops']:.1f}",
          err8=b8["max_abs_err"], err64=b64["max_abs_err"], search64_ms=f"{search_ms:.4f}",
          topk64_ms=f"{topk_ms:.4f}", sort64_ms=f"{sort_ms:.4f}", topk_equals_sort=True,
          search64_peak_gb=f"{peak_gb:.3f}")
    return b8


def _recall(results, ref) -> float:
    import numpy as np

    return float(np.mean([len(set(r["ids"]) & set(e)) / 10 for r, e in zip(results, ref)]))


def phase_serve_pq(built, corpus, queries, db_path: str):
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.ops.pq import (
        ivfpq4_adc_scores,
        ivfpq4_adc_scores_plain,
    )
    from rag_inference_pipeline_tpu_torch.ops.topk import exact_topk

    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = exact_topk(queries, corpus.to(torch.bfloat16), 10)[1].cpu().numpy()
    base = {**STAGED_ENV, "DOCUMENT_DB_PATH": db_path, "INDEX_KIND": "ivf_pq"}
    pq4_env = {"INDEX_PQ_BITS": "4", "INDEX_PQ_M": str(PQ4_M)}
    stats, recalls = {}, {}

    def retrieve_only(profile, index, env, sizes):
        server, th = _serve({**base, **env, "PIPELINE_ROLE_PROFILE": profile}, index)
        port = server.server_address[1]
        try:
            check(_get_health(port)["profile"] == profile, f"profile {profile}")
            zero_launches()
            out = []
            for b in sizes:
                ret, secs = _retrieve(port, queries[:b])
                out.append((ret["results"], secs, ivfpq4_adc_scores.launches))
            health = _get_health(port)["kernel_launches"]
        finally:
            _stop(server, th)
        check(health["ivfpq4_adc"] == ivfpq4_adc_scores.launches,
              f"{profile}: /health disagrees with the K6 launch count")
        for res, _, _ in out:
            check(all(len(r["ids"]) == 10 and np.isfinite(r["scores"]).all() for r in res),
                  f"{profile}: 10 finite results per item expected")
            check(all(r["documents"][0]["title"] == f"doc {r['ids'][0]}" for r in res),
                  f"{profile}: documents do not match their ids")
        return out

    # PQ4 with exact re-score: an 8-item and a 64-item /retrieve
    (r8, s8, n8), (r64, s64, n64) = retrieve_only("retrieval_pq4", built["pq4"], pq4_env, (MAIN_B, RETRIEVE_B))
    check(n8 >= 1 and n64 > n8, f"retrieval_pq4: K6 launched {n8}, then {n64} in all")
    pq4 = built["pq4"]
    ps, pi = pq4.search(queries[:MAIN_B], 10, scan=ivfpq4_adc_scores_plain)
    got = torch.tensor([r["ids"] for r in r8], device=DEVICE)
    got_s = torch.tensor([r["scores"] for r in r8], device=DEVICE)
    differ = got != pi
    # the kernel sums in another order than the plain scan: an id may
    # differ only where two shortlist candidates tie within the tolerance
    check(torch.allclose(got_s, ps, **TOL), "K6 route: scores differ from the plain scan")
    check(int(differ.sum()) <= 1, f"K6 route: {int(differ.sum())} ids differ from the plain scan")
    recalls["pq4"] = _recall(r64, ref)  # its first 8 items hit the search cache
    stats.update(pq4_k6_launches=n64, pq4_retrieve8_s=f"{s8:.4f}",
                 pq4_retrieve64_s=f"{s64:.4f}", pq4_ids_identical=not bool(differ.any()))
    # PQ4 shortlist, int8 refine store in host RAM
    ((rh, sh, nh),) = retrieve_only("retrieval_pq_host_refine", built["pq4_host"], pq4_env, (MAIN_B,))
    check(nh >= 1, "retrieval_pq_host_refine: /retrieve did not run K6")
    recalls["pq4_host"] = _recall(rh, ref)
    stats.update(host_k6_launches=nh, host_retrieve8_s=f"{sh:.4f}")
    # PQ8: the gather-ADC search, no kernel
    ((r_8, s_8, n_8),) = retrieve_only("retrieval_ivfpq", built["pq8"], {}, (MAIN_B,))
    check(n_8 == 0, "retrieval_ivfpq (PQ8) ran the PQ4 kernel")
    recalls["pq8"] = _recall(r_8, ref)
    stats.update(pq8_retrieve8_s=f"{s_8:.4f}")
    for name, rec in recalls.items():
        check(rec >= PQ_RECALL_BAR[name], f"{name} recall@10 {rec:.4f} < {PQ_RECALL_BAR[name]}")
        stats[f"{name}_recall_at_10"] = f"{rec:.4f}"
    # /query on single_node_full over the PQ4 index, models at full width
    server, th = _serve({**base, **pq4_env}, pq4)
    port = server.server_address[1]
    tq = time.perf_counter()
    try:
        health = _get_health(port)
        check(health["status"] == "ok" and health["profile"] == "single_node_full",
              f"not loaded: {health}")
        zero_launches()
        results = [_post(port, f"what does the corpus say about topic {i}?", f"p{i}")
                   for i in range(2)]
        k6_query = ivfpq4_adc_scores.launches
    finally:
        _stop(server, th)
    keys = {"request_id", "generated_response", "sentiment", "is_toxic"}
    for i, (status, body, _) in enumerate(results):
        check(status == 200 and set(body) == keys and body["request_id"] == f"p{i}",
              f"/query {i} over IVF-PQ: HTTP {status}, {sorted(body)}")
    check(k6_query >= 1, "/query over IVF-PQ did not run K6")
    stats.update(query_k6_launches=k6_query, query_first_s=f"{results[0][2]:.4f}",
                 query_second_s=f"{results[1][2]:.4f}",
                 query_phase_s=f"{time.perf_counter() - tq:.3f}")
    phase("serve_pq", t0, **stats)
    return n64 + nh + k6_query


def phase_k3():
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8 as kernel,
        binmax_partial_topk_int8_plain as plain,
        exact_topk,
        fused_topk_int8,
        quantize_rows_int8,
    )

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(9)
    out = {"max_abs_err": 0.0}
    for i, (b, n, d, nbins) in enumerate([  # main shape first
        (MAIN_B, N_ROWS + 777, DIM, 512),
        (37, 5000, 64, 128),
        (5, 90, DIM, 128),  # N < nbins: empty bins
    ]):
        q = torch.randint(-127, 128, (b, d), generator=g, device=DEVICE, dtype=torch.int8)
        db = torch.randint(-127, 128, (n, d), generator=g, device=DEVICE, dtype=torch.int8)
        # f32 scales over many binades, one negative, one zero, one NaN
        scales = torch.exp(torch.rand(n, generator=g, device=DEVICE) * 25 - 20)
        scales[:3] = torch.tensor([-0.25, 0.0, float("nan")], device=DEVICE)
        if n > nbins + 5:
            db[nbins + 5], scales[nbins + 5] = db[5], scales[5]  # a tie
        kv, ki = kernel(q, db, scales, nbins=nbins)
        pv, pi = plain(q, db, scales, nbins=nbins)
        torch.cuda.synchronize()
        same = torch.equal(kv, pv) and torch.equal(ki, pi)
        fin = torch.isfinite(kv) & torch.isfinite(pv)
        err = (kv[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
        check(same, f"K3 case {i} differs from its plain version (max err {err})")
        check(n >= nbins or bool((ki[:, n:] == -1).all()), f"K3 case {i}: empty bins")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if i == 0:
            out["ms"] = cuda_ms(lambda: kernel(q, db, scales, nbins=nbins), 20)
            out["plain_ms"] = cuda_ms(lambda: plain(q, db, scales, nbins=nbins), 3)
            # the rows and their f32 scales, the queries, (value, row) per bin
            out.update(bound(n * d + 4 * n + b * d + b * nbins * 8, 2 * b * n * d, "int8"))
            out["library_ms"] = None  # a positional bin max: no one call
        del q, db, scales
    # the public op over seeded unit rows, queries = rows + noise
    corpus = torch.randn(N_ROWS, DIM, generator=g, device=DEVICE)
    corpus /= corpus.norm(dim=1, keepdim=True)
    rows = torch.randint(0, N_ROWS, (RETRIEVE_B,), generator=g, device=DEVICE)
    queries = corpus[rows] + QUERY_NOISE * torch.randn(RETRIEVE_B, DIM, generator=g, device=DEVICE)
    queries /= queries.norm(dim=1, keepdim=True)
    db_i8, scales = quantize_rows_int8(corpus)
    rescore = corpus.to(torch.bfloat16)
    del corpus
    zero_launches()
    _, ids = fused_topk_int8(queries, db_i8, scales, 10, rescore_db=rescore, rescore_k=64)
    torch.cuda.synchronize()
    out["launches"] = kernel.launches
    check(out["launches"] >= 1, "fused_topk_int8 did not run K3")
    _, plain_ids = fused_topk_int8(queries, db_i8, scales, 10, rescore_db=rescore,
                                   rescore_k=64, scan=plain)
    check(torch.equal(ids, plain_ids), "fused_topk_int8: the kernel and the plain "
          "scan return different ids")
    with torch.inference_mode():
        _, exact = exact_topk(queries, rescore, 10)
    got, ref = ids.cpu().numpy(), exact.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(e)) / 10 for a, e in zip(got, ref)]))
    check(recall >= 0.95, f"fused_topk_int8 recall@10 {recall:.4f} < 0.95")
    del db_i8, scales, rescore
    torch.cuda.empty_cache()
    phase("k3", t0, cases=3, bit_identical=True, main_plain_ms=f"{out['plain_ms']:.4f}",
          **rate("main", out), k3_launches=out["launches"], ids_identical=True,
          recall_at_10=f"{recall:.4f}")
    return out


def phase_k8():
    import torch
    from rag_inference_pipeline_tpu_torch.ops.stream import stream_sum, stream_sum_plain
    from rag_inference_pipeline_tpu_torch.tools import bench_kernel as lab

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(10)
    db = torch.randint(-128, 128, (N_ROWS, DIM), generator=g, device=DEVICE, dtype=torch.int8)
    q = torch.randint(-1000, 1000, (8, 128), generator=g, device=DEVICE, dtype=torch.int32)
    out = {"max_abs_err": 0.0}
    for chunk in (4096, 8192):
        ko, kc = stream_sum(q, db, chunk)
        po, pc = stream_sum_plain(q, db, chunk)
        torch.cuda.synchronize()
        check(torch.equal(ko, po) and torch.equal(kc, pc),
              f"K8 chunk={chunk}: out or checksum differs from the plain version")
    rows = N_ROWS // 8192 * 8192
    out["ms"] = cuda_ms(lambda: stream_sum(q, db, 8192), 20)
    out["plain_ms"] = cuda_ms(lambda: stream_sum_plain(q, db, 8192), 5)
    out["library_ms"] = cuda_ms(lambda: torch.sum(db[:rows], dtype=torch.int64), 20)
    # every streamed byte once, q and out; one add per byte
    out.update(bound(rows * DIM + 2 * q.numel() * 4 + 8, rows * DIM, "int8"))
    gbs = rows * DIM / out["ms"] / 1e6
    del db
    torch.cuda.empty_cache()
    # the kernel lab: its stream mode is K8's path; scan and tail run K1
    zero_launches()
    lab_stream = lab.main(["--mode", "stream"])
    out["launches"] = stream_sum.launches
    check(out["launches"] >= 1, "the lab's stream mode did not run K8")
    scan = lab.main(["--mode", "scan", "--batch", "128", "--nbins", "1024"])["results"][0]
    tail = lab.main(["--mode", "tail", "--batch", "128", "--nbins", "1024"])["results"]
    torch.cuda.empty_cache()
    lab_gbs = {r["chunk"]: round(r["gb_per_s"], 1) for r in lab_stream["results"]}
    phase("k8", t0, identical=True, ms=f"{out['ms']:.4f}", gb_per_s=f"{gbs:.1f}",
          sheet_gb_per_s=HBM_BYTES_PER_S / 1e9, plain_ms=f"{out['plain_ms']:.4f}",
          torch_sum_ms=f"{out['library_ms']:.4f}", lab_stream_gb_per_s=lab_gbs,
          k8_launches=out["launches"], scan128_ms=f"{scan['ms_inprogram']:.4f}",
          scan128_recall=f"{scan['recall']:.4f}",
          tail128_ms="/".join(f"{r['ms_inprogram']:.4f}" for r in tail))
    return out


def host_us(fn, iters: int) -> float:
    """Host microseconds per call: the time to issue `iters` calls, the
    device left to finish after the clock stops."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def alternated(timer, fns: dict, iters: int, rounds: int = 7) -> dict:
    """The median of `rounds` timings of each function, the functions
    taken in turn in every round: a host-bound call's time moves with the
    host's load, and turns keep a burst from landing on one side only."""
    runs = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            runs[name].append(timer(fn, iters))
    return {name: statistics.median(v) for name, v in runs.items()}


def phase_k7():
    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.ops import kv
    from rag_inference_pipeline_tpu_torch.tools import bench_decode_anatomy as anatomy

    t0 = time.perf_counter()
    zero_launches()
    res = anatomy.main(ANATOMY_ARGS)
    out = {"launches": kv.kv_row_insert_pair.launches}
    # the wrapper's own launches, one a layer and step: the eager calls and
    # each capture's eager warm-up (a capture and its replays call no wrapper)
    want = res["layers"] * res["length"] * res["calls_per_variant"] * len(res["batches"])
    check(out["launches"] == want, f"the K7 pair launched {out['launches']} times, not {want}")
    check(kv.kv_row_insert.launches == 0, "the probe launched the single insert")
    # the graphs hold the pair: one replay's K7 launches, by the device trace
    graph_k7 = res["graph_k7_per_replay"]
    per_replay = res["layers"] * res["length"]
    check(sorted(graph_k7) == sorted(str(b) for b in res["batches"])
          and all(n == per_replay for n in graph_k7.values()),
          f"a replay of the kernel variant's graph launched K7 {graph_k7} times, "
          f"not {per_replay} at each batch")
    # the single and pair inserts against their plain versions on the
    # probe's own B=8 caches of layer 0
    with torch.inference_mode():
        cfg, params = anatomy.make_model(False, torch.device(DEVICE))
        warm, _ = anatomy.warm_cache(params, cfg, MAIN_B, 128, 384, np.random.default_rng(0))
        ck, cv = warm.k[0], warm.v[0]
        s_len = ck.shape[1]
        g = torch.Generator(device=DEVICE).manual_seed(11)
        nk, nv = (torch.randn(MAIN_B, cfg.kv_heads, cfg.head_dim, generator=g,
                              device=DEVICE).to(ck.dtype) for _ in range(2))
        pos = torch.arange(128, 128 + MAIN_B, device=DEVICE, dtype=torch.int32)
        pos[0], pos[-1] = -3, s_len + 16  # row S-3; past the end: row S-1
        a = kv.kv_row_insert(ck.clone(), nk, pos)
        b = kv.kv_row_insert_plain(ck.clone(), nk, pos)
        ak, av = kv.kv_row_insert_pair(ck.clone(), cv.clone(), nk, nv, pos)
        bk, bv = kv.kv_row_insert_pair_plain(ck.clone(), cv.clone(), nk, nv, pos)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "the K7 single insert differs from its plain version")
        check(torch.equal(ak, bk) and torch.equal(av, bv),
              "the K7 pair differs from its plain version")
        out["max_abs_err"] = max((x.float() - y.float()).abs().max().item()
                                 for x, y in ((a, b), (ak, bk), (av, bv)))
        out["plain_ms"] = cuda_ms(lambda: kv.kv_row_insert_pair_plain(bk, bv, nk, nv, pos), 200)
        # the yardstick: the port's own decode insert, index_copy_ over the
        # flattened rows, once per cache
        flat_k = ck.clone().view(MAIN_B * s_len, cfg.kv_heads, cfg.head_dim)
        flat_v = cv.clone().view(MAIN_B * s_len, cfg.kv_heads, cfg.head_dim)
        p = pos.long()
        rows = torch.arange(MAIN_B, device=DEVICE) * s_len + torch.where(p < 0, p + s_len, p).clamp(0, s_len - 1)

        def two_index_copies():
            flat_k.index_copy_(0, rows, nk)
            flat_v.index_copy_(0, rows, nv)

        two_index_copies()
        check(torch.equal(flat_k.view_as(ck), ak) and torch.equal(flat_v.view_as(cv), av),
              "the index_copy_ yardstick writes other rows")
        # host-bound calls: each side timed in 7 alternated rounds, medians
        fns = {"pair": lambda: kv.kv_row_insert_pair(ak, av, nk, nv, pos),
               "copies": two_index_copies,
               "single": lambda: kv.kv_row_insert(a, nk, pos),
               "checks": lambda: kv._check("pair", ak, av, nk, nv, pos)}
        dev_ms = alternated(cuda_ms, {k: fns[k] for k in ("pair", "copies", "single")}, 200)
        out["ms"], out["library_ms"], single_ms = dev_ms["pair"], dev_ms["copies"], dev_ms["single"]
        host = alternated(host_us, {k: fns[k] for k in ("pair", "copies", "checks")}, 1000)
        pair_host, copies_host, checks_host = host["pair"], host["copies"], host["checks"]
        # the two caches' new rows read once and written once, the positions
        out.update(bound(2 * 2 * nk.numel() * nk.element_size() + 4 * MAIN_B, 0, "bf16"))
        del params, warm, ck, cv, a, b, ak, av, bk, bv, flat_k, flat_v
    torch.cuda.empty_cache()
    ms_rows = {k: round(v, 3) for k, v in res["rows"].items() if not k.endswith("_agree")}
    agree = {k: v for k, v in res["rows"].items() if k.endswith("_agree")}
    phase("k7", t0, k7_pair_launches=out["launches"], expected=want,
          graph_k7_per_replay=json.dumps(graph_k7, separators=(",", ":")), bit_identical=True,
          pair_ms=f"{out['ms']:.5f}", pair_plain_ms=f"{out['plain_ms']:.5f}",
          two_index_copy_ms=f"{out['library_ms']:.5f}", single_ms=f"{single_ms:.5f}",
          pair_host_us=f"{pair_host:.3f}", two_index_copy_host_us=f"{copies_host:.3f}",
          pair_checks_host_us=f"{checks_host:.3f}", length=res["length"],
          reps=res["reps"], ms_per_step=json.dumps(ms_rows, separators=(",", ":")),
          agree=json.dumps(agree, separators=(",", ":")))
    return out


# ---------------------------------------------------------------------------
# The decode slice: greedy as a CUDA graph, speculation, the decode engine
# ---------------------------------------------------------------------------


def _decoder(dtype: str):
    """Qwen2.5-0.5B at full width, random weights from seed 0."""
    import torch
    from rag_inference_pipeline_tpu_torch.models.qwen import QwenConfig, init_qwen_params

    cfg = QwenConfig.qwen25_05b()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    return cfg, init_qwen_params(cfg, generator=g, dtype=getattr(torch, dtype),
                                 device=torch.device(DEVICE))


def _decode_prompts(b: int, seed: int, vocab: int = DOC_VOCAB):
    """[b, DECODE_BUCKET] right-padded prompts of 384-512 tokens."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, vocab - 1, (b, DECODE_BUCKET)).astype(np.int32)
    lens = rng.integers(DECODE_BUCKET * 3 // 4, DECODE_BUCKET + 1, b)
    mask = (np.arange(DECODE_BUCKET)[None] < lens[:, None]).astype(np.int32)
    return (torch.from_numpy(ids * mask).to(DEVICE), torch.from_numpy(mask).to(DEVICE))


def _wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _greedy_against_eager(tag: str, params, cfg, b: int, quantize: bool,
                          eager_new: int = DECODE_EAGER_NEW):
    """greedy_generate at `b` lanes over DECODE_BUCKET-token prompts in the
    decoder's vocabulary, DECODE_NEW new tokens: the step graph (its first
    call captures it) against the eager loop over the first `eager_new` of
    them (on a cache of the graph's length, so every step runs the same
    shapes), tokens bit for bit, and a
    second graph call the first's; ms a token of the eager call and of the
    second graph call, the capture's s, its pool and state MB, the device's
    peak GB over the first call above what was allocated before. Each W8A8
    kernel's launches over the first call (the prefill and the capture's
    warm-up step: the replays count none) are the route rule's, none for a
    tree without int8 weights (`quantize` False). At MAIN_B a
    torch.profiler trace of step replays (`_profile_steps`), its W8A8
    kernels a step the rule's. -> (stats, W8A8 launches, the prompts)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen

    n = DECODE_NEW
    ids, mask = _decode_prompts(b, seed=b, vocab=cfg.vocab_size)
    graphs = decode_graph.graphs_of(params)
    before = len(graphs)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    graph_toks, first_s = _wall(lambda: qwen.greedy_generate(
        params, cfg, ids, mask, n, eos_token_id=-1))
    peak = torch.cuda.max_memory_allocated() - base
    launches = _w8a8_counts()
    step = w8a8_launches(cfg, b, b) if quantize else W8A8_NONE
    want = tuple(p + q for p, q in zip(w8a8_launches(cfg, b * DECODE_BUCKET, b), step)) \
        if quantize else W8A8_NONE
    check(launches == want, f"{tag} B={b}: {W8A8_COUNTS} launches {launches}, not {want}")
    entry = graphs.entries()[before]
    eager_toks, eager_s = _wall(lambda: qwen.greedy_generate_eager(
        params, cfg, ids, mask, eager_new, eos_token_id=-1, cache_len=DECODE_BUCKET + n))
    check(torch.equal(graph_toks[:, :eager_new], eager_toks),
          f"{tag} greedy at B={b}: graph and eager tokens differ")
    again, graph_s = _wall(lambda: qwen.greedy_generate(
        params, cfg, ids, mask, n, eos_token_id=-1))
    check(torch.equal(again, graph_toks), f"{tag} B={b}: a second replay gave other tokens")
    check(graph_toks.shape == (b, n) and bool(((graph_toks >= 0)
                                              & (graph_toks < cfg.vocab_size)).all()),
          f"{tag} B={b}: tokens out of the vocabulary")
    cache = entry.state.cache
    stats = {f"b{b}_eager_ms_per_token": f"{eager_s / eager_new * 1e3:.3f}",
             f"b{b}_graph_ms_per_token": f"{graph_s / n * 1e3:.3f}",
             f"b{b}_first_call_s": f"{first_s:.3f}",
             f"b{b}_capture_s": f"{entry.graph.capture_s:.3f}",
             f"b{b}_pool_mb": f"{entry.graph.pool_bytes / 2**20:.1f}",
             f"b{b}_state_mb": f"{sum(t.numel() * t.element_size() for t in (cache.k, cache.v)) / 2**20:.1f}",
             f"b{b}_decode_peak_gb": f"{peak / 1e9:.3f}"}
    if b == MAIN_B:
        prof = _profile_steps(params, cfg, entry, ids, mask)
        if "b8_step_w8a8_kernels" in prof:
            check(prof["b8_step_w8a8_kernels"] == sum(step[:3]),
                  f"{tag}: a step replays {prof['b8_step_w8a8_kernels']} W8A8 kernels, "
                  f"not {sum(step[:3])}")
        stats.update(prof)
    return stats, launches, (ids, mask)


def phase_decode_graph():
    """greedy_generate eager and as the step graph at B = 8 and 1
    (`_greedy_against_eager`), Qwen2.5-0.5B in bf16."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import decode_graph

    t0 = time.perf_counter()
    cfg, params = _decoder("bfloat16")
    stats = {}
    with torch.inference_mode():
        for b in (MAIN_B, 1):
            stats.update(_greedy_against_eager("decode_graph", params, cfg, b, False)[0])
    graphs = decode_graph.graphs_of(params)
    stats["graphs"] = len(graphs)
    stats["graphs_pool_mb"] = f"{graphs.pool_bytes / 2**20:.1f}"
    phase("decode_graph", t0, bit_identical=True, new_tokens=DECODE_NEW,
          prompt_bucket=DECODE_BUCKET, **stats)
    return params, stats


def _profile_steps(params, cfg, entry, ids, mask, steps: int = 8) -> dict:
    """torch.profiler over `steps` replays of a greedy step graph: the
    device's busy share (kernel time over the host's wall) and the kernels
    that take most of it. One replay before them runs as the profiler's
    warm-up step, whose events are dropped: a trace that began on the
    counted replays lost some of their first kernels (at Llama-3.1-8B's
    ~5,000 a step, one W8A8 kernel in one run of three)."""
    import collections

    import torch
    from torch.autograd import DeviceType

    entry.state.start(params, cfg, ids, mask, -1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        entry.graph.replay()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(steps):
            entry.graph.replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    # the device's events but the schedule's own span of the counted step
    cuda_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
    by_name = collections.Counter()
    for e in cuda_events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if busy == 0:
        return {"b8_step_busy_share": "not measured (no device events)"}
    top = [(name[:48], round(us / busy, 3)) for name, us in by_name.most_common(6)]

    def per_step(*marks) -> int:
        return sum(1 for e in cuda_events if any(m in e.name for m in marks)) // steps

    # the s32 kind of the small-row GEMMs is their int8-row instance (in_kind
    # 2, T = int8_t: "signed char", "Ia" mangled); the short-K kernel's among
    # them
    return {"b8_step_busy_share": f"{busy / wall_us:.3f}",
            "b8_step_kernel_ms": f"{busy / steps / 1e3:.3f}",
            "b8_step_kernels": len(cuda_events) // steps,
            "b8_step_w8a8_kernels": per_step("w8a8", "quantize_rows"),
            "b8_step_s32_small_kernels": per_step(
                "w8a8_qgemm_kernel<signed char", "w8a8_qgemm_kernelIa",
                "w8a8_qshort_kernel<signed char", "w8a8_qshort_kernelIa"),
            "b8_step_s32_short_kernels": per_step("w8a8_qshort_kernel<signed char",
                                                  "w8a8_qshort_kernelIa"),
            "b8_step_wgmma_kernels": per_step("w8a8_wgmma_kernel"),
            "b8_step_top_kernels": json.dumps(top)}


def _top2_gaps(params, cfg, ids, mask, n: int, cache_len=None):
    """The eager greedy loop, recording each step's gap between the two
    top logits -> (tokens [B, n], gaps [B, n])."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    b, t = ids.shape
    s = cache_len or t + n
    st = qwen._GreedyState(cfg, b, s, max(s, n), params.final_ln.dtype, ids.device)
    logits, _ = qwen.qwen_prefill(params, cfg, ids, mask, st.cache)
    gaps = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    for i in range(n):
        top = logits.topk(2, dim=-1).values
        gaps.append(top[:, 0] - top[:, 1])
        if i == n - 1:
            break
        logits, _ = qwen.qwen_decode_step(params, cfg, tok, st.cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, 1), torch.stack(gaps, 1)


def _hold_to_greedy(name: str, got: list, ref: list, gap_of, tie: float = NEAR_TIE,
                    what: str = "greedy's top two logits lie") -> dict:
    """Rows (token lists) equal to greedy's, or diverging first at a step
    where greedy's two top logits lie within `tie` (NEAR_TIE: f32).
    `gap_of(i, j)` gives row i's gap at step j (`what` names it). ->
    {identical, near_ties: [(row, step, gap)]}."""
    ties = []
    for i, (a, r) in enumerate(zip(got, ref)):
        if a == r:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, r)) if x != y), min(len(a), len(r)))
        gap = float(gap_of(i, j))
        check(gap <= tie, f"{name}: row {i} diverges from greedy at step {j}, "
              f"where {what} {gap:.3g} apart (> {tie:.3g})")
        ties.append((i, j, round(gap, 8)))
    return {"identical": len(got) - len(ties), "near_ties": ties}


def phase_spec(bf16_params):
    """ngram_speculative_generate against greedy_generate in float32 (the
    verify window and the single step are other GEMM shapes), then the
    benchmark-only injected acceptance in bf16."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    t0 = time.perf_counter()
    n, gamma = DECODE_NEW, SPEC_GAMMA
    cfg, params = _decoder("float32")
    stats = {}
    with torch.inference_mode():
        ids, mask = _decode_prompts(MAIN_B, seed=21)
        runs = {"spec": lambda: qwen.ngram_speculative_generate(
                    params, cfg, ids, mask, n, gamma=gamma, eos_token_id=-1),
                "greedy": lambda: qwen.greedy_generate(
                    params, cfg, ids, mask, n, eos_token_id=-1)}
        firsts = {k: f() for k, f in runs.items()}  # the captures
        (spec, mean), spec_s = _wall(runs["spec"])
        greedy, greedy_s = _wall(runs["greedy"])
        check(torch.equal(spec, firsts["spec"][0]) and torch.equal(greedy, firsts["greedy"]),
              "a second replay gave other tokens than the first")
        gaps = None
        if not torch.equal(spec, greedy):
            _, gaps = _top2_gaps(params, cfg, ids, mask, n)
        held = _hold_to_greedy("spec", spec.tolist(), greedy.tolist(),
                               lambda i, j: gaps[i, j])
        stats.update(f32_identical_rows=held["identical"],
                     f32_near_ties=json.dumps(held["near_ties"]),
                     f32_commits_per_call=f"{float(mean):.4f}",
                     f32_spec_ms_per_token=f"{spec_s / n * 1e3:.3f}",
                     f32_greedy_ms_per_token=f"{greedy_s / n * 1e3:.3f}")
        del params
        torch.cuda.empty_cache()
        # bf16: the acceptance curve (VERDICT item 4), beside greedy
        ids, mask = _decode_prompts(MAIN_B, seed=MAIN_B)
        _, g_s = _wall(lambda: qwen.greedy_generate(  # captured in decode_graph
            bf16_params, cfg, ids, mask, n, eos_token_id=-1))
        stats["bf16_greedy_ms_per_token"] = f"{g_s / n * 1e3:.3f}"
        for p in INJECT_P:
            run = lambda: qwen.ngram_speculative_generate(  # noqa: E731
                bf16_params, cfg, ids, mask, n, gamma=gamma, eos_token_id=-1,
                inject_accept_p=p)
            run()  # capture
            (toks, mean), s = _wall(run)
            check(toks.shape == (MAIN_B, n), "injected speculation: token shape")
            stats[f"bf16_p{p}_ms_per_token"] = f"{s / n * 1e3:.3f}"
            stats[f"bf16_p{p}_commits_per_call"] = f"{float(mean):.4f}"
    phase("spec", t0, gamma=gamma, new_tokens=n, batch=MAIN_B, **stats)
    return stats


def phase_serve_w8a8(paths: dict) -> dict:
    """The fused server with both W8A8 knobs on: the serve phase's requests,
    its K1 check, and the quantize and GEMM counts rising."""
    executor, _, stats, bodies, _ = phase_serve(
        paths, {"LLM_WEIGHT_QUANT": "int8", "ENCODER_WEIGHT_QUANT": "int8"}, "serve_w8a8")
    from rag_inference_pipeline_tpu_torch.models.layers import QuantizedEmbed, QuantizedLinear

    check(isinstance(executor.llm.params.embed, QuantizedEmbed)
          and isinstance(executor.embedder.params.layers[0].q_w, QuantizedLinear)
          and isinstance(executor.sentiment.params.classifier.w, QuantizedLinear),
          "serve_w8a8: the served trees are not quantized")
    check(stats["w8a8_small_launches"] > 0 and stats["w8a8_wgmma_launches"] > 0
          and stats["quantize_rows_launches"] > 0,
          f"serve_w8a8: a W8A8 kernel did not launch on /query ({stats})")
    return {**stats, "bodies": bodies}


# the W8A8 launch counts, in this order, and none of them
W8A8_COUNTS = ("(small-row, wgmma, quantize, few-tile, long-row quantize, wgmma in bands, "
               "wgmma shared weight, few-tile on 128 columns, short-K small-row)")
W8A8_NONE = (0,) * 9


def w8a8_launches(cfg, rows: int, head_rows: int, dtype: str = "bfloat16") -> tuple:
    """W8A8_COUNTS launches of one Qwen forward pass over `rows` token rows
    of `dtype` activations whose head sees `head_rows`, by ops/w8a8.py's
    route rule: a product is one launch a group (q/k/v, o, gate/up, down,
    the head) on either route, and a wgmma one quantizes x first; few-tile
    counts the wgmma launches on a plan for few rows (`_few_rows`: 64 x 64
    tiles, or K split over a cluster), long-row quantize the quantizes whose
    plan (`_quant_plan`) takes the long-row kernel, the next three the
    wgmma launches whose plan is of the kind "bands", "shared" and
    "few_rows" (`_plan_kind`), and the last the small-row launches on the
    short-K kernel (`_qgemm_short`)."""
    import torch
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    kind = w8a8._IN_KINDS[getattr(torch, dtype)]
    small = wgmma = quant = few = long = short = 0
    kinds = dict.fromkeys(w8a8.PLAN_KINDS, 0)
    q, kv, inter = cfg.heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim, cfg.intermediate
    layer = [(cfg.hidden, (q, kv, kv)), (q, (cfg.hidden,)), (cfg.hidden, (inter, inter)),
             (inter, (cfg.hidden,))]
    products = [(rows, k, ns) for k, ns in layer] * cfg.layers
    for m, k, ns in products + [(head_rows, cfg.hidden, (cfg.vocab_size,))]:
        if w8a8._route(m, k, True) == "wgmma":
            wgmma, quant = wgmma + 1, quant + 1
            plan = w8a8._gemm_plan(m, k, ns, w8a8._sms(0))
            few += w8a8._few_rows(plan)
            kinds[w8a8._plan_kind(plan, ns)] += 1
            long += w8a8._quant_plan(m, k, kind, w8a8._sms(0))[0] >= w8a8._Q_LONG
        else:
            small += 1
            short += w8a8._qgemm_short(k, ns)
    return (small, wgmma, quant, few, long, kinds["bands"], kinds["shared"], kinds["few_rows"],
            short)


def _w8a8_counts() -> tuple:
    """W8A8_COUNTS launches counted by the W8A8 wrappers since
    zero_launches()."""
    from rag_inference_pipeline_tpu_torch.ops import w8a8

    kinds = w8a8.w8a8_gemm.plan_launches
    return (w8a8.w8a8_qgemm.launches, w8a8.w8a8_gemm.launches,
            w8a8.quantize_rows.launches, w8a8.w8a8_gemm.few_tile_launches,
            w8a8.quantize_rows.long_row_launches, kinds["bands"], kinds["shared"],
            kinds["few_rows"], w8a8.w8a8_qgemm.short_launches)


def _few_rows_kernel(name: str) -> bool:
    """Whether a profiler's kernel name is an instance of the wgmma GEMM
    for few rows: 64 columns, or K split over a cluster (mode 1, or 3 with
    the operands swapped), as the demangled "w8a8_wgmma_kernel<consumers,
    bn, mode, ..." or the mangled "w8a8_wgmma_kernelILi..ELi..ELi..E"
    names it."""
    found = (re.search(r"w8a8_wgmma_kernel<(\d+), (\d+), (\d+)", name)
             or re.search(r"w8a8_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name))
    return bool(found) and (found.group(2) == "64" or found.group(3) in ("1", "3"))


def _path_logit_gap(params, cfg, ids, mask, toks, gamma: int):
    """Greedy's tokens `toks` [B, n] teacher-forced through both decode
    paths: one qwen_decode_step a token (greedy's) and windows of gamma + 1
    through qwen_extend (a verify round's, every draft accepted) -> (the
    largest |difference| of the two paths' f32 logits for the same token;
    the decoder's own noise, the largest |difference| the decode steps
    show when every embedding element is nudged by 2^-22 of itself, a
    seeded sign each; the decode steps' logits [B, n, V], entry j
    predicting toks[:, j]). Where the two paths' logits differ by at most
    d, their argmaxes can differ only where greedy's best and the other
    token lie within 2 d."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    b, t = ids.shape
    n = toks.shape[1]
    s = t + n + gamma + 1

    def steps():  # entry j predicts toks[:, j], on greedy_generate's cache length
        st = qwen._GreedyState(cfg, b, t + n, t + n, params.final_ln.dtype, ids.device)
        logits, _ = qwen.qwen_prefill(params, cfg, ids, mask, st.cache)
        out = [logits]
        for j in range(n - 1):
            logits, _ = qwen.qwen_decode_step(params, cfg, toks[:, j], st.cache)
            out.append(logits)
        return torch.stack(out, 1)

    step = steps()
    embed = qwen._embed_rows
    gen = torch.Generator(device=ids.device).manual_seed(5)

    def nudged(p, tokens):
        e = embed(p, tokens)
        sign = torch.randint(0, 2, e.shape, generator=gen, device=e.device) * 2 - 1
        return e * (1 + sign.to(e.dtype) * 2.0 ** -22)

    qwen._embed_rows = nudged
    try:
        noise = float((steps() - step).abs().max())
    finally:
        qwen._embed_rows = embed
    # verify windows from toks[:, k], k = 0, gamma + 1, ...: window entry i
    # predicts toks[:, k + i + 1]
    st = qwen._GreedyState(cfg, b, s, s, params.final_ln.dtype, ids.device)
    logits, _ = qwen.qwen_prefill(params, cfg, ids, mask, st.cache)
    gap = (logits - step[:, 0]).abs().max()
    for k in range(0, n - 1, gamma + 1):
        window = toks[:, k:min(k + gamma + 1, n - 1)]
        logits, _ = qwen.qwen_extend(params, cfg, window, st.cache)
        w = window.shape[1]
        gap = torch.maximum(gap, (logits - step[:, k + 1:k + 1 + w]).abs().max())
    return float(gap), noise, step


def _replay_speculation(params, cfg, ids, mask, toks, gamma: int) -> list:
    """The speculation's committed tokens `toks` [B, n] held to its own
    verify rounds, replayed eagerly here with the same windows: the
    prefill's argmax, then rounds of one qwen_extend over every row's
    window (its last committed token and the gamma bigram drafts its
    committed tokens give) from its committed prefix. A round commits a
    row's argmaxes up to and including the first one its draft missed (at
    most what the row still lacks); rows already full run and commit
    nothing, as in the batched rounds. -> [(row, step)]: where a committed
    token is not the argmax of its window, the first of each row (empty
    where every token was verified)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    b, t = ids.shape
    n = toks.shape[1]
    dev = ids.device
    cache = qwen.KVCache.zeros(cfg.layers, b, t + n + gamma + 1, cfg.kv_heads,
                               cfg.head_dim, dtype=params.final_ln.dtype, device=dev,
                               grid=qwen.cache_grid(params))
    logits, _ = qwen.qwen_prefill(params, cfg, ids, mask, cache)
    got = toks.tolist()
    first = torch.argmax(logits, dim=-1).tolist()
    bad = {i: 0 for i in range(b) if got[i][0] != first[i]}
    prompts, plen = ids.to(torch.int32), mask.sum(dim=1).to(torch.int32)
    done = [1] * b
    for _ in range(n):
        if all(done[i] >= n or i in bad for i in range(b)):
            break
        last = [got[i][done[i] - 1] for i in range(b)]
        prev = [got[i][done[i] - 2] if done[i] >= 2 else last[i] for i in range(b)]
        pair = torch.tensor([prev, last], dtype=torch.int32, device=dev).T.contiguous()
        drafts = qwen.bigram_draft(prompts, plen, pair, gamma=gamma)
        window = torch.cat([pair[:, 1:], drafts], dim=1)
        length = cache.length.clone()
        logits, _ = qwen.qwen_extend(params, cfg, window, cache)
        targets = torch.argmax(logits, dim=-1).tolist()
        drafts = drafts.tolist()
        take = [0] * b
        for i in range(b):
            if done[i] >= n or i in bad:
                continue
            hits = next((j for j in range(gamma) if drafts[i][j] != targets[i][j]), gamma)
            take[i] = min(hits + 1, n - done[i])
            miss = next((j for j in range(take[i])
                         if got[i][done[i] + j] != targets[i][j]), None)
            if miss is not None:
                bad[i] = done[i] + miss
            done[i] += take[i]
        cache.length.copy_(length + torch.tensor(take, dtype=length.dtype, device=dev))
    return sorted(bad.items())


def _int8_spec_readings(params, cfg, ids, mask, greedy, toks, gamma: int) -> dict:
    """What `_hold_int8_speculation` holds the int8 speculation's tokens
    `toks` to, beside int8 greedy's `greedy` (both [B, n]): the verify
    round's path gap and the decoder's noise (`_path_logit_gap`), greedy's
    top-two gaps and, a step, how far below greedy's best logit the
    speculation's token lies (`lag`, [B, n]), and the committed tokens
    that are not their verify window's argmax (`_replay_speculation`)."""
    import torch

    path_gap, noise, step = _path_logit_gap(params, cfg, ids, mask, greedy, gamma)
    top = step.topk(2, dim=-1).values
    lag = step.amax(dim=-1) - step.gather(-1, toks.long()[..., None])[..., 0]
    out = {"path_gap": path_gap, "noise": noise, "gaps": top[..., 0] - top[..., 1],
           "lag": lag, "greedy": greedy.tolist(), "toks": toks.tolist(),
           "steps_equal_greedy": bool(torch.equal(step.argmax(dim=-1).to(greedy.dtype),
                                                  greedy))}
    del step, top
    torch.cuda.empty_cache()
    out["unverified"] = _replay_speculation(params, cfg, ids, mask, toks, gamma)
    return out


def _hold_int8_speculation(r: dict) -> dict:
    """The int8 speculation held, from `_int8_spec_readings`: every
    committed token is the argmax of the verify window that committed it
    (exact: a speculation that commits an unverified draft fails here);
    the verify round's logits lie within INT8_PATH_NOISE x the decoder's
    own noise of the decode step's on greedy's tokens; and a row leaves
    greedy's only at a step where its token lies within twice that path
    gap below greedy's best logit. The two paths quantize rows that differ
    in the last bits (attention sums over 9 rows and over 1 in another
    order), and one int8 step more or less moves a logit far past f32
    noise: the f32 rule's NEAR_TIE cannot hold under W8A8."""
    check(not r["unverified"], f"decode_w8a8 spec: (row, step) {r['unverified'][:4]}: a "
          "committed token is not the argmax of the verify round that committed it")
    path_gap, noise = r["path_gap"], r["noise"]
    check(path_gap <= INT8_PATH_NOISE * noise, f"decode_w8a8 spec: the verify round's "
          f"logits lie {path_gap:.4g} from the decode step's on greedy's tokens, beyond "
          f"{INT8_PATH_NOISE} x the decoder's own noise {noise:.4g}")
    lag = r["lag"]
    return _hold_to_greedy("decode_w8a8 spec", r["toks"], r["greedy"],
                           lambda i, j: lag[i, j], tie=max(NEAR_TIE, 2 * path_gap),
                           what="its token and greedy's best logit lie")


def _int8_speculation(cfg, params, ids, mask, n: int = DECODE_NEW) -> dict:
    """ngram_speculative_generate over int8 weights at B = 8, gamma 8, `n`
    new tokens: the verify round's 72 rows take the wgmma route, q/k/v, o
    and down on the plan for few row tiles. In float32 activations (weights quantized at
    the source from seed 1, so that the near-tie rule of phase spec
    applies): rows held to int8 greedy's; the W8A8 launches of the call
    (the prefill and the capture's warm-up round, counted from zero just
    before) equal to the route rule's; one replayed round's W8A8 kernels
    from a torch.profiler trace. Then on the bf16 int8 tree `params`: ms a
    token and commits a call beside its greedy."""
    import torch
    from torch.autograd import DeviceType
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen

    b, gamma = ids.shape[0], SPEC_GAMMA
    g = torch.Generator(device=DEVICE).manual_seed(1)
    fparams = qwen.init_qwen_params(cfg, generator=g, dtype=torch.float32,
                                    device=torch.device(DEVICE), quantize=True)
    stats = {}
    greedy = qwen.greedy_generate(fparams, cfg, ids, mask, n, eos_token_id=-1)
    zero_launches()
    toks, _ = qwen.ngram_speculative_generate(fparams, cfg, ids, mask, n, gamma=gamma,
                                              eos_token_id=-1)
    launches = _w8a8_counts()
    rows = b * (gamma + 1)
    round_rule = w8a8_launches(cfg, rows, rows, "float32")
    want = tuple(p + r for p, r in zip(w8a8_launches(cfg, ids.numel(), b, "float32"),
                                       round_rule))
    check(launches == want, f"decode_w8a8 spec: {W8A8_COUNTS} launches {launches}, "
          f"not {want}")
    check(launches[3] > 0, "decode_w8a8 spec: no launch on the plan for few row tiles")
    readings = _int8_spec_readings(fparams, cfg, ids, mask, greedy, toks, gamma)
    held = _hold_int8_speculation(readings)
    (_, mean), f32_spec_s = _wall(lambda: qwen.ngram_speculative_generate(
        fparams, cfg, ids, mask, n, gamma=gamma, eos_token_id=-1))
    _, f32_greedy_s = _wall(lambda: qwen.greedy_generate(fparams, cfg, ids, mask, n,
                                                         eos_token_id=-1))
    # one replayed verify round: its W8A8 kernels, and those on a plan for
    # few rows (the GEMM's 64-column and split-K instances)
    entry = next(e for e in decode_graph.graphs_of(fparams).entries() if hasattr(e, "flag"))
    entry.state.cache.zero_()
    entry.state.start(fparams, cfg, ids, mask, -1, n)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        entry.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if names:
        w8 = sum("w8a8" in x or "quantize_rows" in x for x in names)
        few = sum(_few_rows_kernel(x) for x in names)
        check((w8, few) == (sum(round_rule[:3]), round_rule[3]),
              f"decode_w8a8 spec: a replayed round runs {w8} W8A8 kernels, {few} of them "
              f"few-tile, not {sum(round_rule[:3])} and {round_rule[3]}")
        stats.update(int8_spec_round_w8a8_kernels=w8, int8_spec_round_few_tile_kernels=few)
    del fparams, entry, prof
    gc.collect()
    torch.cuda.empty_cache()
    # the bf16 int8 tree: its greedy graph is captured; the first call
    # captures the verify round
    qwen.ngram_speculative_generate(params, cfg, ids, mask, n, gamma=gamma, eos_token_id=-1)
    (bf_toks, bf_mean), bf_spec_s = _wall(lambda: qwen.ngram_speculative_generate(
        params, cfg, ids, mask, n, gamma=gamma, eos_token_id=-1))
    bf_greedy, bf_greedy_s = _wall(lambda: qwen.greedy_generate(params, cfg, ids, mask, n,
                                                               eos_token_id=-1))
    stats.update({
        "int8_spec_identical_rows": held["identical"],
        "int8_path_logit_gap": f"{readings['path_gap']:.5g}",
        "int8_nudge_logit_gap": f"{readings['noise']:.5g}",
        "int8_top2_gap_median": f"{float(readings['gaps'].median()):.4g}",
        "int8_spec_tokens_replayed": toks.numel(),
        "int8_spec_max_lag_at_divergence": max((g for _, _, g in held["near_ties"]),
                                               default=0.0),
        "int8_steps_path_equals_greedy": readings["steps_equal_greedy"],
        "int8_spec_near_ties": json.dumps(held["near_ties"]),
        "int8_spec_launches": json.dumps(launches),
        "int8_f32_commits_per_call": f"{float(mean):.4f}",
        "int8_f32_spec_ms_per_token": f"{f32_spec_s / n * 1e3:.3f}",
        "int8_f32_greedy_ms_per_token": f"{f32_greedy_s / n * 1e3:.3f}",
        "int8_bf16_commits_per_call": f"{float(bf_mean):.4f}",
        "int8_bf16_spec_ms_per_token": f"{bf_spec_s / n * 1e3:.3f}",
        "int8_bf16_greedy_ms_per_token": f"{bf_greedy_s / n * 1e3:.3f}",
        # bf16 rounds attention otherwise over 9 rows than over 1: printed,
        # not held (the rule is held in f32 above)
        "int8_bf16_spec_rows_equal_greedy": sum(
            a == r for a, r in zip(bf_toks.tolist(), bf_greedy.tolist())),
    })
    return {"stats": stats, "launches": launches}


def phase_decode_w8a8(bf16_stats: dict) -> dict:
    """greedy_generate over int8 weights quantized at the source: the step
    graph against the eager loop at B = 8, beside decode_graph's bf16."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    t0 = time.perf_counter()
    cfg = qwen.QwenConfig.qwen25_05b()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    params = qwen.init_qwen_params(cfg, generator=g, dtype=torch.bfloat16,
                                   device=torch.device(DEVICE), quantize=True)
    n, b = DECODE_NEW, MAIN_B
    with torch.inference_mode():
        # decode_graph's B = 8 prompts
        st, launches, (ids, mask) = _greedy_against_eager("decode_w8a8", params, cfg, b, True)
        spec = _int8_speculation(cfg, params, ids, mask)
    step = w8a8_launches(cfg, b, b)
    stats = {k.replace("b8_", "int8_b8_", 1): v for k, v in st.items()}
    stats.update({
        "bf16_b8_eager_ms_per_token": bf16_stats["b8_eager_ms_per_token"],
        "bf16_b8_graph_ms_per_token": bf16_stats["b8_graph_ms_per_token"],
        "bf16_b8_pool_mb": bf16_stats["b8_pool_mb"],
        "small_launches": launches[0], "wgmma_launches": launches[1],
        "quantize_launches": launches[2], "few_tile_launches": launches[3],
        "w8a8_kernels_a_step_by_rule": sum(step[:3]), **spec["stats"],
        "weights_mb": f"{sum(t.numel() * t.element_size() for t in params.state_dict().values()) / 2**20:.1f}",
    })
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("decode_w8a8", t0, bit_identical=True, new_tokens=n, batch=b,
          prompt_bucket=DECODE_BUCKET, gamma=SPEC_GAMMA, **stats)
    return {**stats, "spec_launches": spec["launches"]}


def _engine_against_greedy(name: str, params, cfg, requests: int = ENGINE_REQUESTS) -> dict:
    """A DecodeEngine over the float32 tree `params` (32 lanes, cache 1024,
    segment 8), plain and speculative: `requests` prompts of 64-512
    tokens in the decoder's vocabulary with budgets of 16-128, each
    sequence its budget long and held to a solo greedy_generate under the
    near-tie rule -> stats (wall, segments, tokens, capture s, pool MB)."""
    import asyncio

    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
    from rag_inference_pipeline_tpu_torch.models import qwen

    rng = np.random.default_rng(31)
    lens = rng.integers(64, 513, requests)
    budgets = rng.integers(16, 129, requests)
    prompts = [rng.integers(1000, cfg.vocab_size - 1, int(k)).astype(np.int32) for k in lens]
    eos = -1
    refs = []
    with torch.inference_mode():
        for p, m in zip(prompts, budgets):
            ids = torch.from_numpy(p[None]).to(DEVICE)
            refs.append(qwen.greedy_generate(params, cfg, ids, torch.ones_like(ids),
                                             int(m), eos_token_id=eos)[0].tolist())

    def gap_of(i, j):  # the eager loop up to the step where row i diverges
        ids = torch.from_numpy(prompts[i][None]).to(DEVICE)
        with torch.inference_mode():
            _, gaps = _top2_gaps(params, cfg, ids, torch.ones_like(ids), j + 1,
                                 cache_len=ids.shape[1] + int(budgets[i]))
        return gaps[0, j]

    stats = {}
    for spec in (False, True):
        eng = DecodeEngine(params, cfg, lanes=ENGINE_LANES, cache_len=ENGINE_CACHE,
                           segment_steps=ENGINE_SEGMENT, eos_token_id=eos,
                           admit_buckets=(1, 2, 4, 8, 16, 32),
                           prefill_buckets=(128, 256, 512), speculative=spec,
                           gamma=SPEC_GAMMA)

        async def main():
            await eng.start()
            try:
                return await asyncio.gather(*(eng.submit(p, int(m))
                                              for p, m in zip(prompts, budgets)))
            finally:
                await eng.stop()

        outs, wall = _wall(lambda: asyncio.new_event_loop().run_until_complete(main()))
        tag = "spec" if spec else "plain"
        check(all(len(o) == m for o, m in zip(outs, budgets)),
              f"{name} ({tag}): a request returned other than its budget")
        held = _hold_to_greedy(f"{name} ({tag})", outs, refs, gap_of)
        stats.update({f"{tag}_wall_s": f"{wall:.3f}",
                      f"{tag}_identical": held["identical"],
                      f"{tag}_near_ties": json.dumps(held["near_ties"]),
                      f"{tag}_segments": eng.segments,
                      f"{tag}_tokens": eng.tokens_generated,
                      f"{tag}_capture_s": f"{eng.graph.capture_s:.3f}",
                      f"{tag}_pool_mb": f"{eng.graph.pool_bytes / 2**20:.1f}"})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return stats


def phase_engine():
    """`_engine_against_greedy` over Qwen2.5-0.5B at full width in
    float32."""
    import torch

    t0 = time.perf_counter()
    cfg, params = _decoder("float32")
    stats = _engine_against_greedy("engine", params, cfg)
    del params
    torch.cuda.empty_cache()
    phase("engine", t0, requests=ENGINE_REQUESTS, lanes=ENGINE_LANES,
          cache_len=ENGINE_CACHE, segment=ENGINE_SEGMENT, **stats)
    return stats


def phase_engine_serve(ivf, db_path: str) -> dict:
    """The staged server under the decode engine, then with speculation
    too: a second request alone, 16 concurrent requests; K5 counted per
    run."""
    from rag_inference_pipeline_tpu_torch.ops.ivf import ivf_dedup_scores

    t0 = time.perf_counter()
    texts = [" ".join(["what does the corpus say about"] + [f"topic {i}"] * (1 + i % 5))
             for i in range(18)]
    stats = {}
    for tag, extra in (("engine", {"USE_CONTINUOUS_BATCHING": "1"}),
                       ("engine_spec", {"USE_CONTINUOUS_BATCHING": "1",
                                        "USE_SPECULATIVE_DECODING": "1"})):
        server, th = _serve({**STAGED_ENV, "DOCUMENT_DB_PATH": db_path, **extra}, ivf)
        port = server.server_address[1]
        try:
            eng = server.app.components["llm"].engine
            check(eng is not None and eng.speculative == (tag == "engine_spec"),
                  f"{tag}: the decode engine is not running")
            zero_launches()
            results = [_post(port, texts[0], "e0"), _post(port, texts[1], "e1")]
            conc = [None] * 16

            def ask(i):
                conc[i] = _post(port, texts[2 + i], f"e{2 + i}")

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
            peak, running = [0], [True]

            def sample():  # the most lanes the engine held at once
                while running[0]:
                    peak[0] = max(peak[0], eng.active_lanes)
                    time.sleep(0.005)

            sampler = threading.Thread(target=sample, daemon=True)
            tc = time.perf_counter()
            sampler.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
                check(not t.is_alive(), f"{tag}: a concurrent /query did not finish")
            wall = time.perf_counter() - tc
            running[0] = False
            sampler.join(timeout=10)
            k5 = ivf_dedup_scores.launches
            seg, toks, active = eng.segments, eng.tokens_generated, eng.lanes_active
        finally:
            _stop(server, th)
        for i, (status, body, _) in enumerate(results + conc):
            check(status == 200, f"{tag} /query {i}: HTTP {status}")
            check(body["request_id"] == f"e{i}", f"{tag} /query {i}: wrong request_id")
        check(k5 >= 1, f"{tag}: /query did not run K5")
        stats.update({f"{tag}_second_s": round(results[1][2], 4),
                      f"{tag}_concurrent16_wall_s": round(wall, 4),
                      f"{tag}_segments": seg, f"{tag}_tokens": toks,
                      f"{tag}_peak_lanes": peak[0], f"{tag}_lanes_active_after": active,
                      f"{tag}_k5_launches": k5})
    phase("engine_serve", t0, **stats)
    return stats


# ---------------------------------------------------------------------------
# The Llama family at full width, random weights from a seed
# ---------------------------------------------------------------------------

LLAMA_8B_NAME = "meta-llama/Llama-3.1-8B-Instruct"
# the 8B's speculation holds (the int8 rule, the f32 near-tie rule) over
# this many new tokens: their eager replays take ~0.1 s a token at 8B depth
LLAMA_SPEC_NEW = 32
# the Llama greedy checks' eager loops: the first 16 of the graph's
# DECODE_NEW tokens (~0.1 s a token eagerly at the 8B)
LLAMA_EAGER_NEW = 16
# the f32 8B engine's prompts, each held to a solo f32 greedy call (~22 ms
# a token at B = 1)
LLAMA_F32_ENGINE_REQUESTS = 8
# llama_serve's concurrent /query after its first two (~2.7 s each)
LLAMA_SERVE_CONCURRENT = 4


def _llama_tree(cfg, quantize: bool, dtype, seed: int = 0):
    """A Llama preset at full width from `seed`, int8 at the source with
    `quantize` (each leaf quantized as it is drawn) -> (tree, its load
    seconds, weight GB and the device's peak GB over the load above what
    was allocated before)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    params = qwen.init_qwen_params(cfg, generator=g, dtype=dtype,
                                   device=torch.device(DEVICE), quantize=quantize)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in params.state_dict().values())
    return params, {"load_s": f"{load_s:.3f}", "weights_gb": f"{weights / 1e9:.3f}",
                    "load_peak_gb": f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}"}


def _free_tree() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_llama_8b(quantize: bool) -> dict:
    """Llama-3.1-8B at full width and depth (32 layers, bf16 activations),
    bf16 weights or W8A8 quantized at the source: greedy at B = 8 and 1
    (`_greedy_against_eager`), then speculation at B = 8, gamma 8. bf16: ms a
    token (beside greedy's over as many tokens) and commits a call of its
    verify-round graph over LLAMA_SPEC_NEW tokens (the hold runs in float32,
    `phase_llama_8b_f32_spec`). W8A8:
    decode_w8a8's int8 speculation over LLAMA_SPEC_NEW tokens
    (`_int8_speculation`: in f32 activations every committed token its
    verify window's argmax, the verify round's logits within
    INT8_PATH_NOISE x the decoder's own noise of the decode step's, rows
    leaving greedy's only within twice that gap; its launches the route
    rule's; one replayed round's W8A8 kernels; then on this tree ms a token
    and commits a call), then the decode engine on this tree
    (`_llama_engine`)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    t0 = time.perf_counter()
    cfg = qwen.QwenConfig.llama31_8b()
    tag = "int8" if quantize else "bf16"
    params, stats = _llama_tree(cfg, quantize, torch.bfloat16)
    launches = W8A8_NONE
    with torch.inference_mode():
        for b in (MAIN_B, 1):
            st, counted, prompts = _greedy_against_eager(f"llama_8b_{tag}", params, cfg, b,
                                                          quantize, LLAMA_EAGER_NEW)
            stats.update(st)
            launches = tuple(a + c for a, c in zip(launches, counted))
            if b == MAIN_B:
                ids, mask = prompts
        # greedy's step graph at the speculation's length, captured before
        # either side is timed
        n = LLAMA_SPEC_NEW
        greedy = lambda: qwen.greedy_generate(  # noqa: E731
            params, cfg, ids, mask, n, eos_token_id=-1)
        greedy()
        if quantize:
            spec = _int8_speculation(cfg, params, ids, mask, n)
            stats.update(spec["stats"])
            launches = tuple(a + c for a, c in zip(launches, spec["launches"]))
        else:
            run = lambda: qwen.ngram_speculative_generate(  # noqa: E731
                params, cfg, ids, mask, n, gamma=SPEC_GAMMA, eos_token_id=-1)
            (first, _), capture_s = _wall(run)
            (toks, mean), spec_s = _wall(run)
            check(torch.equal(toks, first), "llama_8b bf16 speculation: a second replay gave "
                  "other tokens")
            _, greedy_s = _wall(greedy)
            stats.update({"spec_first_call_s": f"{capture_s:.3f}",
                          "spec_ms_per_token": f"{spec_s / n * 1e3:.3f}",
                          "spec_greedy_ms_per_token": f"{greedy_s / n * 1e3:.3f}",
                          "spec_commits_per_call": f"{float(mean):.4f}"})
    phase(f"llama_8b_{tag}", t0, model=LLAMA_8B_NAME, layers=cfg.layers, new_tokens=DECODE_NEW,
          prompt_bucket=DECODE_BUCKET, gamma=SPEC_GAMMA, spec_new_tokens=LLAMA_SPEC_NEW,
          **stats)
    if quantize:
        engine = _llama_engine(params, cfg)
        launches = tuple(a + c for a, c in zip(launches, engine["launches"]))
    del params
    _free_tree()
    return {"launches": launches}


def phase_llama_8b_f32_spec() -> dict:
    """Llama-3.1-8B with float32 weights and activations from seed 1:
    ngram_speculative_generate against greedy_generate at B = 8, gamma 8,
    LLAMA_SPEC_NEW tokens, held as phase spec holds Qwen2.5-0.5B's: a row
    may leave greedy's only at a step whose two top f32 logits lie within
    NEAR_TIE. Then the decode engine on this tree, held to solo greedy as
    phase engine holds Qwen2.5-0.5B's (`_engine_against_greedy`): the
    check on the 8B engine's tokens from outside the engine, which the
    W8A8 tree's random weights leave no room for (`_llama_engine`)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    t0 = time.perf_counter()
    cfg = qwen.QwenConfig.llama31_8b()
    n = LLAMA_SPEC_NEW
    params, stats = _llama_tree(cfg, False, torch.float32, seed=1)
    with torch.inference_mode():
        ids, mask = _decode_prompts(MAIN_B, seed=21, vocab=cfg.vocab_size)
        (spec, mean), spec_s = _wall(lambda: qwen.ngram_speculative_generate(
            params, cfg, ids, mask, n, gamma=SPEC_GAMMA, eos_token_id=-1))
        greedy, greedy_s = _wall(lambda: qwen.greedy_generate(
            params, cfg, ids, mask, n, eos_token_id=-1))
        gaps = None
        if not torch.equal(spec, greedy):
            _, gaps = _top2_gaps(params, cfg, ids, mask, n)
        held = _hold_to_greedy("llama_8b_f32_spec", spec.tolist(), greedy.tolist(),
                               lambda i, j: gaps[i, j])
    stats.update(identical_rows=held["identical"], near_ties=json.dumps(held["near_ties"]),
                 commits_per_call=f"{float(mean):.4f}",
                 spec_first_call_s=f"{spec_s:.3f}", greedy_first_call_s=f"{greedy_s:.3f}")
    phase("llama_8b_f32_spec", t0, gamma=SPEC_GAMMA, new_tokens=n, batch=MAIN_B, **stats)
    t1 = time.perf_counter()
    engine = _engine_against_greedy("llama_8b_f32_engine", params, cfg,
                                    LLAMA_F32_ENGINE_REQUESTS)
    del params
    _free_tree()
    phase("llama_8b_f32_engine", t1, model=LLAMA_8B_NAME, requests=LLAMA_F32_ENGINE_REQUESTS,
          lanes=ENGINE_LANES, cache_len=ENGINE_CACHE, segment=ENGINE_SEGMENT, **engine)
    return stats


def _llama_engine(params, cfg) -> dict:
    """A DecodeEngine over the 8B W8A8 tree `params` at the settings' 32
    lanes, cache 1024, segment 8, plain and speculative, over
    ENGINE_REQUESTS prompts of 64-512 tokens with budgets of 16-128: every
    sequence its budget long, in the vocabulary; then the 16 prompts
    admitted again and one segment replayed as the engine's graph against
    the same body run eagerly from the same state, every state tensor bit
    for bit (the emission buffer but its scratch column): both sides run
    the same kernels, so this holds the graph, not the arithmetic; the
    8B engine's tokens are held to solo greedy in float32
    (phase_llama_8b_f32_spec). Solo greedy is no yardstick for this tree:
    at this depth the W8A8 decoder with random weights moves its logits by
    more than a logit under a 2^-22 nudge of its inputs (phase
    llama_8b_int8's int8_nudge_logit_gap), and the engine's attention over
    1,024 keys sums in another order than a solo call's."""
    import asyncio

    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine, _Request

    t0 = time.perf_counter()
    rng = np.random.default_rng(31)
    lens = rng.integers(64, 513, ENGINE_REQUESTS)
    budgets = rng.integers(16, 129, ENGINE_REQUESTS)
    prompts = [rng.integers(1000, cfg.vocab_size - 1, int(k)).astype(np.int32) for k in lens]
    stats, launches = {}, W8A8_NONE
    for spec in (False, True):
        tag = "spec" if spec else "plain"
        eng = DecodeEngine(params, cfg, lanes=ENGINE_LANES, cache_len=ENGINE_CACHE,
                           segment_steps=ENGINE_SEGMENT, eos_token_id=-1,
                           admit_buckets=(1, 2, 4, 8, 16, 32),
                           prefill_buckets=(128, 256, 512), speculative=spec,
                           gamma=SPEC_GAMMA)

        async def main():
            await eng.start()
            try:
                return await asyncio.gather(*(eng.submit(p, int(m))
                                              for p, m in zip(prompts, budgets)))
            finally:
                await eng.stop()

        zero_launches()
        outs, wall = _wall(lambda: asyncio.new_event_loop().run_until_complete(main()))
        counted = _w8a8_counts()
        launches = tuple(a + c for a, c in zip(launches, counted))
        check(all(len(o) == m for o, m in zip(outs, budgets)),
              f"llama_engine ({tag}): a request returned other than its budget")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"llama_engine ({tag}): a token out of the vocabulary")
        check(counted[0] > 0 and counted[1] > 0 and counted[4] > 0,
              f"llama_engine ({tag}): the W8A8 kernels did not launch ({counted})")
        # one segment: the graph against the eager body from the same state
        for p, m in zip(prompts, budgets):
            eng._waiting.put_nowait(_Request(p, int(m), None))
        with torch.inference_mode():
            eng._admit_waiting()
            state = [eng.cache.k, eng.cache.v, eng.cache.length, eng.tokens, eng.done,
                     eng.emit_buf, eng.counts, eng.limits, eng.prompts, eng.prompt_len]
            before = [t.clone() for t in state]
            eng.graph.replay()
            replayed = [t.clone() for t in state]
            for t, b in zip(state, before):
                t.copy_(b)
            eng._segment_body()
            torch.cuda.synchronize()
            # but the emission buffer's last column: a verify round's masked
            # writes land there in no fixed order, and nothing reads it
            scratch = eng.emit_buf.shape[1] - 1
            replayed[5], state[5] = replayed[5][:, :scratch], state[5][:, :scratch]
            check(all(torch.equal(a, b) for a, b in zip(replayed, state)),
                  f"llama_engine ({tag}): the segment graph and the eager segment differ")
            check(not torch.equal(replayed[5], before[5]),
                  f"llama_engine ({tag}): the segment emitted nothing")
        stats.update({f"{tag}_wall_s": f"{wall:.3f}",
                      f"{tag}_segments": eng.segments,
                      f"{tag}_tokens": eng.tokens_generated,
                      f"{tag}_capture_s": f"{eng.graph.capture_s:.3f}",
                      f"{tag}_pool_mb": f"{eng.graph.pool_bytes / 2**20:.1f}",
                      f"{tag}_w8a8_launches": json.dumps(counted)})
        del eng, state, before, replayed
        _free_tree()
    phase("llama_engine", t0, model=LLAMA_8B_NAME, requests=ENGINE_REQUESTS,
          lanes=ENGINE_LANES, cache_len=ENGINE_CACHE, segment=ENGINE_SEGMENT,
          segment_bit_identical=True, **stats)
    return {"launches": launches}


def phase_llama_serve(paths: dict, workdir: str) -> dict:
    """The fused server of phase serve with LLM_MODEL=Llama-3.1-8B-Instruct
    and LLM_WEIGHT_QUANT=int8 (the reference's one-chip deployment), warm-up
    on, over phase corpus's 1M x 768 int8 index (bf16 re-score on the card)
    and 48-token documents drawn in the 8B's 128,256-token vocabulary:
    two /query and LLAMA_SERVE_CONCURRENT at once with well-formed bodies, K1 and
    every W8A8 kernel launching; /health's clamped ladder (`llm_ladder`)
    and decode graphs."""
    import numpy as np
    from rag_inference_pipeline_tpu_torch.models import qwen
    from rag_inference_pipeline_tpu_torch.models.layers import QuantizedLinear

    t0 = time.perf_counter()
    vocab = qwen.QwenConfig.llama31_8b().vocab_size
    rng = np.random.default_rng(4)
    toks = rng.integers(1000, vocab, (N_ROWS, DOC_LEN), dtype=np.int32)
    lengths = rng.integers(8, DOC_LEN + 1, N_ROWS)
    mask = (np.arange(DOC_LEN)[None, :] < lengths[:, None]).astype(np.int32)
    tok_path = os.path.join(workdir, "llama_doc_tokens.npy")
    np.save(tok_path, toks * mask)
    np.save(tok_path.replace(".npy", "_mask.npy"), mask)
    del toks, mask
    llama_paths = {"INDEX_PATH": paths["INDEX_PATH"], "DOC_TOKENS_PATH": tok_path}
    phase("llama_doc_tokens", t0, rows=N_ROWS, doc_len=DOC_LEN, vocab=vocab)
    tag = "llama_serve"
    executor, _, stats, _, health = phase_serve(
        llama_paths, {"LLM_MODEL": LLAMA_8B_NAME, "LLM_WEIGHT_QUANT": "int8",
                      "WARMUP_BUCKETS": "1"}, tag, LLAMA_SERVE_CONCURRENT)
    llm = executor.llm
    check(llm.cfg == qwen.QwenConfig.llama31_8b(), f"{tag}: the LLM is not the 8B")
    check(isinstance(llm.params.lm_head, QuantizedLinear),
          f"{tag}: the 8B's head is not int8")
    check(tuple(health["llm_ladder"]) == llm.ladder and 1 in llm.ladder,
          f"{tag}: /health's ladder {health['llm_ladder']} is not the LLM's {llm.ladder}")
    check(stats["w8a8_small_launches"] > 0 and stats["w8a8_wgmma_launches"] > 0
          and stats["quantize_rows_launches"] > 0,
          f"{tag}: a W8A8 kernel did not launch on /query ({stats})")
    del executor, llm
    _free_tree()
    return stats


def phase_llama_1b() -> dict:
    """Llama-3.2-1B at full width and depth (16 layers, tied 128,256-row
    head), bf16 and W8A8 quantized at the source: `_greedy_against_eager` at B = 8
    (graph against eager bit for bit, ms a token, capture, pool, kernels a
    step)."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    t0 = time.perf_counter()
    cfg = qwen.QwenConfig.llama32_1b()
    stats, launches = {}, W8A8_NONE
    with torch.inference_mode():
        for quantize in (False, True):
            tag = "int8" if quantize else "bf16"
            params, load = _llama_tree(cfg, quantize, torch.bfloat16)
            st, counted, _ = _greedy_against_eager(f"llama_1b_{tag}", params, cfg, MAIN_B,
                                                 quantize, LLAMA_EAGER_NEW)
            stats.update({f"{tag}_{k}": v for k, v in {**load, **st}.items()})
            launches = tuple(a + c for a, c in zip(launches, counted))
            del params
            _free_tree()
    phase("llama_1b", t0, model="meta-llama/Llama-3.2-1B-Instruct", layers=cfg.layers,
          new_tokens=DECODE_NEW, prompt_bucket=DECODE_BUCKET, **stats)
    return {"launches": launches}


# the data-parallel slice on one card: the mesh's positions repeat cuda:0
MESH_DP, FUSED_DP, SPMD_PROCS = 4, 2, 2


def _one_card_mesh(dp: int, tp: int = 1):
    from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh

    return make_mesh(dp=dp, tp=tp, devices=force_host_devices(
        dp * tp, f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE))


def _near_ties(name: str, got_s, got_i, ref_s, ref_i, rows_of) -> list:
    """Ids of a kernel's search against its plain version's: scores within
    TOL, and where an id differs, the two candidates' exact scores (float64
    over the stored rows, `rows_of(ids)`) tie within TOL["atol"]."""
    import torch

    check(torch.allclose(got_s, ref_s, **TOL), f"{name}: scores differ from the plain search")
    differ = got_i != ref_i
    gaps = []
    if differ.any():
        gaps = (rows_of(got_i) - rows_of(ref_i)).abs()[differ].tolist()
    check(all(g <= TOL["atol"] for g in gaps), f"{name}: ids differ beyond a near-tie: {gaps}")
    return gaps


def _shortlist_ties(name: str, got_s, got_i, wide_s, wide_i) -> list:
    """A kernel's shortlist [B, w] against its plain version's searched
    deeper [B, w + extra]: scores within TOL position by position, and each
    id that differs found in the plain list at a score within TOL["atol"]
    of the kernel's (a near-tie). Returns those gaps."""
    import torch

    w = got_s.shape[1]
    check(torch.allclose(got_s, wide_s[:, :w], **TOL), f"{name}: scores differ from plain")
    gaps = []
    for r, c in (got_i != wide_i[:, :w]).nonzero().tolist():
        hit = (wide_i[r] == got_i[r, c]).nonzero()
        check(hit.numel() == 1, f"{name}: id {int(got_i[r, c])} (row {r}) not in the plain list")
        gaps.append(abs(float(wide_s[r, hit[0, 0]] - got_s[r, c])))
    check(all(g <= TOL["atol"] for g in gaps), f"{name}: ids differ beyond a near-tie: {gaps}")
    return gaps


def phase_mesh_retrieve(corpus, queries, ivf, pq4):
    import copy

    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
    from rag_inference_pipeline_tpu_torch.ops import ivf as tivf
    from rag_inference_pipeline_tpu_torch.ops import pq as tpq
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk,
        binmax_partial_topk_int8gs,
        binmax_partial_topk_int8gs_plain,
        binmax_partial_topk_plain,
        exact_topk,
        sharded_topk,
        sharded_topk_int8gs,
    )
    from rag_inference_pipeline_tpu_torch.utils import cpuscan

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    mesh = _one_card_mesh(MESH_DP)
    k = 10
    with torch.inference_mode():
        ref = exact_topk(queries, corpus, k)[1].cpu().numpy()

    def recall(ids):
        return round(_recall([{"ids": r} for r in ids.cpu().tolist()], ref), 4)

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    stats = {}
    counters = {"int8": binmax_partial_topk_int8gs, "int8_host": binmax_partial_topk_int8gs,
                "bf16": binmax_partial_topk, "ivf_flat": tivf.ivf_dedup_scores,
                "pq4": tpq.ivfpq4_adc_scores}
    q8 = queries[:MAIN_B]
    for name, dtype, store in (("int8", "int8", "device"), ("int8_host", "int8", "host"),
                               ("bf16", "bfloat16", "device")):
        one = FlatIndex(DIM, dtype=dtype, device=dev, rescore_store=store, rescore_k=64)
        one.add(corpus)
        sh = FlatIndex(DIM, dtype=dtype, mesh=mesh, rescore_store=store, rescore_k=64)
        sh.add(corpus)
        torch.cuda.synchronize()
        shards = sh._db_i8 if dtype == "int8" else sh._db
        rescore = sh._db if dtype == "int8" and sh._db is not None else [None] * MESH_DP
        per_shard = [nbytes(a, b) for a, b in zip(shards, rescore)]
        zero_launches()
        s, i = sh.search(queries, k)
        torch.cuda.synchronize()
        launches = counters[name].launches
        check(launches == MESH_DP, f"mesh {name}: {launches} launches, not one a shard")
        with torch.inference_mode():
            if name == "int8":
                ps, pi = sharded_topk_int8gs(mesh, queries, sh._db_i8, sh._db_gscale, k,
                                             rescore_db_shards=sh._db, rescore_k=64,
                                             nbins=sh.nbins, ntotal=sh.ntotal,
                                             scan=binmax_partial_topk_int8gs_plain)
                check(torch.equal(i, pi), "mesh int8: ids differ from the plain sharded search")
                # K1 at B=8: every shard's launch against one over all rows
                qf = q8.float()
                q_scale = torch.clamp(qf.abs().amax(), min=1e-9) / 127.0
                q_i8 = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
                rows = sh._db_i8[0].shape[0]
                shard_ms = [cuda_ms(lambda c=c, r=r: binmax_partial_topk_int8gs(
                    q_i8, c, nbins=sh.nbins, ntotal=max(0, min(sh.ntotal - r * rows, rows))), 20)
                    for r, c in enumerate(sh._db_i8)]
                whole_ms = cuda_ms(lambda: binmax_partial_topk_int8gs(
                    q_i8, one._db_i8, nbins=one.nbins, ntotal=one.ntotal), 20)
                stats.update(k1_b8_shard_ms=[round(x, 5) for x in shard_ms],
                             k1_b8_shards_sum_ms=round(sum(shard_ms), 5),
                             k1_b8_dp1_ms=round(whole_ms, 5))
            elif name == "int8_host":
                s_k = min(max(sh.rescore_k, k + 32), sh.nbins)
                _, short = sharded_topk_int8gs(mesh, queries, sh._db_i8, sh._db_gscale, s_k,
                                               nbins=sh.nbins, ntotal=sh.ntotal,
                                               scan=binmax_partial_topk_int8gs_plain)
                _, pi = cpuscan.rescore_f16(queries.float().cpu().numpy(), sh._host_rescore,
                                            short.cpu().numpy(), k)
                check(np.array_equal(i.cpu().numpy(), pi),
                      "mesh int8_host: ids differ from the plain sharded search")
                per_shard = [nbytes(c) for c in sh._db_i8]
            else:
                ps, pi = sharded_topk(mesh, queries, sh._db, k, use_fused=True, nbins=sh.nbins,
                                      ntotal=sh.ntotal, scan=binmax_partial_topk_plain)
                qd = queries.to(torch.bfloat16).double()[:, None, :]
                db_rows = torch.cat(sh._db)
                stats["bf16_near_tie_gaps"] = _near_ties(
                    "mesh bf16", s, i, ps, pi,
                    lambda ids: (db_rows[ids.long()].double() * qd).sum(-1))
                del db_rows
            _, i1 = one.search(queries, k)
        stats[f"{name}_shard_bytes"] = per_shard
        stats[f"{name}_launches"] = launches
        stats[f"{name}_recall_dp{MESH_DP}"] = recall(i)
        stats[f"{name}_recall_dp1"] = recall(i1)
        del one, sh, shards, rescore
        gc.collect()
        torch.cuda.empty_cache()
    # IVF-Flat (K5) and IVF-PQ4 (K6): the built listings sharded (views, no
    # copy), each kernel once a shard, held to the same sharded search
    # through its plain version at the phase's shape (B=64)
    qd = queries.to(torch.bfloat16).double()[:, None, :]
    for name, index in (("ivf_flat", ivf), ("pq4", pq4)):
        sh = copy.copy(index)
        sh.mesh = mesh
        sh._maybe_shard()
        check(len(sh._shards) == MESH_DP, f"mesh {name}: not sharded")
        if name == "ivf_flat":
            per_shard = [nbytes(*lst) for lst in sh._shards]
        else:
            per_shard = [nbytes(lst.centroids, lst.code_buckets, lst.ids, lst.list_sizes)
                         for lst in sh._shards]
        zero_launches()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        with torch.inference_mode():
            s, i = sh.search(queries, k)
        torch.cuda.synchronize()
        stats[f"{name}_search64_s"] = round(time.perf_counter() - ts, 4)
        launches = counters[name].launches
        check(launches == MESH_DP, f"mesh {name}: {launches} launches, not one a shard")
        kw = dict(nprobe=sh.nprobe, nprobe_local=sh.nprobe_local)
        with torch.inference_mode():
            if name == "ivf_flat":
                ps, pi = tivf.sharded_ivf_search(mesh, sh._shards, queries, k,
                                                 scan=tivf.ivf_dedup_scores_plain, **kw)
                # warm, on CUDA events (a search reads each shard's slot
                # count on the host, so the span holds the host's share)
                stats["ivf_flat_search64_warm_ms"] = round(
                    cuda_ms(lambda: sh.search(queries, k), 3), 4)
                stats["ivf_flat_plain_search64_warm_ms"] = round(cuda_ms(
                    lambda: tivf.sharded_ivf_search(mesh, sh._shards, queries, k,
                                                    scan=tivf.ivf_dedup_scores_plain, **kw),
                    3), 4)
                stats["ivf_flat_near_tie_gaps"] = _near_ties(
                    "mesh ivf_flat", s, i, ps, pi,
                    lambda ids: (corpus[ids.long()].to(torch.bfloat16).double() * qd).sum(-1))
            else:
                # the ADC shortlist before any re-score: K6 at width w, its
                # plain version 16 deeper (a near-tie may swap across w)
                q = queries.float() if sh._rotation is None else queries.float() @ sh._rotation
                w = max(k, sh.rescore_k)
                ks, ki = tpq.sharded_ivfpq_search(mesh, sh._shards, q, w, **kw)
                ws, wi = tpq.sharded_ivfpq_search(mesh, sh._shards, q, w + 16,
                                                  scan=tpq.ivfpq4_adc_scores_plain, **kw)
                torch.cuda.synchronize()
                stats["pq4_shortlist"] = w
                stats["pq4_search64_warm_ms"] = round(cuda_ms(lambda: sh.search(queries, k), 3), 4)
                stats["pq4_near_tie_gaps"] = _shortlist_ties("mesh pq4", ks, ki, ws, wi)
            _, i1 = index.search(queries, k)
        stats[f"{name}_launches"] = launches
        stats[f"{name}_shard_bytes"] = per_shard
        stats[f"{name}_recall_dp{MESH_DP}"] = recall(i)
        stats[f"{name}_recall_dp1"] = recall(i1)
        del sh
    for name in counters:
        got, base = stats[f"{name}_recall_dp{MESH_DP}"], stats[f"{name}_recall_dp1"]
        check(got >= base, f"mesh {name}: recall@10 {got} at dp={MESH_DP} < {base} at dp=1")
    phase("mesh_retrieve", t0, dp=MESH_DP, batch=RETRIEVE_B, **stats)
    return stats


def phase_mesh_fused(paths: dict):
    import torch
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.ops.topk import (
        binmax_partial_topk_int8gs,
        binmax_partial_topk_int8gs_plain,
    )
    from rag_inference_pipeline_tpu_torch.serve import runtime

    t0 = time.perf_counter()
    mesh = _one_card_mesh(FUSED_DP)
    settings = load_settings({**SERVE_ENV, **paths})
    server = runtime.make_server(settings, port=0, mesh=mesh)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    load_s = time.perf_counter() - t0
    try:
        health = _get_health(port)
        check(all(health["components"].values()) and "mesh" in health["components"],
              f"not loaded: {health}")
        ex = server.executor
        check(ex.dp == FUSED_DP and len(ex.index._db_i8) == FUSED_DP,
              "the fused executor is not on the dp mesh")
        zero_launches()
        results = [_post(port, f"what does the corpus say about topic {i}?", f"d{i}")
                   for i in range(2)]
        launches = binmax_partial_topk_int8gs.launches
        for i, (status, body, _) in enumerate(results):
            check(status == 200 and body["request_id"] == f"d{i}", f"/query {i}: HTTP {status}")
        check(launches == FUSED_DP * len(results),
              f"K1 launched {launches} times for {len(results)} dp={FUSED_DP} steps")
        pipe, (ids, mask, lm_ids, lm_mask) = _step_inputs(ex)
        ts = time.perf_counter()
        out_k = pipe.step(ids, mask, lm_ids, lm_mask)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - ts
        out_p = pipe.step(ids, mask, lm_ids, lm_mask, scan=binmax_partial_topk_int8gs_plain)
        torch.cuda.synchronize()
    finally:
        _stop(server, th)
    check(torch.equal(out_k.doc_ids, out_p.doc_ids), "mesh fused: doc ids differ from plain")
    check(torch.equal(out_k.tokens, out_p.tokens), "mesh fused: tokens differ from plain")
    check(out_k.tokens.shape == (MAIN_B, pipe.max_new_tokens), "mesh fused: tokens shape")
    phase("mesh_fused", t0, dp=FUSED_DP, load_s=round(load_s, 3),
          first_s=round(results[0][2], 4), second_s=round(results[1][2], 4),
          k1_launches=launches, step8_s=round(step_s, 4), doc_ids_identical=True,
          tokens_identical=True)
    return {"launches": launches}


def _shard_bytes(tree, j: int) -> tuple[int, int]:
    """(split weight elements, split bias elements) of tp position j's
    shard: its layers' leaves but the norms, each int8 block or tensor
    counted once."""
    weights = biases = 0
    for key, t in tree.shards[j].state_dict().items():
        if not key.startswith("layers.") or key.endswith("_ln") or key.endswith(".s"):
            continue
        if key.endswith("_b"):
            biases += t.numel()
        else:
            weights += t.numel()
    return weights, biases


def _f32_activations(params):
    """`params` with its floating leaves in f32 (int8 blocks and their f32
    scales as they are): the same weights, run with f32 activations."""
    import torch
    from rag_inference_pipeline_tpu_torch.models.layers import ParamTree

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [conv(v) for v in t]
        return t if isinstance(t, torch.nn.Module) else t.float()

    return ParamTree(conv(params.to_tree()))


def _forced_logits(trees: dict, cfg, ids, mask, toks, steps: int) -> dict:
    """Every tree's f32 logits over the same tokens (`toks` [B, n], tp =
    1's greedy ones), eagerly: the prefill, then `steps` decode steps ->
    {name: [steps + 1, B, V]}."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import qwen

    b, t = ids.shape
    steps = min(steps, toks.shape[1] - 1)
    runs = {}
    for name, p in trees.items():
        cache = qwen.KVCache.zeros(cfg.layers, b, t + steps + 1, cfg.kv_heads, cfg.head_dim,
                                   dtype=p.final_ln.dtype, device=ids.device,
                                   grid=qwen.cache_grid(p))
        out = [qwen.qwen_prefill(p, cfg, ids, mask, cache)[0]]
        for j in range(steps):
            out.append(qwen.qwen_decode_step(p, cfg, toks[:, j].contiguous(), cache)[0])
        runs[name] = torch.stack(out).float()
    return runs


@contextlib.contextmanager
def planted(module, name: str, fault):
    """`module.name` replaced by `fault` inside the block: a planted fault,
    to show that a check's limit tells it from the sound reading."""
    sound = getattr(module, name)
    setattr(module, name, fault)
    try:
        yield
    finally:
        setattr(module, name, sound)


def _drop_partials(row_dense):
    """A row-parallel product that keeps the first shard's partial only."""
    return lambda xs, ws, b=None: row_dense(xs[:1], ws[:1], b)


def _first_divergence(got: list, ref: list) -> list:
    """[(row, first step where it leaves ref)] of the rows that differ."""
    return [(i, next((k for k, (x, y) in enumerate(zip(a, r)) if x != y),
                     min(len(a), len(r))))
            for i, (a, r) in enumerate(zip(got, ref)) if a != r]


def phase_mesh_tp(paths: dict, w8_bodies: list):
    """Qwen2.5-0.5B at tp = 2 on the one card: greedy (bf16 and W8A8) as a
    graph against tp = 1, ms a token and kernels a step of each, device
    bytes a shard; the W8A8 engine at tp = 2 against tp = 1; the fused
    W8A8 server at MESH_TP = 2 against serve_w8a8's bodies.

    W8A8 is held to tp = 1 bit for bit: its tokens, its forced logits, the
    engine's sequences and the served bodies. bf16's row-parallel sums
    round otherwise by design: its forced logits are held to TP_BF16_RMS
    times tp = 1's own distance from f32 activations, and a planted dropped
    partial must break that limit. The s32 launches are the main path's:
    the counts are zeroed before the timed greedy calls, the wrappers count
    the eager prefills, and a torch.profiler trace of the tp = 2 step graph
    gives the launches each replay adds."""
    import asyncio

    import numpy as np
    import torch
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.engine.decode_engine import DecodeEngine
    from rag_inference_pipeline_tpu_torch.models import decode_graph, qwen
    from rag_inference_pipeline_tpu_torch.models.layers import TPTree, attention
    from rag_inference_pipeline_tpu_torch.ops import w8a8
    from rag_inference_pipeline_tpu_torch.parallel.sharding import place_params
    from rag_inference_pipeline_tpu_torch.serve import runtime

    t0 = time.perf_counter()
    mesh = _one_card_mesh(1, TP)
    cfg, bf16 = _decoder("bfloat16")
    n = DECODE_NEW
    stats, s32 = {}, {}
    with torch.inference_mode():
        # the attention over a shard's 7 heads against the same heads of the
        # 14-head call, at the decode step's and the prefill's shapes
        g = torch.Generator(device=DEVICE).manual_seed(47)
        for tag, t, s_len in (("decode", 1, DECODE_BUCKET + n), ("prefill", DECODE_BUCKET,
                                                                DECODE_BUCKET + n)):
            q = torch.randn(MAIN_B, t, cfg.heads, cfg.head_dim, generator=g,
                            device=DEVICE).to(torch.bfloat16)
            kv = [torch.randn(MAIN_B, s_len, cfg.kv_heads, cfg.head_dim, generator=g,
                              device=DEVICE).to(torch.bfloat16) for _ in range(2)]
            full = attention(q, *kv)
            h, kh = cfg.heads // TP, cfg.kv_heads // TP
            half = torch.cat([attention(q[:, :, j * h:(j + 1) * h],
                                        *(x[:, :, j * kh:(j + 1) * kh] for x in kv))
                              for j in range(TP)], dim=2)
            stats[f"attn_split_{tag}_max_diff"] = f"{(full - half).float().abs().max().item():.3g}"
            check(torch.equal(full, half), f"mesh_tp: the attention over a shard's heads "
                  f"differs from those heads of the whole call ({tag})")
        trees = {"bf16": bf16, "w8a8": qwen.quantize_qwen_params(bf16)}
        ids, mask = _decode_prompts(MAIN_B, seed=MAIN_B)
        for dtype in ("bf16", "w8a8"):
            solo = trees[dtype]
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            (tree,) = place_params(mesh, solo, cfg)
            torch.cuda.synchronize()
            added = torch.cuda.memory_allocated() - before
            check(isinstance(tree, TPTree) and decode_graph.uses_graphs(
                qwen.tree_all_devices(tree)), "mesh_tp: the tp = 2 tree is not one graph's")
            weights, biases = _shard_bytes(tree, 0)
            if dtype == "bf16":
                check((weights, biases) == (TP_SPLIT_WEIGHTS, TP_SPLIT_BIASES),
                      f"mesh_tp: a shard holds {weights} weights and {biases} biases, not "
                      f"{TP_SPLIT_WEIGHTS} and {TP_SPLIT_BIASES}")
            stats[f"{dtype}_shard_split_elements"] = weights + biases
            stats[f"{dtype}_shards_added_mb"] = f"{added / 2**20:.1f}"
            ref, _ = _wall(lambda: qwen.greedy_generate(solo, cfg, ids, mask, n,
                                                        eos_token_id=-1))
            got, first2 = _wall(lambda: qwen.greedy_generate(tree, cfg, ids, mask, n,
                                                             eos_token_id=-1))
            m = min(TP_EAGER_TOKENS, n)
            # the graph's cache length: another S is another attention shape
            eager = qwen.greedy_generate_eager(tree, cfg, ids, mask, m, eos_token_id=-1,
                                               cache_len=ids.shape[1] + n)
            check(torch.equal(got[:, :m], eager), f"mesh_tp {dtype}: the tp = 2 graph's "
                  "tokens differ from its eager loop's")
            left = _first_divergence(got.tolist(), ref.tolist())
            stats[f"{dtype}_rows_identical"] = f"{MAIN_B - len(left)}/{MAIN_B}"
            stats[f"{dtype}_first_divergence"] = json.dumps(left)
            if dtype == "w8a8":
                check(not left, f"mesh_tp w8a8: rows (row, step) {left} leave tp = 1's tokens")
                runs = _forced_logits({"tp1": solo, "tp2": tree}, cfg, ids, mask, ref,
                                      TP_FORCED_STEPS)
                check(torch.equal(runs["tp1"], runs["tp2"]), "mesh_tp w8a8: tp = 2's forced "
                      "logits differ from tp = 1's")
                stats["w8a8_forced_logits_identical"] = True
            else:
                runs = _forced_logits({"tp1": solo, "tp2": tree, "f32": _f32_activations(solo)},
                                      cfg, ids, mask, ref, TP_FORCED_STEPS)
                with planted(qwen, "row_dense", _drop_partials(qwen.row_dense)):
                    runs["fault"] = _forced_logits({"fault": tree}, cfg, ids, mask, ref,
                                                   TP_FORCED_STEPS)["fault"]
                f32 = runs.pop("f32")
                rms = {k: (r - f32).square().mean().sqrt().item() for k, r in runs.items()}
                limit = TP_BF16_RMS * rms["tp1"]
                check(rms["tp2"] <= limit, f"mesh_tp bf16: tp = 2's forced logits lie "
                      f"{rms['tp2']:.4g} (RMS) from f32 activations, beyond {TP_BF16_RMS} x tp "
                      f"= 1's {rms['tp1']:.4g}")
                check(rms["fault"] > limit, f"mesh_tp bf16: a dropped partial reads "
                      f"{rms['fault']:.4g}, within the limit {limit:.4g}")
                stats.update({
                    "bf16_forced_rms_tp1": f"{rms['tp1']:.5g}",
                    "bf16_forced_rms_tp2": f"{rms['tp2']:.5g}",
                    "bf16_forced_rms_fault": f"{rms['fault']:.5g}",
                    "bf16_forced_max_tp2_tp1": f"{(runs['tp2'] - runs['tp1']).abs().max().item():.4g}",
                    "bf16_logits_std": f"{runs['tp1'].std().item():.4g}",
                })
            del runs
            # the main path: the timed greedy calls, the counts zeroed first
            zero_launches()
            walls = alternated(lambda f, _: _wall(f)[1], {
                "tp1": lambda: qwen.greedy_generate(solo, cfg, ids, mask, n, eos_token_id=-1),
                "tp2": lambda: qwen.greedy_generate(tree, cfg, ids, mask, n, eos_token_id=-1),
            }, 0, rounds=DECODE_ROUNDS)
            counted = (w8a8.w8a8_gemm_s32.launches - w8a8.w8a8_gemm_s32.wgmma_launches,
                       w8a8.w8a8_gemm_s32.wgmma_launches, w8a8.w8a8_gemm_s32.short_launches)
            entries = {"tp1": decode_graph.graphs_of(solo).entries()[0],
                       "tp2": decode_graph.graphs_of(tree).entries()[0]}
            prof = {k: _profile_steps(p, cfg, entries[k], ids, mask)
                    for k, p in (("tp1", solo), ("tp2", tree))}
            if dtype == "w8a8":
                per = prof["tp2"].get("b8_step_s32_small_kernels")
                # o and down a layer, one launch a shard, on the small-row route
                want = 2 * TP * cfg.layers
                check(per == want and prof["tp2"].get("b8_step_wgmma_kernels") == 0,
                      f"mesh_tp: a tp = 2 step replays {per} s32 small-row kernels (not "
                      f"{want}) and {prof['tp2'].get('b8_step_wgmma_kernels')} wgmma ones")
                # the eager prefills launch through the wrappers; the replays
                # (n - 1 a call) through the graph
                short = prof["tp2"].get("b8_step_s32_short_kernels")
                s32 = {"small": counted[0] + per * DECODE_ROUNDS * (n - 1), "wgmma": counted[1],
                       "short": counted[2] + short * DECODE_ROUNDS * (n - 1)}
                check(s32["small"] > s32["short"] > 0 and s32["wgmma"] > 0,
                      f"mesh_tp: the s32 kind did not launch on both routes and both "
                      f"small-row kernels ({s32})")
                stats.update({"s32_small_launches": s32["small"],
                              "s32_wgmma_launches": s32["wgmma"],
                              "s32_short_launches": s32["short"],
                              "s32_small_a_step": per})
            stats.update({
                f"{dtype}_tp1_ms_per_token": f"{walls['tp1'] / n * 1e3:.3f}",
                f"{dtype}_tp2_ms_per_token": f"{walls['tp2'] / n * 1e3:.3f}",
                f"{dtype}_tp2_first_call_s": f"{first2:.3f}",
                f"{dtype}_tp1_kernels_a_step": prof["tp1"].get("b8_step_kernels"),
                f"{dtype}_tp2_kernels_a_step": prof["tp2"].get("b8_step_kernels"),
                f"{dtype}_tp1_step_kernel_ms": prof["tp1"].get("b8_step_kernel_ms"),
                f"{dtype}_tp2_step_kernel_ms": prof["tp2"].get("b8_step_kernel_ms"),
                f"{dtype}_tp2_pool_mb": f"{entries['tp2'].graph.pool_bytes / 2**20:.1f}",
            })
            trees[dtype + "_tp2"] = tree

        # the engine at tp = 2 against tp = 1, W8A8: 16 prompts, every
        # sequence tp = 1's
        rng = np.random.default_rng(37)
        lens = rng.integers(64, 257, TP_ENGINE_REQUESTS)
        budgets = rng.integers(16, 65, TP_ENGINE_REQUESTS)
        prompts = [rng.integers(1000, DOC_VOCAB - 1, int(k)).astype(np.int32) for k in lens]

        def run_engine(params, engine_mesh):
            eng = DecodeEngine(params, cfg, lanes=TP_ENGINE_LANES, cache_len=TP_ENGINE_CACHE,
                               segment_steps=ENGINE_SEGMENT, eos_token_id=-1,
                               admit_buckets=(1, 2, 4, 8, 16), prefill_buckets=(128, 256),
                               mesh=engine_mesh)

            async def main():
                await eng.start()
                try:
                    return await asyncio.gather(*(eng.submit(p, int(m))
                                                  for p, m in zip(prompts, budgets)))
                finally:
                    await eng.stop()

            outs, wall = _wall(lambda: asyncio.new_event_loop().run_until_complete(main()))
            return outs, wall, eng

        ref_outs, ref_wall, _ = run_engine(trees["w8a8"], None)
        outs, wall, eng = run_engine(trees["w8a8"], mesh)
        check(len(eng.cache.grid[0]) == TP and eng.graph is not None,
              "mesh_tp engine: the lane pool is not split over tp, or runs eagerly")
        left = _first_divergence(outs, ref_outs)
        check(not left, f"mesh_tp engine: sequences (index, step) {left} leave tp = 1's")
        stats.update({"engine_identical": f"{len(outs)}/{len(ref_outs)}",
                      "engine_tp1_wall_s": f"{ref_wall:.3f}",
                      "engine_tp2_wall_s": f"{wall:.3f}"})
        del eng, trees
        gc.collect()
        torch.cuda.empty_cache()

    # the fused W8A8 server at MESH_TP = 2 against serve_w8a8 (tp = 1)
    settings = load_settings({**SERVE_ENV, **paths, "MESH_TP": str(TP),
                              "LLM_WEIGHT_QUANT": "int8", "ENCODER_WEIGHT_QUANT": "int8"})
    server = runtime.make_server(settings, port=0, mesh=mesh)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        health = _get_health(port)
        check(health["mesh"] == {"dp": 1, "tp": TP}, f"mesh_tp: /health mesh {health['mesh']}")
        ex = server.executor
        check(all(isinstance(c.params, TPTree)
                  for c in (ex.embedder, ex.llm, ex.sentiment, ex.toxicity)),
              "mesh_tp: a served model is not split over tp")
        results = [_post(port, f"what does the corpus say about topic {i}?", f"q{i}")
                   for i in range(2)]
    finally:
        _stop(server, th)
    for i, (status, body, _) in enumerate(results):
        check(status == 200 and body["request_id"] == f"q{i}", f"mesh_tp /query {i}: {status}")
    same = sum(r[1] == b for r, b in zip(results, w8_bodies[:2]))
    check(same == len(results), f"mesh_tp: {len(results) - same} served bodies at MESH_TP = "
          f"{TP} differ from tp = 1's")
    stats.update({"serve_second_s": round(results[1][2], 4),
                  "serve_bodies_identical_to_tp1": f"{same}/{len(results)}"})
    phase("mesh_tp", t0, tp=TP, batch=MAIN_B, new_tokens=n, prompt_bucket=DECODE_BUCKET,
          **stats)
    return s32


def _bge_long(g):
    """bge-base at full width, max_positions 2048, random bf16 weights, the
    attention's at ATTN_SCALE x the init's std."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import bert as tbert

    cfg = tbert.BertConfig(max_positions=SP_T)
    params = tbert.init_bert_params(cfg, generator=g, dtype=torch.bfloat16, device=DEVICE)
    with torch.no_grad():
        for lp in params.layers:
            for k in ("q_w", "k_w", "v_w", "o_w"):
                getattr(lp, k).mul_(ATTN_SCALE)
    return cfg, params


def _rows_diff(got, ref) -> tuple[float, float]:
    """(max |got - ref|, least cosine of a row) over rows [N, H]."""
    import torch.nn.functional as F

    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max().item(),
            F.cosine_similarity(got, ref, dim=-1).min().item())


def phase_tp_encode():
    """bge-base at tp 2 and 4, T 1024, B 4: the flash kernel 12 x tp times a
    forward, the pooled embeddings against tp = 1 (and a planted dropped
    partial against the same limits), ms a forward."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import bert as tbert
    from rag_inference_pipeline_tpu_torch.ops import flash_attention as fa
    from rag_inference_pipeline_tpu_torch.parallel.sharding import place_params

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(41)
    cfg, params = _bge_long(g)
    mask = flash_masks(TP_ENCODE_B, TP_ENCODE_T)
    ids = torch.randint(1, cfg.vocab_size, mask.shape, generator=g, device=DEVICE) * mask
    stats, launches = {}, 0
    fns = {"tp1": lambda: tbert.bert_embed(params, cfg, ids, mask)}
    with torch.inference_mode():
        ref = tbert.bert_embed(params, cfg, ids, mask)
        for tp in TP_ENCODE:
            (tree,) = place_params(_one_card_mesh(1, tp), params, cfg)
            zero_launches()
            emb = tbert.bert_embed(tree, cfg, ids, mask)
            torch.cuda.synchronize()
            per = fa.flash_encoder_attention.launches
            check(per == cfg.layers * tp, f"tp_encode tp={tp}: {per} flash launches a "
                  f"forward, not {cfg.layers * tp}")
            launches += per
            err, cos = _rows_diff(emb, ref)
            with planted(tbert, "row_dense", _drop_partials(tbert.row_dense)):
                bad_err, bad_cos = _rows_diff(tbert.bert_embed(tree, cfg, ids, mask), ref)
            check(bool(torch.isfinite(emb).all()) and err <= TP_EMB_ATOL and cos >= TP_MIN_COS,
                  f"tp_encode tp={tp}: pooled embeddings {err:.3e} from tp = 1 (min cosine "
                  f"{cos:.6f})")
            check(bad_err > TP_EMB_ATOL or bad_cos < TP_MIN_COS,
                  f"tp_encode tp={tp}: a dropped partial reads {bad_err:.3e} (min cosine "
                  f"{bad_cos:.6f}), within the limits")
            stats.update({f"tp{tp}_flash_a_forward": per, f"tp{tp}_max_abs_err": f"{err:.3e}",
                          f"tp{tp}_min_cos": f"{cos:.6f}",
                          f"tp{tp}_fault_max_abs_err": f"{bad_err:.3e}",
                          f"tp{tp}_fault_min_cos": f"{bad_cos:.6f}"})
            fns[f"tp{tp}"] = lambda tree=tree: tbert.bert_embed(tree, cfg, ids, mask)
        ms = alternated(cuda_ms, fns, TP_TIME_ITERS, rounds=TP_TIME_ROUNDS)
        stats.update({f"{k}_forward_ms": f"{v:.3f}" for k, v in ms.items()})
    del params, fns
    torch.cuda.empty_cache()
    phase("tp_encode", t0, batch=TP_ENCODE_B, t=TP_ENCODE_T, attn_scale=ATTN_SCALE,
          atol=TP_EMB_ATOL, min_cos=TP_MIN_COS, **stats)
    return {"launches": launches}


def phase_sp():
    """bge-base bert_encode_sp at sp 2 and 4, T 2048, B 2 (row 1 padded
    past SP_VALID): the valid rows against bert_encode at the same T (and a
    planted gather of position 0's keys only against the same limits), ms
    a forward of each."""
    import torch
    from rag_inference_pipeline_tpu_torch.models import bert as tbert
    from rag_inference_pipeline_tpu_torch.parallel import bert_encode_sp, sequence

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(43)
    cfg, params = _bge_long(g)
    mask = torch.ones(SP_B, SP_T, dtype=torch.int32, device=DEVICE)
    mask[1, SP_VALID:] = 0
    ids = torch.randint(1, cfg.vocab_size, mask.shape, generator=g, device=DEVICE) * mask
    valid = mask.bool()
    stats = {}
    fns = {"encode": lambda: tbert.bert_encode(params, cfg, ids, mask)}

    def first_keys(q, ks, vs, masks, sound=sequence._sp_attention):
        return sound(q, ks[:1], vs[:1], masks[:1])

    with torch.inference_mode():
        ref = tbert.bert_encode(params, cfg, ids, mask)
        for sp in SP_SIZES:
            mesh = _one_card_mesh(sp)
            out = bert_encode_sp(params, cfg, mesh, ids, mask)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and bool(torch.isfinite(out[valid]).all()),
                  f"sp={sp}: shape {tuple(out.shape)} or non-finite rows")
            err, cos = _rows_diff(out[valid], ref[valid])
            with planted(sequence, "_sp_attention", first_keys):
                bad_err, bad_cos = _rows_diff(bert_encode_sp(params, cfg, mesh, ids, mask)[valid],
                                              ref[valid])
            check(err <= SP_ATOL and cos >= SP_MIN_COS, f"sp={sp}: valid rows {err:.3e} from "
                  f"bert_encode (min cosine {cos:.6f})")
            check(bad_err > SP_ATOL or bad_cos < SP_MIN_COS, f"sp={sp}: a gather of position "
                  f"0's keys only reads {bad_err:.3e} (min cosine {bad_cos:.6f}), within the "
                  "limits")
            stats.update({f"sp{sp}_max_abs_err": f"{err:.3e}", f"sp{sp}_min_cos": f"{cos:.6f}",
                          f"sp{sp}_fault_max_abs_err": f"{bad_err:.3e}",
                          f"sp{sp}_fault_min_cos": f"{bad_cos:.6f}"})
            fns[f"sp{sp}"] = lambda mesh=mesh: bert_encode_sp(params, cfg, mesh, ids, mask)
        ms = alternated(cuda_ms, fns, TP_TIME_ITERS // 2, rounds=TP_TIME_ROUNDS)
        stats.update({f"{k}_forward_ms": f"{v:.3f}" for k, v in ms.items()})
    del params, fns
    torch.cuda.empty_cache()
    phase("sp", t0, batch=SP_B, t=SP_T, valid_row1=SP_VALID, attn_scale=ATTN_SCALE,
          atol=SP_ATOL, min_cos=SP_MIN_COS, **stats)


# a process of the serving entry point; exit 3 if it imported jax
_SPMD_ENTRY = (
    "import sys\n"
    "from rag_inference_pipeline_tpu_torch.serve import runtime\n"
    "runtime.main()\n"
    "sys.exit(3 if 'jax' in sys.modules or any(m.split('.')[0] == "
    "'rag_inference_pipeline_tpu' for m in sys.modules) else 0)\n"
)


def phase_spmd(paths: dict, workdir: str):
    import signal

    import torch
    from rag_inference_pipeline_tpu_torch.index.base import load_index

    t0 = time.perf_counter()
    coord = _free_base(2)  # the group's rendezvous, then the front door's port
    port = coord + 1
    env = {**os.environ, "DEVICE_PLATFORM": DEVICE, "MODEL_WEIGHTS_DIR": "",
           "DIST_NUM_PROCESSES": str(SPMD_PROCS), "DIST_COORDINATOR": f"127.0.0.1:{coord}",
           "BASE_PORT": str(port), "TOTAL_NODES": "1",
           "PIPELINE_ROLE_PROFILE": "retrieval_default", "INDEX_KIND": "flat",
           "INDEX_DTYPE": "int8", "INDEX_PATH": paths["INDEX_PATH"],
           "DOC_STORE_BACKEND": "memory", "DOCUMENTS_PAYLOAD_MODE": "id_only",
           "WARMUP_BUCKETS": "0"}
    logs = [os.path.join(workdir, f"spmd{r}.log") for r in range(SPMD_PROCS)]
    procs = []
    for r in range(SPMD_PROCS):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SPMD_ENTRY], cwd=ROOT,
                env={**env, "DIST_PROCESS_ID": str(r)}, stdout=log, stderr=subprocess.STDOUT))

    def tail(r):
        with open(logs[r]) as f:
            return f.read()[-3000:]

    g = torch.Generator(device=DEVICE).manual_seed(12)
    q = torch.randn(2 * MAIN_B, DIM, generator=g, device=DEVICE)
    q /= q.norm(dim=1, keepdim=True)
    q, q2 = q[:MAIN_B], q[MAIN_B:]
    try:
        deadline = time.perf_counter() + 240
        while True:
            for r, p in enumerate(procs):
                check(p.poll() is None, f"spmd process {r} exited {p.returncode}: {tail(r)}")
            try:
                health = _get_health(port)
                break
            except OSError:
                check(time.perf_counter() < deadline, "the spmd front door did not come up")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        before = health["kernel_launches"]["binmax_int8gs"]
        ret, retrieve_s = _retrieve(port, q)
        after = _get_health(port)["kernel_launches"]["binmax_int8gs"]
        _, second_s = _retrieve(port, q2)  # a second batch: the first paid set-up
        front_total = _get_health(port)["kernel_launches"]["binmax_int8gs"]
        procs[0].send_signal(signal.SIGINT)
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    check(rcs == [0] * SPMD_PROCS, f"spmd exit codes {rcs}: {tail(0)} {tail(1)}")
    # one K1 launch a search in each process (its half on a one-position
    # mesh): the front door's for the one /retrieve, and the worker's, which
    # runs every search the front door broadcast and logs its counts
    check(after - before == 1, f"the spmd front door launched K1 {after - before} times "
          "for one /retrieve")
    worker = tail(1)
    searches = re.search(r"stopping after (\d+) searches", worker)
    counts = re.search(r"SPMD worker kernel launches (\{.*\})", worker)
    check(searches is not None and counts is not None,
          f"the spmd worker did not leave its loop on OP_STOP: {worker}")
    worker_searches = int(searches.group(1))
    worker_k1 = json.loads(counts.group(1))["binmax_int8gs"]
    check(worker_searches == front_total and worker_k1 == worker_searches,
          f"spmd worker: {worker_searches} searches and {worker_k1} K1 launches against "
          f"the front door's {front_total}")
    ref = load_index(paths["INDEX_PATH"], mesh=_one_card_mesh(SPMD_PROCS))
    with torch.inference_mode():
        _, ids = ref.search(q, 10)
    got = [r["ids"] for r in ret["results"]]
    check(got == ids.tolist(), "spmd /retrieve ids differ from the dp=2 sharded search")
    del ref
    torch.cuda.empty_cache()
    phase("spmd", t0, processes=SPMD_PROCS, up_s=round(up_s, 3),
          retrieve8_s=round(retrieve_s, 4), second_retrieve8_s=round(second_s, 4),
          front_k1_launches=after - before, front_k1_total=front_total,
          worker_searches=worker_searches, worker_k1_launches=worker_k1,
          ids_identical=True, exit_codes=rcs)
    return {"launches": after - before}


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

    # every server of the run, in process or not, compresses with zstd where
    # the package imports; a node refuses COMPRESSION_ALGORITHM=zstd without it
    try:
        import zstandard  # noqa: F401

        os.environ["COMPRESSION_ALGORITHM"] = "zstd"
    except ImportError:
        os.environ["COMPRESSION_ALGORITHM"] = "none"
    print(f"[compression] COMPRESSION_ALGORITHM={os.environ['COMPRESSION_ALGORITHM']}",
          flush=True)
    t_all = time.perf_counter()
    smi = phase_device()
    phase_build()
    k1 = phase_k1()
    k2 = phase_k2()
    flash, flash_f32 = phase_flash()
    w8 = phase_w8a8()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        paths = phase_corpus(workdir)
        executor, k1_launches, _, bodies, _ = phase_serve(paths, {"WARMUP_BUCKETS": "1"})
        phase_step(executor)
        phase_checkpoint(executor, paths, bodies, workdir, smi)
        del executor
        gc.collect()
        torch.cuda.empty_cache()
        spec_serve = phase_serve(paths, {"USE_SPECULATIVE_DECODING": "1"}, "serve_spec")
        del spec_serve
        gc.collect()
        torch.cuda.empty_cache()
        w8_serve = phase_serve_w8a8(paths)
        gc.collect()
        torch.cuda.empty_cache()
        corpus, ivf, queries, db_path = phase_ivf_build(workdir)
        k45 = phase_k45(ivf, queries)
        staged = phase_serve_staged(ivf, corpus, queries, db_path)
        phase_serve_3node(ivf, queries, db_path, workdir, staged)
        phase_engine_serve(ivf, db_path)
        gc.collect()
        torch.cuda.empty_cache()
        flat = phase_retrieve_flat(corpus, queries, db_path)
        gc.collect()
        torch.cuda.empty_cache()
        phase_host_stores(corpus, queries, db_path, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        built = phase_pq_build(corpus, queries, workdir)
        k6 = phase_k6(built["pq4"], queries)
        k6_launches = phase_serve_pq(built, corpus, queries, db_path)
        mesh = phase_mesh_retrieve(corpus, queries, ivf, built["pq4"])
        del built, corpus, queries, ivf
        gc.collect()
        torch.cuda.empty_cache()
        mesh_fused = phase_mesh_fused(paths)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_tp = phase_mesh_tp(paths, w8_serve["bodies"])
        gc.collect()
        torch.cuda.empty_cache()
        phase_spmd(paths, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        llama_serve = phase_llama_serve(paths, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    k3 = phase_k3()
    k8 = phase_k8()
    k7 = phase_k7()
    gc.collect()
    torch.cuda.empty_cache()
    bf16_params, bf16_stats = phase_decode_graph()
    phase_spec(bf16_params)
    del bf16_params
    gc.collect()
    torch.cuda.empty_cache()
    w8_decode = phase_decode_w8a8(bf16_stats)
    phase_engine()
    gc.collect()
    torch.cuda.empty_cache()
    phase_llama_8b(False)
    phase_llama_8b_f32_spec()
    llama_int8 = phase_llama_8b(True)
    llama_1b = phase_llama_1b()
    # the Llama paths' W8A8_COUNTS launches: the 8B's greedy, speculation
    # and engine, the 1B's greedy, the server
    llama = [sum(c) for c in zip(
        llama_int8["launches"], llama_1b["launches"],
        (llama_serve["w8a8_small_launches"], llama_serve["w8a8_wgmma_launches"],
         llama_serve["quantize_rows_launches"], llama_serve["w8a8_few_tile_launches"],
         llama_serve["quantize_rows_long_launches"], llama_serve["w8a8_bands_launches"],
         llama_serve["w8a8_shared_launches"], llama_serve["w8a8_few_rows_launches"],
         llama_serve["w8a8_short_launches"]))]
    check(llama[4] > 0, "the Llama phases launched no long-row quantize")
    spec = w8_decode["spec_launches"]  # decode_w8a8's int8 speculation
    tp_encode = phase_tp_encode()
    phase_sp()
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m.split(".")[0] == "rag_inference_pipeline_tpu" for m in sys.modules),
          "the JAX package was imported")

    def entry(name, replaces, launches, m, source=None):
        return {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        }

    jax_ops = "rag_inference_pipeline_tpu/ops"
    print(smi, flush=True)  # the card beside the numbers, at the end of the log too
    print(f"[total] {time.perf_counter() - t_all:.3f}s", flush=True)
    kernels = [
        # the main paths' launches, and the sharded paths' (one a shard)
        entry("binmax_int8gs", f"{jax_ops}/topk.py:442",
              k1_launches + mesh["int8_launches"] + mesh["int8_host_launches"]
              + mesh_fused["launches"] + llama_serve["k1_launches"], k1),
        entry("binmax_bf16", f"{jax_ops}/topk.py:118",
              flat["launches"] + mesh["bf16_launches"], k2),
        entry("binmax_int8", f"{jax_ops}/topk.py:268", k3["launches"], k3),
        entry("ivf_scan", f"{jax_ops}/ivf.py:156", staged["k4_launches"], k45["k4"]),
        entry("ivf_dedup", f"{jax_ops}/ivf.py:290",
              staged["k5_launches"] + mesh["ivf_flat_launches"], k45["k5"]),
        entry("ivfpq4_adc", f"{jax_ops}/pq.py:432", k6_launches + mesh["pq4_launches"], k6),
        entry("kv_row_insert", "scripts/bench_decode_anatomy.py:88", k7["launches"], k7),
        entry("stream", "scripts/bench_kernel.py:171", k8["launches"], k8),
        # no Pallas kernel: the reference's XLA _qdense and quantize_act_rows;
        # the GEMM on its two routes (every entry adds the Llama phases'
        # launches: the 8B's served /query, its greedy and speculation, its
        # engine, the 1B's greedy). Small rows, the quantize folded in: the
        # short-K kernel (rows of at most 1,024 under 16 MB of weights:
        # Qwen2.5-0.5B's q/k/v, o and gate/up, the classifiers), timed at
        # the 0.5B's decode gate/up
        entry("w8a8_gemm_short_k", "rag_inference_pipeline_tpu/models/layers.py:92",
              w8_serve["w8a8_short_launches"] + llama[8], w8["short"], "w8a8_short_k"),
        # the streaming kernel (the rest: long rows, the heads), timed at
        # Llama-3.1-8B's decode down
        entry("w8a8_gemm_small_rows", "rag_inference_pipeline_tpu/models/layers.py:92",
              w8_serve["w8a8_small_launches"] - w8_serve["w8a8_short_launches"]
              + llama[0] - llama[8], w8["small"], "w8a8_gemm"),
        # the wgmma GEMM by plan kind: wide tiles in the order by rows
        entry("w8a8_gemm_wgmma", "rag_inference_pipeline_tpu/models/layers.py:92",
              w8_serve["w8a8_wgmma_launches"] - w8_serve["w8a8_few_tile_launches"]
              - w8_serve["w8a8_bands_launches"] - w8_serve["w8a8_shared_launches"]
              + llama[1] - llama[3] - llama[5] - llama[6], w8["wgmma"], "w8a8_wgmma"),
        # wide tiles in bands of column tiles (prefill's gate/up groups)
        entry("w8a8_gemm_wgmma_bands", "rag_inference_pipeline_tpu/models/layers.py:92",
              w8_serve["w8a8_bands_launches"] + llama[5], w8["bands"], "w8a8_wgmma"),
        # a weight tile shared by a cluster's row tiles (the 8B engine's
        # verify round, 288 rows)
        entry("w8a8_gemm_wgmma_shared_weight",
              "rag_inference_pipeline_tpu/models/layers.py:92",
              w8_serve["w8a8_shared_launches"] + spec[6] + llama[6], w8["shared"],
              "w8a8_wgmma"),
        # 64 x 64 tiles, K split or not: the 0.5B's int8 verify round's q/k/v,
        # o and down, from decode_w8a8's speculative call, and the 8B's q/k/v
        entry("w8a8_gemm_wgmma_few_tiles", "rag_inference_pipeline_tpu/models/layers.py:92",
              spec[3] - spec[7] + llama[3] - llama[7], w8["few_tiles"], "w8a8_wgmma"),
        # 128-column tiles over one row tile, K split over a cluster: the 8B's
        # verify round (72 rows) and engine step (32 rows)
        entry("w8a8_gemm_wgmma_few_rows", "rag_inference_pipeline_tpu/models/layers.py:92",
              spec[7] + llama[7], w8["few_rows"], "w8a8_wgmma"),
        entry("w8a8_quant", "rag_inference_pipeline_tpu/models/layers.py:80",
              w8_serve["quantize_rows_launches"] - w8_serve["quantize_rows_long_launches"]
              + llama[2] - llama[4], w8["quant"]),
        # its long-row kernel (rows past 8,192 bf16: the 8B's down), from the
        # Llama phases
        entry("w8a8_quant_long_rows", "rag_inference_pipeline_tpu/models/layers.py:80",
              w8_serve["quantize_rows_long_launches"] + llama[4], w8["quant_long"],
              "w8a8_quant"),
        # the s32 kind of both GEMMs: a row-parallel shard's partial at tp = 2
        # (o and down; the reference's int32 psum over tp), from mesh_tp
        entry("w8a8_gemm_small_rows_s32", "rag_inference_pipeline_tpu/models/layers.py:92",
              mesh_tp["small"] - mesh_tp["short"], w8["small_s32"], "w8a8_gemm"),
        entry("w8a8_gemm_short_k_s32", "rag_inference_pipeline_tpu/models/layers.py:92",
              mesh_tp["short"], w8["short_s32"], "w8a8_short_k"),
        entry("w8a8_gemm_wgmma_s32", "rag_inference_pipeline_tpu/models/layers.py:92",
              mesh_tp["wgmma"], w8["wgmma_s32"], "w8a8_wgmma"),
        entry("flash_attention", "rag_inference_pipeline_tpu/models/layers.py:205",
              flash["launches"] + tp_encode["launches"], flash),
        # its f32 instances (the three-way bf16 split): the f32 forward's
        entry("flash_attention_f32", "rag_inference_pipeline_tpu/models/layers.py:205",
              flash_f32["launches"], flash_f32, "flash_attention"),
    ]
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not idle, f"kernels the main paths never launched: {idle}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
