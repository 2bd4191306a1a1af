"""Fused serving executor: the whole RAG hot path as one device step per
chunk of requests, then the joint sentiment + toxicity classifier.

Port of `rag_inference_pipeline_tpu/engine/fused_executor.py` (greedy,
or n-gram speculation with `use_speculative_decoding`). Batches are cut
into chunks of at most `fused_chunk_lanes` lanes, each padded to a shape
bucket exactly as the reference pads it: the query's int8 scale is
batch-wide, so padded lanes take part in it and a different padding would
change ids. On a mesh of dp > 1 the buckets and the chunk lanes are
rounded up to dp multiples (the step splits the batch over dp), as the
reference rounds them (`:126-130`, `:227-236`). The buckets are the LLM's
ladder (`LLMComponent.ladder`): the configured ones, cut at load to the
lanes the card's free memory holds. The reference pads to the configured
buckets here even where its clamp cut the ladder, so on a crowded card it
would dispatch the lanes the clamp refused; unclamped, both pad alike.
Requires a document token store (`doc_tokens.npy`, decoder token space)
beside the int8 flat index, its ids within the decoder's vocabulary.

Warm-up (`warmup_buckets`, reference `fused_executor.py:123-142`) runs one
chunk of each bucket that `process_batch` can dispatch: the buckets up to
the one that holds `fused_chunk_lanes` lanes ({1, 2, 4, 8} by default),
not the whole ladder, which the reference warms although chunking never
dispatches past that bucket. A chunk is the fused step, its tokens read
back and the joint classifier, so each bucket's decode graph is captured
before the first request.

The sampled profiler tracks the reference's stages (`:231-272`):
`device_dispatch` and `classify_dispatch` time the launches only (CUDA
runs them asynchronously); `device_step` ends when a chunk's tokens reach
the host, `classify` when the classifiers' logits do; `sentiment` and
`toxicity` replace the last two when only one classifier is loaded.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import Settings
from ..core.mesh import MeshContext
from ..telemetry.profiling import NULL_PROFILE, SampledStageProfiler
from ..utils.shapes import chunk_spans, pad_rows, pick_bucket
from .device_pipeline import DeviceRAGPipeline, RAGStepOutput

logger = logging.getLogger(__name__)

# wire text for a filtered answer (the reference's serve/schemas.py)
TOXIC_PLACEHOLDER = "[Content Filtered due to toxicity]"


class FusedExecutor:
    def __init__(
        self,
        settings: Settings,
        *,
        device: torch.device,
        embedder,  # loaded EmbedderComponent
        index,  # loaded int8 FlatIndex
        llm,  # loaded LLMComponent
        sentiment=None,
        toxicity=None,
        mesh: Optional[MeshContext] = None,
    ) -> None:
        self.settings = settings
        self.device = device
        self.mesh = mesh
        self.dp = mesh.dp if mesh is not None else 1
        self.embedder = embedder
        self.index = index
        self.llm = llm
        self.sentiment = sentiment
        self.toxicity = toxicity
        self._pipe: Optional[DeviceRAGPipeline] = None
        self.doc_tokens: Optional[np.ndarray] = None
        self.profiler = SampledStageProfiler(settings, "fused")
        self.warmed_buckets: tuple[int, ...] = ()
        self.warmup_s = 0.0

    @property
    def is_loaded(self) -> bool:
        return self.doc_tokens is not None

    def load(self) -> None:
        s = self.settings
        if not s.doc_tokens_path:
            raise ValueError("use_fused_pipeline requires doc_tokens_path")
        self.doc_tokens = np.load(s.doc_tokens_path).astype(np.int32)
        # the step embeds these ids by indexing the decoder's table: on the
        # card an id past it is a device-side assert that poisons the
        # process's CUDA context (a store tokenized for another decoder)
        vocab = self.llm.cfg.vocab_size
        top = int(self.doc_tokens.max(initial=0))
        if top >= vocab or int(self.doc_tokens.min(initial=0)) < 0:
            raise ValueError(
                f"doc token store {s.doc_tokens_path} holds ids up to {top}, outside "
                f"the vocabulary of {s.llm_model} ({vocab} ids): it was tokenized "
                "for another decoder"
            )
        # explicit validity mask written beside the tokens; `id > 0` is only
        # right for the hash tokenizer (id 0 can be a real token)
        mask_path = s.doc_tokens_path.replace(".npy", "_mask.npy")
        if os.path.exists(mask_path):
            self.doc_token_mask = np.load(mask_path).astype(np.int32)
        else:
            logger.warning(
                "no %s — using `token id > 0` as the pad test "
                "(only safe for the hash tokenizer)", mask_path,
            )
            self.doc_token_mask = (self.doc_tokens > 0).astype(np.int32)
        idx = self.index
        if getattr(idx, "kind", None) != "flat" or idx._db_i8 is None:
            raise ValueError("the fused pipeline requires a loaded int8 flat index")
        n = idx.ntotal
        if self.doc_tokens.shape[0] < n:
            raise ValueError(
                f"doc token store has {self.doc_tokens.shape[0]} rows, "
                f"index has {n}"
            )
        self._ntotal = n
        logger.info(
            "fused pipeline ready: %d docs, %d ctx tokens/doc, int8 scan%s",
            n, self.doc_tokens.shape[1],
            " (device-array reuse)" if idx._db is not None else "",
        )
        if s.warmup_buckets:
            self.warmup()

    def _buckets(self) -> tuple[int, ...]:
        """The LLM's batch ladder (the shape buckets as the card's free
        memory clamped them at load; the configured ones without an LLM),
        each rounded up to a dp multiple."""
        dp = self.dp
        ladder = getattr(self.llm, "ladder", self.settings.shape_buckets)
        return tuple(sorted({-(-b // dp) * dp for b in ladder}))

    def _max_chunk(self) -> int:
        s, dp = self.settings, self.dp
        max_chunk = max(self._buckets())
        if s.fused_chunk_lanes > 0:
            max_chunk = min(max_chunk, -(-s.fused_chunk_lanes // dp) * dp)
        return max_chunk

    def dispatched_buckets(self) -> tuple[int, ...]:
        """The buckets a chunk of `process_batch` can be padded to."""
        buckets = self._buckets()
        top = pick_bucket(self._max_chunk(), buckets)
        return tuple(b for b in buckets if b <= top)

    def warmup(self) -> None:
        """One chunk of every dispatched bucket, answers discarded."""
        t0 = time.perf_counter()
        for b in self.dispatched_buckets():
            self._process([{"query": f"warmup {i}"} for i in range(b)], NULL_PROFILE)
            logger.info("fused warmup: bucket=%d done", b)
        self.warmed_buckets = self.dispatched_buckets()
        self.warmup_s = time.perf_counter() - t0
        logger.info("fused warmup: buckets %s in %.2fs", list(self.warmed_buckets),
                    self.warmup_s)

    def _get_pipe(self) -> DeviceRAGPipeline:
        if self._pipe is None:
            s = self.settings
            pipe = DeviceRAGPipeline(
                device=self.device,
                bert_cfg=self.embedder.cfg,
                qwen_cfg=self.llm.cfg,
                k=s.retrieval_k,
                ctx_docs=s.llm_context_docs,
                max_new_tokens=s.max_tokens,
                # strictly greater than k: the `rescore_k > k` gate would
                # otherwise turn the exact re-score off for k >= 64
                rescore_k=s.retrieval_k + 64,
                speculative=s.use_speculative_decoding,
                spec_gamma=s.speculative_gamma,
                inject_accept_p=s.speculative_inject_p,
                mesh=self.mesh,
            )
            idx = self.index
            if idx._db is not None:
                # the index already holds the arrays the step scans
                pipe.build(
                    self.embedder.params, self.llm.params,
                    None, self.doc_tokens, self.doc_token_mask,
                    db_i8=idx._db_i8, db_scale=idx._db_gscale,
                    db_rescore=idx._db, ntotal=self._ntotal,
                )
            else:
                # no rescore copy: the step re-quantizes dequantized codes
                host = (
                    idx._rows(idx._db_i8).float() * idx._front_scale()
                ).cpu().numpy()
                pipe.build(
                    self.embedder.params, self.llm.params,
                    host, self.doc_tokens, self.doc_token_mask,
                )
            self._pipe = pipe
        return self._pipe

    def _query_len(self) -> int:
        """Query token budget: truncate_length capped by the embedder's
        positions and the decoder's context headroom."""
        s = self.settings
        lm_budget = (
            self.llm.cfg.max_len
            - s.max_tokens
            - s.llm_context_docs * self.doc_tokens.shape[1]
        )
        return max(16, min(
            s.truncate_length, self.embedder.cfg.max_positions, lm_budget
        ))

    def process_batch(self, items: Sequence[dict]) -> list[dict]:
        """Requests -> chunks of at most `fused_chunk_lanes` lanes -> one
        fused step each -> texts -> joint classify per chunk."""
        if not items:
            return []
        return self._process(items, self.profiler.maybe_start())

    def _process(self, items: Sequence[dict], prof) -> list[dict]:
        buckets = self._buckets()
        spans = chunk_spans(len(items), self._max_chunk())
        sent, tox_c = self.sentiment, self.toxicity
        sent_on = sent is not None and sent.is_loaded
        tox_on = tox_c is not None and tox_c.is_loaded
        # CUDA launches are asynchronous: every chunk's step is queued on
        # the device before the first chunk's tokens are fetched, and each
        # chunk's classifiers before the next chunk's tokens
        with prof.track("device_dispatch"):
            pend = [self._dispatch_chunk(items[a:b], buckets) for a, b in spans]
        texts: list[str] = []
        sentiments: list[str] = []
        tox: list[tuple[bool, float]] = []
        cls_pend = []
        for (a, b), out in zip(spans, pend):
            with prof.track("device_step"):
                chunk_texts = self._fetch_texts(out, b - a)
            texts.extend(chunk_texts)
            if sent_on and tox_on:
                with prof.track("classify_dispatch"):
                    cls_pend.append((sent.dispatch(chunk_texts), tox_c.dispatch(chunk_texts)))
                continue
            n = len(chunk_texts)
            with prof.track("sentiment"):
                sentiments += sent.analyze_batch(chunk_texts) if sent_on else ["neutral"] * n
            with prof.track("toxicity"):
                tox += tox_c.check_batch(chunk_texts) if tox_on else [(False, 0.0)] * n
        if cls_pend:
            with prof.track("classify"):
                for sp, tp in cls_pend:
                    sentiments += sent.labels(sp)
                    tox += tox_c.verdicts(tp)
        prof.finish()
        return [
            {
                "generated_response": TOXIC_PLACEHOLDER if t else text,
                "sentiment": sent,
                "is_toxic": t,
            }
            for text, sent, (t, _) in zip(texts, sentiments, tox)
        ]

    def _dispatch_chunk(self, items: Sequence[dict], buckets) -> RAGStepOutput:
        """Tokenize one chunk, pad it to its bucket, run its fused step."""
        queries = [it.get("query", "") for it in items]
        qlen = self._query_len()
        emb_ids, emb_mask = self.embedder.tokenizer.encode_batch(queries, qlen)
        lm_ids, lm_mask = self.llm.tokenizer.encode_batch(queries, qlen)
        bucket = pick_bucket(len(items), buckets)
        emb_ids, emb_mask, lm_ids, lm_mask = (
            pad_rows(a, bucket) for a in (emb_ids, emb_mask, lm_ids, lm_mask)
        )
        emb_mask[len(items):, 0] = 1  # keep padded lanes position-valid
        lm_mask[len(items):, 0] = 1
        return self._get_pipe().step(emb_ids, emb_mask, lm_ids, lm_mask)

    def _fetch_texts(self, out: RAGStepOutput, n: int) -> list[str]:
        """One chunk's tokens to text, cut at the first eos."""
        toks = out.tokens.cpu().numpy()[:n]
        eos = self.llm.tokenizer.eos_id
        texts = []
        for row in toks:
            stop = np.where(row == eos)[0]
            end = int(stop[0]) if len(stop) else len(row)
            texts.append(self.llm.tokenizer.decode(row[:end]))
        return texts
