"""Fused serving executor: the whole RAG hot path as one device step per
chunk of requests, then the joint sentiment + toxicity classifier.

Port of `rag_inference_pipeline_tpu/engine/fused_executor.py` (dp=1,
greedy). Batches are cut into chunks of at most `fused_chunk_lanes` lanes,
each padded to a shape bucket exactly as the reference pads it: the query's
int8 scale is batch-wide, so padded lanes take part in it and a different
padding would change ids. Requires a document token store
(`doc_tokens.npy`, decoder token space) beside the int8 flat index.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import Settings
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
    ) -> None:
        self.settings = settings
        self.device = device
        self.embedder = embedder
        self.index = index
        self.llm = llm
        self.sentiment = sentiment
        self.toxicity = toxicity
        self._pipe: Optional[DeviceRAGPipeline] = None
        self.doc_tokens: Optional[np.ndarray] = None

    @property
    def is_loaded(self) -> bool:
        return self.doc_tokens is not None

    def load(self) -> None:
        s = self.settings
        if not s.doc_tokens_path:
            raise ValueError("use_fused_pipeline requires doc_tokens_path")
        if s.use_speculative_decoding:
            raise NotImplementedError("speculative decoding is not ported yet")
        self.doc_tokens = np.load(s.doc_tokens_path).astype(np.int32)
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
                    idx._db_i8[: self._ntotal].float() * idx._db_gscale
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
        s = self.settings
        buckets = s.shape_buckets
        max_chunk = max(buckets)
        if s.fused_chunk_lanes > 0:
            max_chunk = min(max_chunk, s.fused_chunk_lanes)
        spans = chunk_spans(len(items), max_chunk)
        # CUDA launches are asynchronous: every chunk's step is queued on
        # the device before the first chunk's tokens are fetched
        pend = [self._dispatch_chunk(items[a:b], buckets) for a, b in spans]
        texts: list[str] = []
        sentiments: list[str] = []
        tox: list[tuple[bool, float]] = []
        for (a, b), out in zip(spans, pend):
            chunk_texts = self._fetch_texts(out, b - a)
            labels, verdicts = self._classify_joint(chunk_texts)
            texts.extend(chunk_texts)
            sentiments.extend(labels)
            tox.extend(verdicts)
        return [
            {
                "generated_response": TOXIC_PLACEHOLDER if t else text,
                "sentiment": sent,
                "is_toxic": t,
            }
            for text, sent, (t, _) in zip(texts, sentiments, tox)
        ]

    def _classify_joint(
        self, texts: Sequence[str]
    ) -> tuple[list[str], list[tuple[bool, float]]]:
        """Sentiment (argmax 5-star label) and toxicity (largest sigmoid vs
        0.5) over the same texts, each chunked and padded to the shape
        buckets. A classifier that is not loaded answers "neutral" / not
        toxic."""
        sent, tox = self.sentiment, self.toxicity
        n = len(texts)
        labels = (
            sent.analyze_batch(texts) if sent is not None and sent.is_loaded
            else ["neutral"] * n
        )
        verdicts = (
            tox.check_batch(texts) if tox is not None and tox.is_loaded
            else [(False, 0.0)] * n
        )
        return labels, verdicts

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
