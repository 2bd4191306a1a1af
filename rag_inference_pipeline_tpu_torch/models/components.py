"""Model components: embedder, reranker, LLM, sentiment and toxicity —
load (random init when no weights are given), tokenizer, params on the
port's device, and the batch APIs of the staged path.

Port of `rag_inference_pipeline_tpu/models/components.py`: the embedder's
SHA-256-keyed cache, the reranker's sigmoid relevance sorted descending,
the LLM's chat prompt from the top docs (`llm_doc_chars` each) with
prefill buckets, the 5-star sentiment labels and the 0.5 toxicity
threshold. Every forward runs over row chunks padded to the shape buckets,
as the reference pads them. PyTorch runs eagerly, so there is no
per-bucket compile warmup to port, and the LLM's ladder is the configured
one (the reference clamps it to a 16 GB TPU's memory). Loading safetensors
checkpoints comes with a later port of the weights converter; until then a
checkpoint under `MODEL_WEIGHTS_DIR` raises rather than being ignored.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.config import Settings
from ..core.device import torch_dtype
from ..utils.cache import LRUCache
from ..utils.shapes import chunk_spans, pad_rows, pick_bucket
from .bert import (
    BertConfig,
    bert_classify,
    bert_embed,
    init_bert_params,
    quantize_bert_params,
)
from .qwen import (
    QwenConfig,
    greedy_generate,
    init_qwen_params,
    ngram_speculative_generate,
)
from .tokenizer import make_tokenizer

logger = logging.getLogger(__name__)

_SENTIMENT_LABELS = [
    "very negative", "negative", "neutral", "positive", "very positive",
]

_BERT_CONFIGS = {
    "BAAI/bge-base-en-v1.5": BertConfig.bge_base,
    "BAAI/bge-reranker-base": BertConfig.bge_reranker,
    "nlptown/bert-base-multilingual-uncased-sentiment": BertConfig.sentiment,
    "unitary/toxic-bert": BertConfig.toxicity,
}


def _bert_config_for(name: str, num_labels: int = 0) -> BertConfig:
    if name in _BERT_CONFIGS:
        return _BERT_CONFIGS[name]()
    if name.startswith("tiny"):
        return BertConfig.tiny(num_labels=num_labels)
    raise ValueError(f"unknown bert model {name!r}")


def _qwen_config_for(name: str) -> QwenConfig:
    lname = name.lower()
    if lname.startswith("tiny"):
        return QwenConfig.tiny()
    if lname == "qwen/qwen2.5-0.5b-instruct":
        return QwenConfig.qwen25_05b()
    if lname in ("meta-llama/llama-3.2-1b-instruct", "meta-llama/llama-3.2-1b"):
        return QwenConfig.llama32_1b()
    if lname in ("meta-llama/llama-3.1-8b-instruct", "meta-llama/llama-3.1-8b"):
        return QwenConfig.llama31_8b()
    raise ValueError(f"unknown llm model {name!r}")


@torch.inference_mode()
def _bucketed_forward(fwd, arrays: Sequence[np.ndarray], buckets, device) -> np.ndarray:
    """`fwd` over row chunks of at most the largest bucket, each padded to
    its bucket; returns the real rows' outputs as float32 numpy."""
    n = arrays[0].shape[0]
    outs = []
    for s, e in chunk_spans(n, max(buckets)):
        bucket = pick_bucket(e - s, buckets)
        padded = [torch.from_numpy(pad_rows(a[s:e], bucket)).to(device) for a in arrays]
        outs.append(fwd(*padded)[: e - s].float().cpu().numpy())
    return np.concatenate(outs)


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _check_no_checkpoint(settings: Settings, model_name: str) -> None:
    wdir = settings.model_weights_dir
    if wdir and os.path.isdir(os.path.join(wdir, model_name.replace("/", "__"))):
        raise NotImplementedError(
            f"{model_name}: checkpoint loading is not ported yet; unset "
            "MODEL_WEIGHTS_DIR to serve random weights"
        )
    if not settings.allow_random_weights:
        raise FileNotFoundError(f"no weights for {model_name} under {wdir}")


class _BertBase:
    """Shared load for BERT-backed components."""

    def __init__(
        self, settings: Settings, model_name: str, device: torch.device,
        num_labels: int = 0,
    ) -> None:
        self.settings = settings
        self.model_name = model_name
        self.device = device
        self.cfg = _bert_config_for(model_name, num_labels)
        self.max_len = min(settings.truncate_length, self.cfg.max_positions)
        self.params = None
        self.tokenizer = None
        self.random_weights = False

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        s = self.settings
        _check_no_checkpoint(s, self.model_name)
        logger.warning(
            "%s: no local weights for %s — random init",
            type(self).__name__, self.model_name,
        )
        self.params = init_bert_params(
            self.cfg, generator=_generator(self.device),
            dtype=torch_dtype(s.param_dtype), device=self.device,
        )
        if s.encoder_weight_quant == "int8":
            # W8A8-dynamic encoder, quantized after load as the reference's
            # components do
            self.params = quantize_bert_params(self.params)
        self.random_weights = True
        self.tokenizer = make_tokenizer(
            self.model_name, s.model_weights_dir,
            vocab_size=self.cfg.vocab_size, pad_id=self.cfg.pad_token_id,
        )

    def _forward(self, fwd, arrays: Sequence[np.ndarray]) -> np.ndarray:
        return _bucketed_forward(
            lambda *t: fwd(self.params, self.cfg, *t), arrays,
            self.settings.shape_buckets, self.device,
        )


class EmbedderComponent(_BertBase):
    """Query embedding (BGE): `encode` returns L2-normalized float32 [B,
    dim], cached by the SHA-256 of the text; the fused step runs its
    forward itself."""

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.embedding_model, device)
        self.cache = LRUCache(settings.embedding_cache_capacity)

    @property
    def dim(self) -> int:
        return self.cfg.hidden

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if not self.is_loaded:
            raise RuntimeError("embedder not loaded")
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        keys = [hashlib.sha256(t.encode()).hexdigest() for t in texts]
        out: dict[int, np.ndarray] = {}
        misses: list[int] = []
        for i, k in enumerate(keys):
            hit = self.cache.get(k)
            if hit is not None:
                out[i] = hit
            else:
                misses.append(i)
        if misses:
            ids, mask = self.tokenizer.encode_batch(
                [texts[i] for i in misses], self.max_len
            )
            emb = self._forward(bert_embed, (ids, mask))
            for j, i in enumerate(misses):
                out[i] = emb[j]
                self.cache.put(keys[i], emb[j])
        return np.stack([out[i] for i in range(len(texts))])


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class RerankerComponent(_BertBase):
    """Cross-encoder rerank: (query, doc) pairs -> sigmoid relevance,
    sorted descending, with `rerank_score` added to each doc."""

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.reranker_model, device, num_labels=1)
        self.max_len = min(settings.truncate_length, self.cfg.max_positions - 2)

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        if not self.is_loaded:
            raise RuntimeError("reranker not loaded")
        if not pairs:
            return np.zeros((0,), np.float32)
        ids, mask, tt = self.tokenizer.encode_pair_batch(pairs, self.max_len)
        if self.cfg.type_vocab == 1:
            # XLM-RoBERTa has one token type and its tokenizer gives all 0;
            # the hash tokenizer's second segment (type 1) has no row, where
            # the reference gathers NaN (ROADMAP.md Queue 3)
            tt = np.zeros_like(tt)
        logits = self._forward(bert_classify, (ids, mask, tt))[:, 0]
        return _sigmoid(logits)

    def _top(self, docs: Sequence[dict], scores: np.ndarray, top_n) -> list[dict]:
        order = np.argsort(-scores)
        top_n = top_n or self.settings.rerank_top_n
        return [{**docs[i], "rerank_score": float(scores[i])} for i in order[:top_n]]

    def rerank(
        self, query: str, docs: Sequence[dict], top_n: Optional[int] = None
    ) -> list[dict]:
        """docs: [{id, content, ...}] -> the top_n docs with 'rerank_score'."""
        if not docs:
            return []
        scores = self.score_pairs([(query, d.get("content", "")) for d in docs])
        return self._top(docs, scores, top_n)

    def rerank_batch(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        top_n: Optional[int] = None,
    ) -> list[list[dict]]:
        """Every query's pairs scored in one bucketed batch."""
        pairs, spans = [], []
        for q, docs in zip(queries, docs_batch):
            start = len(pairs)
            pairs.extend((q, d.get("content", "")) for d in docs)
            spans.append((start, len(pairs)))
        if not pairs:
            return [[] for _ in queries]
        scores = self.score_pairs(pairs)
        return [
            self._top(docs, scores[a:b], top_n)
            for (a, b), docs in zip(spans, docs_batch)
        ]


class SentimentComponent(_BertBase):
    """5-star sentiment head; labels in `_SENTIMENT_LABELS`."""

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.sentiment_model, device, num_labels=5)

    def analyze_batch(self, texts: Sequence[str]) -> list[str]:
        if not self.is_loaded:
            raise RuntimeError("sentiment not loaded")
        if not texts:
            return []
        ids, mask = self.tokenizer.encode_batch([t[:512] for t in texts], self.max_len)
        logits = self._forward(bert_classify, (ids, mask))
        return [_SENTIMENT_LABELS[int(i)] for i in logits.argmax(axis=1)]


class ToxicityComponent(_BertBase):
    """Multi-label toxicity head: toxic when the largest sigmoid >= 0.5."""

    THRESHOLD = 0.5

    def __init__(self, settings: Settings, device: torch.device):
        super().__init__(settings, settings.toxicity_model, device, num_labels=6)

    def check_batch(self, texts: Sequence[str]) -> list[tuple[bool, float]]:
        if not self.is_loaded:
            raise RuntimeError("toxicity not loaded")
        if not texts:
            return []
        ids, mask = self.tokenizer.encode_batch([t[:512] for t in texts], self.max_len)
        worst = _sigmoid(self._forward(bert_classify, (ids, mask))).max(axis=1)
        return [(bool(w >= self.THRESHOLD), float(w)) for w in worst]


class LLMComponent:
    """Causal LM (Qwen2 / Llama family): greedy decode, or n-gram
    speculation (`use_speculative_decoding`), per bucketed batch; or,
    with `use_continuous_batching`, one request at a time through the
    decode engine that `start()` runs."""

    def __init__(self, settings: Settings, device: torch.device):
        self.settings = settings
        self.device = device
        self.model_name = settings.llm_model
        self.cfg = _qwen_config_for(self.model_name)
        lname = self.model_name.lower()
        # base checkpoints stop at end-of-text, instruct ones at the chat
        # turn delimiter
        self.is_instruct = "instruct" in lname or lname.startswith("tiny")
        self.params = None
        self.tokenizer = None
        self.random_weights = False
        self.engine = None

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def load(self) -> None:
        s = self.settings
        _check_no_checkpoint(s, self.model_name)
        logger.warning("LLM: no local weights for %s — random init", self.model_name)
        # W8A8-dynamic int8 at the source: each matmul leaf is quantized as
        # it is drawn, so the full-precision tree never exists
        self.params = init_qwen_params(
            self.cfg, generator=_generator(self.device),
            dtype=torch_dtype(s.param_dtype), device=self.device,
            quantize=s.llm_weight_quant == "int8",
        )
        self.random_weights = True
        fam_llama = self.model_name.lower().startswith("meta-llama")
        if self.is_instruct:
            eos_token = "<|eot_id|>" if fam_llama else "<|im_end|>"
        else:
            eos_token = "<|end_of_text|>" if fam_llama else "<|endoftext|>"
        self.tokenizer = make_tokenizer(
            self.model_name, s.model_weights_dir,
            vocab_size=self.cfg.vocab_size, pad_id=0, eos_id=2,
            eos_token=eos_token,
        )

    def build_prompt(self, query: str, docs: Sequence[dict]) -> str:
        """Chat-template prompt from the top `llm_context_docs` docs, each
        cut to `llm_doc_chars`, per model family."""
        s = self.settings
        ctx = "\n\n".join(
            f"Document {i + 1}: {d.get('content', '')[: s.llm_doc_chars]}"
            for i, d in enumerate(docs[: s.llm_context_docs])
        )
        sys_msg = (
            "You are a helpful assistant. Use the provided "
            "context to answer the question."
        )
        user_msg = f"Context:\n{ctx}\n\nQuestion: {query}"
        if not self.is_instruct:
            return f"{sys_msg}\n\n{user_msg}\n\nAnswer:"
        if self.model_name.lower().startswith("meta-llama"):
            return (
                "<|begin_of_text|><|start_header_id|>system"
                f"<|end_header_id|>\n\n{sys_msg}<|eot_id|>"
                "<|start_header_id|>user"
                f"<|end_header_id|>\n\n{user_msg}<|eot_id|>"
                "<|start_header_id|>assistant<|end_header_id|>\n\n"
            )
        return (
            f"<|im_start|>system\n{sys_msg}<|im_end|>\n"
            f"<|im_start|>user\n{user_msg}<|im_end|>\n"
            "<|im_start|>assistant\n"
        )

    def generate_batch(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        max_new_tokens: Optional[int] = None,
    ) -> list[str]:
        """Greedy answers, one per query: prompts cut to a prefill bucket
        that covers the longest, rows padded to a shape bucket (a padded
        row keeps one live token), each answer cut at the first eos."""
        if not self.is_loaded:
            raise RuntimeError("llm not loaded")
        if not queries:
            return []
        s = self.settings
        max_new = max_new_tokens or s.max_tokens
        prompts = [self.build_prompt(q, d) for q, d in zip(queries, docs_batch)]
        plen_cap = min(s.truncate_length, self.cfg.max_len - max_new)
        all_ids, all_mask = self.tokenizer.encode_batch(prompts, plen_cap)
        ladder = s.shape_buckets
        eos = self.tokenizer.eos_id
        out: list[str] = []
        for cs, ce in chunk_spans(len(prompts), max(ladder)):
            ids, mask = all_ids[cs:ce], all_mask[cs:ce]
            longest = int(mask.sum(axis=1).max())
            plen = min(pick_bucket(longest, s.prefill_bucket_list + (plen_cap,)), plen_cap)
            bucket = pick_bucket(ce - cs, ladder)
            ids = pad_rows(ids[:, :plen], bucket)
            mask = pad_rows(mask[:, :plen], bucket)
            mask[ce - cs :, 0] = 1
            args = (self.params, self.cfg, torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(mask).to(self.device), max_new)
            kw = dict(eos_token_id=eos, cache_len=plen + max_new)
            if s.use_speculative_decoding:
                toks, _ = ngram_speculative_generate(
                    *args, gamma=s.speculative_gamma,
                    inject_accept_p=s.speculative_inject_p, **kw,
                )
            else:
                toks = greedy_generate(*args, **kw)
            for row in toks[: ce - cs].cpu().numpy():
                stop = np.where(row == eos)[0]
                end = int(stop[0]) if len(stop) else len(row)
                out.append(self.tokenizer.decode(row[:end]))
        return out

    # -- continuous-batching engine mode ------------------------------------
    async def start(self) -> None:
        """Start the persistent-lane decode engine when
        `use_continuous_batching` is set (engine/decode_engine.py); with
        speculation on too, its segments are verify rounds."""
        s = self.settings
        if not s.use_continuous_batching or not self.is_loaded or self.engine:
            return
        from ..engine.decode_engine import DecodeEngine

        self.engine = DecodeEngine(
            self.params, self.cfg,
            lanes=s.decode_max_concurrency,
            cache_len=s.kv_cache_max_len,
            segment_steps=s.decode_segment_steps,
            eos_token_id=self.tokenizer.eos_id,
            admit_buckets=s.shape_buckets,
            prefill_buckets=s.prefill_bucket_list,
            pipeline_segments=s.decode_pipeline_segments,
            speculative=s.use_speculative_decoding,
            gamma=s.speculative_gamma,
            spec_rounds=s.speculative_rounds,
            inject_accept_p=s.speculative_inject_p,
        )
        await self.engine.start()

    async def stop(self) -> None:
        if self.engine is not None:
            await self.engine.stop()
            self.engine = None

    async def generate_batch_engine(
        self, queries: Sequence[str], docs_batch: Sequence[Sequence[dict]],
        max_new_tokens: Optional[int] = None,
    ) -> list[str]:
        """One engine submission per request: a short answer returns as soon
        as its lane finishes, whatever the rest of the batch does."""
        if self.engine is None:
            raise RuntimeError("generation not ready: the decode engine is not running")
        s = self.settings
        max_new = max_new_tokens or s.max_tokens
        cap = min(s.truncate_length, self.cfg.max_len - max_new)
        subs = []
        for q, d in zip(queries, docs_batch):
            ids, mask = self.tokenizer.encode(self.build_prompt(q, d), cap)
            subs.append(self.engine.submit(ids[: int(mask.sum())], max_new))
        return [self.tokenizer.decode(t) for t in await asyncio.gather(*subs)]
