"""Device-resident RAG step: embed -> int8 scan + exact re-score ->
doc-token gather -> KV-cache decode (greedy, or n-gram speculation), all
on one device.

Port of `rag_inference_pipeline_tpu/engine/device_pipeline.py` at dp=1
over the int8 flat index. On CUDA the decode loop replays a captured graph
(`models/decode_graph.py`), the port's counterpart of the reference's one
compiled step. The document token store lives on the
device beside the index; retrieval ids gather context tokens there and the
decoder consumes them directly, so the host sees only final token ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.bert import BertConfig, bert_embed
from ..models.layers import ParamTree
from ..models.qwen import QwenConfig, greedy_generate, ngram_speculative_generate
from ..ops.topk import (
    binmax_partial_topk_int8gs,
    fused_topk_int8gs,
    quantize_global_int8,
)


class RAGStepOutput(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] generated token ids
    doc_ids: torch.Tensor  # [B, k] retrieved row ids
    scores: torch.Tensor  # [B, k] retrieval scores


@dataclass
class DeviceRAGPipeline:
    """Holds the device state of the fused step."""

    device: torch.device
    bert_cfg: BertConfig
    qwen_cfg: QwenConfig
    k: int = 5
    ctx_docs: int = 3
    max_new_tokens: int = 16
    rescore_k: int = 64
    # n-gram self-speculation in the decode (token-identical to greedy
    # unless the benchmark-only acceptance injection is set)
    speculative: bool = False
    spec_gamma: int = 8
    inject_accept_p: Optional[float] = None

    def build(
        self,
        bert_params: ParamTree,
        qwen_params: ParamTree,
        db: Optional[np.ndarray],  # [N, D] corpus embeddings (host path)
        doc_tokens: np.ndarray,  # [N, L] int32 doc token ids
        doc_token_mask: Optional[np.ndarray] = None,  # [N, L] validity mask
        *,
        # fast path: reuse a loaded int8 FlatIndex's device tensors instead
        # of uploading the corpus again
        db_i8: Optional[torch.Tensor] = None,
        db_scale: Optional[torch.Tensor] = None,
        db_rescore: Optional[torch.Tensor] = None,  # bf16, same rows as db_i8
        ntotal: Optional[int] = None,
    ) -> None:
        dev = self.device
        if doc_token_mask is None:
            # hash-tokenizer convention (pad id 0); real tokenizers pass the
            # explicit mask, since id 0 can be a real token
            doc_token_mask = (np.asarray(doc_tokens) > 0).astype(np.int32)
        self.bert_params = bert_params
        self.qwen_params = qwen_params
        if db_i8 is not None:
            if db_rescore is None:
                raise ValueError("the fast path requires the bf16 rescore copy")
            n = int(ntotal if ntotal is not None else db_i8.shape[0])
            self.db_i8 = db_i8.to(dev)
            self.db_scale = db_scale.to(dev, torch.float32)
            self.db = db_rescore.to(dev, torch.bfloat16)
        else:
            n = db.shape[0]
            dbt = torch.from_numpy(np.array(db, np.float32)).to(dev)
            self.db_i8, self.db_scale = quantize_global_int8(dbt)
            # bf16 copy for the exact shortlist re-score
            self.db = dbt.to(torch.bfloat16)
        n_pad = self.db_i8.shape[0]
        tok = np.asarray(doc_tokens, np.int32)
        msk = np.asarray(doc_token_mask, np.int32)
        if tok.shape[0] < n_pad:
            fill = np.zeros((n_pad - tok.shape[0], tok.shape[1]), np.int32)
            tok = np.concatenate([tok, fill])
            msk = np.concatenate([msk, fill])
        self.doc_tokens = torch.from_numpy(tok).to(dev)
        self.doc_token_mask = torch.from_numpy(msk).to(dev)
        self.ntotal = n

    def step(
        self,
        query_tokens: np.ndarray,
        query_mask: np.ndarray,
        lm_query_tokens: Optional[np.ndarray] = None,
        lm_query_mask: Optional[np.ndarray] = None,
        *,
        scan=binmax_partial_topk_int8gs,
    ) -> RAGStepOutput:
        """query_tokens: embedder token space; lm_query_tokens: decoder token
        space (doc tokens are stored in decoder space). When the two spaces
        coincide, the lm arrays may be omitted. `scan` as in
        `fused_topk_int8gs`."""
        if lm_query_tokens is None:
            lm_query_tokens, lm_query_mask = query_tokens, query_mask

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

        return _rag_step(
            self.bert_params, self.qwen_params, self.db, self.db_i8,
            self.db_scale, self.doc_tokens, self.doc_token_mask,
            dev(query_tokens), dev(query_mask),
            dev(lm_query_tokens), dev(lm_query_mask),
            bert_cfg=self.bert_cfg, qwen_cfg=self.qwen_cfg, k=self.k,
            ctx_docs=self.ctx_docs, max_new_tokens=self.max_new_tokens,
            ntotal=self.ntotal, rescore_k=self.rescore_k, scan=scan,
            speculative=self.speculative, spec_gamma=self.spec_gamma,
            inject_accept_p=self.inject_accept_p,
        )


@torch.inference_mode()
def _rag_step(
    bert_params,
    qwen_params,
    db,
    db_i8,
    db_scale,
    doc_tokens,
    doc_token_mask,
    query_tokens,
    query_mask,
    lm_query_tokens,
    lm_query_mask,
    *,
    bert_cfg: BertConfig,
    qwen_cfg: QwenConfig,
    k: int,
    ctx_docs: int,
    max_new_tokens: int,
    ntotal: int,
    rescore_k: int = 64,
    scan=binmax_partial_topk_int8gs,
    speculative: bool = False,
    spec_gamma: int = 8,
    inject_accept_p: Optional[float] = None,
) -> RAGStepOutput:
    # 1. embed queries
    emb = bert_embed(bert_params, bert_cfg, query_tokens, query_mask)

    # 2. int8 scan (K1) + exact bf16 re-score; ntotal masks the pad rows
    scores, ids = fused_topk_int8gs(
        emb, db_i8, db_scale, k, rescore_db=db, rescore_k=rescore_k,
        ntotal=ntotal, scan=scan,
    )

    # 3. decoder context from the device-resident doc tokens: the top
    #    ctx_docs docs' tokens, then the query tokens
    b = query_tokens.shape[0]
    ctx_ids = ids[:, :ctx_docs]  # [B, C]
    safe_ids = ctx_ids.clamp(min=0).long()
    ctx_toks = doc_tokens[safe_ids]  # [B, C, L]
    # valid = the store's per-token mask AND a real hit: an id of -1 (fewer
    # than ctx_docs hits) must not attend to doc 0
    tok_mask = doc_token_mask[safe_ids] * (ctx_ids >= 0).to(torch.int32)[:, :, None]
    prompt = torch.cat([ctx_toks.reshape(b, -1), lm_query_tokens], dim=1)
    pmask = torch.cat([tok_mask.reshape(b, -1), lm_query_mask], dim=1)
    # the decoder takes right-padded prompts (prefill writes the cache
    # contiguously): compact the holes left by per-doc padding, keeping
    # token order (stable)
    order = torch.argsort(1 - pmask, dim=1, stable=True)
    prompt = torch.gather(prompt, 1, order)
    pmask = torch.gather(pmask, 1, order)

    # 4. decode with a KV cache: greedy, or n-gram self-speculation
    kw = dict(eos_token_id=-1, cache_len=prompt.shape[1] + max_new_tokens)
    if speculative:
        toks, _ = ngram_speculative_generate(
            qwen_params, qwen_cfg, prompt, pmask, max_new_tokens,
            gamma=spec_gamma, inject_accept_p=inject_accept_p, **kw,
        )
    else:
        toks = greedy_generate(qwen_params, qwen_cfg, prompt, pmask,
                               max_new_tokens, **kw)
    return RAGStepOutput(tokens=toks, doc_ids=ids, scores=scores)
