"""Device-resident RAG step: embed -> int8 scan + exact re-score ->
doc-token gather -> KV-cache decode (greedy, or n-gram speculation), on
one device or over the dp positions of a mesh.

Port of `rag_inference_pipeline_tpu/engine/device_pipeline.py` over the
int8 flat index. On CUDA the decode loop replays a captured graph
(`models/decode_graph.py`), the port's counterpart of the reference's one
compiled step. The document token store lives on the
device beside the index; retrieval ids gather context tokens there and the
decoder consumes them directly, so the host sees only final token ids.

With a `core/mesh.py` mesh of dp > 1 (the reference's `_rag_step`
branches, `:288-320`): the database, its rescore copy and the token store
are row-sharded over dp; the batch must be a dp multiple. The embed and
the decode run batch-over-dp, as the reference's `batch_sharding`: one
slice of B/dp rows a position, the weights once per distinct device. The
scan is `sharded_topk_int8gs` (K1 once a shard) over the whole batch (the
query's int8 scale is batch-wide), and the winners' tokens come from
`sharded_token_gather`. On a mesh that repeats one device the slices run
one after another.

With tp > 1 (the reference's `:145-149`) the BERT and Qwen trees are split
over each dp position's tp group (`parallel/sharding.py::place_params`),
and each position's embed and decode run on its group's shards. The scan
and the token gather stay over dp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.mesh import MeshContext
from ..models.bert import BertConfig, bert_embed
from ..models.layers import ParamTree, over_dp
from ..parallel.sharding import place_params
from ..models.qwen import QwenConfig, greedy_generate, ngram_speculative_generate
from ..ops.topk import (
    binmax_partial_topk_int8gs,
    fused_topk_int8gs,
    quantize_global_int8,
    sharded_topk_int8gs,
)


def sharded_token_gather(
    mesh: MeshContext,
    doc_tokens: list[torch.Tensor],  # dp row blocks of [N_pad, L] i32
    doc_token_mask: list[torch.Tensor],  # dp row blocks of [N_pad, L] i32
    ids: torch.Tensor,  # [B, C] global row ids (-1 = no hit)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The winners' tokens and masks [B, C, L] from a dp-row-sharded store
    (reference `:52-86`): each position contributes the rows it owns and
    zeros elsewhere, and the contributions are summed on the front device
    (the reference's psum), so the store stays 1/dp a position."""
    rows = doc_tokens[0].shape[0]
    toks, msks = [], []
    for shard, (dev, tok_l, msk_l) in enumerate(zip(mesh.devices, doc_tokens, doc_token_mask)):
        gid = ids.to(dev)
        lid = gid - shard * rows
        mine = ((lid >= 0) & (lid < rows) & (gid >= 0)).to(torch.int32)[..., None]
        safe = lid.clamp(0, rows - 1).long()
        toks.append((tok_l[safe] * mine).to(mesh.front))
        msks.append((msk_l[safe] * mine).to(mesh.front))
    return torch.stack(toks).sum(0, dtype=torch.int32), torch.stack(msks).sum(0, dtype=torch.int32)


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
    # dp > 1: the database, the token store and the batch over dp
    mesh: Optional[MeshContext] = None

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
        db_i8=None,  # a tensor, or its dp row shards (a sharded FlatIndex's)
        db_scale=None,
        db_rescore=None,  # bf16, same rows (and shards) as db_i8
        ntotal: Optional[int] = None,
    ) -> None:
        dev = self.device
        if doc_token_mask is None:
            # hash-tokenizer convention (pad id 0); real tokenizers pass the
            # explicit mask, since id 0 can be a real token
            doc_token_mask = (np.asarray(doc_tokens) > 0).astype(np.int32)
        if self.mesh is not None and self.mesh.dp > 1:
            self._build_sharded(bert_params, qwen_params, db, doc_tokens, doc_token_mask,
                                db_i8, db_scale, db_rescore, ntotal)
            return
        if self.mesh is not None and self.mesh.tp > 1:
            bert_params = place_params(self.mesh, bert_params, self.bert_cfg)[0]
            qwen_params = place_params(self.mesh, qwen_params, self.qwen_cfg)[0]
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

    def _build_sharded(self, bert_params, qwen_params, db, doc_tokens, doc_token_mask,
                       db_i8, db_scale, db_rescore, ntotal) -> None:
        """dp > 1: the weights once per distinct device (split over each
        position's tp group with tp > 1), the database, its rescore copy and
        the token store in dp row shards."""
        mesh = self.mesh
        dp, rows = mesh.dp, mesh.rows_dp
        self.bert_params = place_params(mesh, bert_params, self.bert_cfg)
        self.qwen_params = place_params(mesh, qwen_params, self.qwen_cfg)
        if db_i8 is not None:
            if db_rescore is None:
                raise ValueError("the fast path requires the bf16 rescore copy")
            n = int(ntotal if ntotal is not None else sum(s.shape[0] for s in db_i8))
            if isinstance(db_i8, torch.Tensor):
                if db_i8.shape[0] % dp:
                    raise ValueError(
                        f"device-resident db rows {db_i8.shape[0]} not divisible "
                        f"by dp={dp}; use the host build path"
                    )
                db_i8, db_rescore = mesh.put(db_i8, rows), mesh.put(db_rescore, rows)
            self.db_i8 = list(db_i8)
            self.db = [s.to(torch.bfloat16) for s in db_rescore]
            scale = db_scale[0] if isinstance(db_scale, (list, tuple)) else db_scale
            self.db_scale = mesh.put(scale.float())
        else:
            n = db.shape[0]
            # the reference pads to a dp multiple before it quantizes
            pad = -n % dp
            host = np.concatenate([np.asarray(db, np.float32),
                                   np.zeros((pad, db.shape[1]), np.float32)])
            dbt = torch.from_numpy(host).to(mesh.front)
            q_i8, scale = quantize_global_int8(dbt)
            self.db_i8 = mesh.put(q_i8, rows)
            self.db_scale = mesh.put(scale)
            self.db = mesh.put(dbt.to(torch.bfloat16), rows)
        n_pad = sum(s.shape[0] for s in self.db_i8)
        tok = np.asarray(doc_tokens, np.int32)[:n_pad]
        msk = np.asarray(doc_token_mask, np.int32)[:n_pad]
        fill = np.zeros((n_pad - tok.shape[0], tok.shape[1]), np.int32)
        self.doc_tokens = mesh.put(np.concatenate([tok, fill]), rows)
        self.doc_token_mask = mesh.put(np.concatenate([msk, fill]), rows)
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
        dp = self.mesh.dp if self.mesh is not None else 1
        if query_tokens.shape[0] % dp != 0:
            raise ValueError(
                f"batch {query_tokens.shape[0]} must be a multiple of "
                f"dp={dp} (pad the batch bucket up to a dp multiple)"
            )

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
            mesh=self.mesh if dp > 1 else None,
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
    mesh: Optional[MeshContext] = None,
) -> RAGStepOutput:
    # 1. embed queries (batch over dp)
    if mesh is None:
        emb = bert_embed(bert_params, bert_cfg, query_tokens, query_mask)
    else:
        emb = over_dp(mesh.devices, lambda p, t, m: bert_embed(p, bert_cfg, t, m),
                      bert_params, query_tokens, query_mask)

    # 2. int8 scan (K1, once a shard over dp) + exact bf16 re-score; ntotal
    #    masks the pad rows
    if mesh is None:
        scores, ids = fused_topk_int8gs(
            emb, db_i8, db_scale, k, rescore_db=db, rescore_k=rescore_k,
            ntotal=ntotal, scan=scan,
        )
    else:
        scores, ids = sharded_topk_int8gs(
            mesh, emb, db_i8, db_scale, k, rescore_db_shards=db,
            rescore_k=rescore_k, ntotal=ntotal, scan=scan,
        )

    # 3. decoder context from the device-resident doc tokens: the top
    #    ctx_docs docs' tokens, then the query tokens
    b = query_tokens.shape[0]
    ctx_ids = ids[:, :ctx_docs]  # [B, C]
    if mesh is None:
        safe_ids = ctx_ids.clamp(min=0).long()
        ctx_toks = doc_tokens[safe_ids]  # [B, C, L]
        # valid = the store's per-token mask AND a real hit: an id of -1
        # (fewer than ctx_docs hits) must not attend to doc 0
        tok_mask = doc_token_mask[safe_ids] * (ctx_ids >= 0).to(torch.int32)[:, :, None]
    else:
        # owners contribute their rows; an id of -1 has no owner
        ctx_toks, tok_mask = sharded_token_gather(mesh, doc_tokens, doc_token_mask, ctx_ids)
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

    def decode(params, p, m):
        if speculative:
            return ngram_speculative_generate(
                params, qwen_cfg, p, m, max_new_tokens,
                gamma=spec_gamma, inject_accept_p=inject_accept_p, **kw,
            )[0]
        return greedy_generate(params, qwen_cfg, p, m, max_new_tokens, **kw)

    if mesh is None:
        toks = decode(qwen_params, prompt, pmask)
    else:  # batch over dp
        toks = over_dp(mesh.devices, decode, qwen_params, prompt, pmask)
    return RAGStepOutput(tokens=toks, doc_ids=ids, scores=scores)
