"""BERT-family encoder in PyTorch: the BGE embedder, the BGE cross-encoder
reranker (XLM-RoBERTa-base) and the BERT classifiers. Port of
`rag_inference_pipeline_tpu/models/bert.py`.

Every forward also takes a tp-sharded tree (`layers.TPTree`, from
`parallel/sharding.py`): each shard runs its `heads / tp` heads (on the
card at T >= 1024 the flash kernel once a shard a layer), o and ffn_out are
row-parallel (`layers.row_dense`, the bias added once after the sum), and
the LayerNorms run on the summed residual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .layers import (
    ParamTree,
    dense,
    dense_group,
    encoder_attention,
    gelu,
    layer_norm,
    quantize_linear,
    row_dense,
    shards_of,
    spread,
)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    eps: float = 1e-12
    # RoBERTa-style: positions start at pad_token_id + 1 and skip padding
    roberta_positions: bool = False
    pad_token_id: int = 0
    num_labels: int = 0  # 0 = no classification head

    @staticmethod
    def bge_base() -> "BertConfig":
        """BAAI/bge-base-en-v1.5 (BERT-base)."""
        return BertConfig()

    @staticmethod
    def bge_reranker() -> "BertConfig":
        """BAAI/bge-reranker-base (XLM-RoBERTa-base, 1 logit)."""
        return BertConfig(
            vocab_size=250002,
            max_positions=514,
            type_vocab=1,
            eps=1e-5,
            roberta_positions=True,
            pad_token_id=1,
            num_labels=1,
        )

    @staticmethod
    def sentiment() -> "BertConfig":
        """nlptown/bert-base-multilingual-uncased-sentiment (5 stars)."""
        return BertConfig(vocab_size=105879, num_labels=5)

    @staticmethod
    def toxicity() -> "BertConfig":
        """unitary/toxic-bert (6 multi-label heads)."""
        return BertConfig(num_labels=6)

    @staticmethod
    def tiny(num_labels: int = 0) -> "BertConfig":
        """For tests: 2 layers, 64 hidden."""
        return BertConfig(
            vocab_size=1024,
            hidden=64,
            layers=2,
            heads=4,
            intermediate=128,
            max_positions=128,
            num_labels=num_labels,
        )


def init_bert_params(
    cfg: BertConfig,
    *,
    generator: Optional[torch.Generator],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> ParamTree:
    """Random init with the reference's tree layout and distributions
    (weights N(0, 0.02^2), norms 1, biases 0). `generator` lives on
    `device`; `device="meta"` with no generator builds the bare skeleton."""
    std = 0.02

    def w(*shape):
        if generator is None:  # the skeleton: no draw (a meta draw is slow)
            return torch.empty(shape, dtype=dtype, device=device)
        return (
            std * torch.randn(shape, generator=generator, device=device)
        ).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    h, i_ = cfg.hidden, cfg.intermediate
    tree = {
        "embeddings": {
            "word": w(cfg.vocab_size, h),
            "position": w(cfg.max_positions, h),
            "token_type": w(cfg.type_vocab, h),
            "ln_w": ones(h),
            "ln_b": zeros(h),
        },
        "layers": [
            {
                "q_w": w(h, h), "q_b": zeros(h),
                "k_w": w(h, h), "k_b": zeros(h),
                "v_w": w(h, h), "v_b": zeros(h),
                "o_w": w(h, h), "o_b": zeros(h),
                "attn_ln_w": ones(h), "attn_ln_b": zeros(h),
                "ffn_in_w": w(h, i_), "ffn_in_b": zeros(i_),
                "ffn_out_w": w(i_, h), "ffn_out_b": zeros(h),
                "ffn_ln_w": ones(h), "ffn_ln_b": zeros(h),
            }
            for _ in range(cfg.layers)
        ],
        "pooler": {"w": w(h, h), "b": zeros(h)},
    }
    if cfg.num_labels:
        tree["classifier"] = {
            "w": w(h, cfg.num_labels), "b": zeros(cfg.num_labels),
        }
    return ParamTree(tree)


_QUANT_KEYS = ("q_w", "k_w", "v_w", "o_w", "ffn_in_w", "ffn_out_w")


def quantize_bert_params(params: ParamTree) -> ParamTree:
    """The W8A8 tree of `params`, as the reference's `quantize_bert_params`
    (`rag_inference_pipeline_tpu/models/bert.py:135-170`): the q/k/v/o and
    FFN projections, the pooler and the classifier become
    `QuantizedLinear`; the embedding tables, LayerNorms and biases are the
    same tensors. `params` itself is left as it is."""
    tree = params.to_tree()
    tree["pooler"]["w"] = quantize_linear(tree["pooler"]["w"])
    if "classifier" in tree:
        tree["classifier"]["w"] = quantize_linear(tree["classifier"]["w"])
    for lp in tree["layers"]:
        for k in _QUANT_KEYS:
            lp[k] = quantize_linear(lp[k])
    return ParamTree(tree)


def bert_encode(
    params: ParamTree,
    cfg: BertConfig,
    input_ids: torch.Tensor,  # [B, T] int
    attn_mask: torch.Tensor,  # [B, T] {0,1}
    token_type_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backbone forward -> [B, T, H] hidden states (post-LN BERT), the
    layers over the tree's tp shards (one for an unsplit tree)."""
    b, t = input_ids.shape
    emb = params.embeddings
    ids = input_ids.long()
    if cfg.roberta_positions:
        pos = torch.cumsum(attn_mask, dim=1) * attn_mask + cfg.pad_token_id
    else:
        pos = torch.arange(t, device=ids.device).expand(b, t)
    tt = token_type_ids if token_type_ids is not None else torch.zeros_like(ids)
    x = emb.word[ids] + emb.position[pos.long()] + emb.token_type[tt.long()]
    x = layer_norm(x, emb.ln_w, emb.ln_b, cfg.eps)
    shards, devs = shards_of(params)
    tp = len(shards)
    dh = cfg.hidden // cfg.heads
    masks = spread(attn_mask, devs)
    for li in range(cfg.layers):
        lps = [sh.layers[li] for sh in shards]
        parts = []
        for lp, xj, mj in zip(lps, spread(x, devs), masks):
            q, k, v = (y.reshape(b, t, cfg.heads // tp, dh) for y in dense_group(
                xj, (lp.q_w, lp.k_w, lp.v_w), (lp.q_b, lp.k_b, lp.v_b)))
            parts.append(encoder_attention(q, k, v, mj).reshape(b, t, -1))
        lp0 = lps[0]
        x = layer_norm(x + row_dense(parts, [lp.o_w for lp in lps], lp0.o_b),
                       lp0.attn_ln_w, lp0.attn_ln_b, cfg.eps)
        hs = [gelu(dense(xj, lp.ffn_in_w, lp.ffn_in_b)) for lp, xj in zip(lps, spread(x, devs))]
        x = layer_norm(x + row_dense(hs, [lp.ffn_out_w for lp in lps], lp0.ffn_out_b),
                       lp0.ffn_ln_w, lp0.ffn_ln_b, cfg.eps)
    return x


def bert_embed(params: ParamTree, cfg: BertConfig, input_ids, attn_mask):
    """Sentence embedding: CLS token + L2 normalize (BGE pooling), f32."""
    h = bert_encode(params, cfg, input_ids, attn_mask)
    cls = h[:, 0, :].float()
    return cls / torch.clamp(cls.norm(dim=-1, keepdim=True), min=1e-9)


def bert_classify(
    params: ParamTree, cfg: BertConfig, input_ids, attn_mask,
    token_type_ids=None, *, use_pooler: bool = True,
) -> torch.Tensor:
    """Sequence classification logits [B, num_labels], f32."""
    h = bert_encode(params, cfg, input_ids, attn_mask, token_type_ids)
    cls = h[:, 0, :]
    if use_pooler:
        cls = torch.tanh(dense(cls, params.pooler.w, params.pooler.b))
    return dense(cls, params.classifier.w, params.classifier.b).float()
