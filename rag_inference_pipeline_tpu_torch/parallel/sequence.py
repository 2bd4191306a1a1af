"""Sequence parallelism: the encoder with its tokens split over a mesh axis.

Port of `rag_inference_pipeline_tpu/parallel/sequence.py`. The embeddings,
LayerNorms and MLPs of each sp position run on its T/sp tokens; each
attention gathers every position's K, V and key mask in position order
(the reference's tiled all-gather) while the queries stay local, so a
query still sees every key and the valid rows match `models/bert.py::
bert_encode`.

The attention is the reference's plain one (`_sp_attention`, an f32
einsum), not the flash kernel: the reference's never reaches its Pallas
kernel, so the port's reaches none either. On a mesh that repeats one
device (`core/mesh.py::force_host_devices`) the positions run one after
another.
"""

from __future__ import annotations

import copy
import math

import torch

from ..core.mesh import MeshContext
from ..models.bert import BertConfig
from ..models.layers import dense, dense_group, gelu, layer_norm, tree_devices


def _sp_attention(q, ks, vs, masks) -> torch.Tensor:
    """Attention of local queries q [B, T/sp, H, Dh] over every position's
    keys: `ks`, `vs` [B, T/sp, H, Dh] and `masks` [B, T/sp] a position,
    joined in position order on q's device. Scores f32 over sqrt(Dh), -1e30
    at a padded key, softmax in f32, the probabilities cast to v's dtype,
    then an f32-accumulated PV cast to q's dtype, as the reference's."""
    dev = q.device
    k = torch.cat([t.to(dev) for t in ks], dim=1)
    v = torch.cat([t.to(dev) for t in vs], dim=1)
    mask = torch.cat([m.to(dev) for m in masks], dim=1)
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(q.shape[-1])
    scores = scores.masked_fill(~(mask > 0)[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs.float(), v.float()).to(q.dtype)


def bert_encode_sp(
    params,
    cfg: BertConfig,
    mesh_ctx: MeshContext,
    input_ids: torch.Tensor,  # [B, T], T divisible by the sp size
    attn_mask: torch.Tensor,  # [B, T] {0,1}
    *,
    sp_axis: str = "dp",
) -> torch.Tensor:
    """The BERT encoder with its tokens split over `sp_axis` ("dp": the dp
    positions' first devices, the reference's default; "tp": dp position
    0's tp group) -> [B, T, H] hidden states joined on the first position's
    device. Positions are arange(T) and the token type 0 for every token,
    as in the reference. The weights are whole on each distinct device."""
    devs = mesh_ctx.devices if sp_axis == "dp" else mesh_ctx.group(0)
    sp = len(devs)
    b, t = input_ids.shape
    if t % sp:
        raise ValueError(f"seq len {t} not divisible by sp={sp}")
    tl = t // sp
    home = tree_devices(params)[0]
    copies = {home: params}
    trees = [copies[d] if d in copies else copies.setdefault(d, copy.deepcopy(params).to(d))
             for d in devs]
    dh = cfg.hidden // cfg.heads
    xs, masks = [], []
    for i, (p, d) in enumerate(zip(trees, devs)):
        ids = input_ids[:, i * tl:(i + 1) * tl].to(d).long()
        pos = torch.arange(i * tl, (i + 1) * tl, device=d)
        emb = p.embeddings
        x = emb.word[ids] + emb.position[pos][None] + emb.token_type[torch.zeros_like(ids)]
        xs.append(layer_norm(x, emb.ln_w, emb.ln_b, cfg.eps))
        masks.append(attn_mask[:, i * tl:(i + 1) * tl].to(d))
    for li in range(cfg.layers):
        qkv = []
        for p, x in zip(trees, xs):
            lp = p.layers[li]
            qkv.append([y.reshape(b, tl, cfg.heads, dh) for y in dense_group(
                x, (lp.q_w, lp.k_w, lp.v_w), (lp.q_b, lp.k_b, lp.v_b))])
        ks, vs = [kv[1] for kv in qkv], [kv[2] for kv in qkv]
        for i, (p, x) in enumerate(zip(trees, xs)):
            lp = p.layers[li]
            a = _sp_attention(qkv[i][0], ks, vs, masks).reshape(b, tl, cfg.hidden)
            x = layer_norm(x + dense(a, lp.o_w, lp.o_b), lp.attn_ln_w, lp.attn_ln_b,
                           cfg.eps)
            h = gelu(dense(x, lp.ffn_in_w, lp.ffn_in_b))
            xs[i] = layer_norm(x + dense(h, lp.ffn_out_w, lp.ffn_out_b), lp.ffn_ln_w,
                               lp.ffn_ln_b, cfg.eps)
    return torch.cat([x.to(devs[0]) for x in xs], dim=1)
