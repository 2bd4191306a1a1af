"""Product quantization: codebook training, encoding, ADC scans, IVF-PQ and
its re-score tiers, with the PQ4 ADC kernel K6.

Port of `rag_inference_pipeline_tpu/ops/pq.py`:

- codebooks are 2^bits-way k-means per subspace, all M subspaces trained at
  once as a batch (`ops/kmeans.py`); encoding is the nearest codeword by
  float32 matmuls (never TF32: `require_full_f32`), the lower code on a tie;
- IVF-PQ encodes residuals against the coarse centroids, so an IP score is
  q.centroid + ADC(q, residual codes) with per-query lookup tables (LUTs);
- `ivfpq_search` (PQ8, 256 codes per subspace) gathers LUT entries per
  query and merges a running top-k over chunks of 8 probes, plain torch as
  the reference leaves it to XLA;
- `ivfpq4_search_dedup` (PQ4, 16 codes) unions the batch's probed buckets
  into slots and scores every query against each unique bucket once (K6,
  `ivfpq4_adc_scores`, from bf16 LUTs); the coarse term, the member mask
  and the flat top-k follow in plain torch;
- OPQ (an orthogonal rotation learned by Procrustes), the flat scans
  `pq_topk` / `pq4_topk`, and the two HBM re-score tiers (flat residual-PQ8
  codes, int4 per-row-scaled residuals).

On CUDA tensors the K6 wrapper launches `csrc/ivfpq4_adc.cu` (or raises);
on CPU tensors it runs `ivfpq4_adc_scores_plain` beside it, which is also
the kernel's oracle. Randomness comes from a `torch.Generator`, so trained
codebooks match the reference in kind, not bit for bit; encoding, LUTs,
the layout and every search match it on the same codebooks;
- the dp-sharded search (`shard_ivfpq_listing`, `sharded_ivfpq_search`)
  over a `core/mesh.py` mesh: global probe selection through the
  `coarse_floor` of both searches, K6 once a shard.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from .ivf import (
    _index_args,
    coarse_scores,
    dedup_kept_probes,
    dedup_probes,
    layout_inverted_lists,
)
from .kmeans import assign_clusters, kmeans, require_full_f32
from .topk import NEG_INF, _on_cpu, _round_up, _topk

# probed lists per step of the PQ8 gather search, as the reference chunks it
_PROBE_CHUNK = 8
# rows per encode step of the re-score tiers
_ENCODE_ROWS = 1_048_576


def _as_tensor(x, device: Optional[torch.device] = None) -> torch.Tensor:
    """A numpy array or a tensor as a tensor (on `device` when given)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t if device is None else t.to(device)


def _split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(0, 1)  # [M, N, ds]


def train_pq(
    x: torch.Tensor,
    m: int,
    *,
    iters: int = 12,
    ksub: int = 256,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-subspace codebooks [M, ksub, ds] f32: one k-means per subspace,
    the M of them as one batch. ksub=256 is PQ8, ksub=16 PQ4."""
    xs = _split_subspaces(x.float(), m).contiguous()
    codebooks, _ = kmeans(xs, ksub, iters=iters, chunk=16384, generator=generator)
    return codebooks


def pq_encode(
    x: torch.Tensor, codebooks: torch.Tensor, *, chunk: int = 16384
) -> torch.Tensor:
    """Rows to PQ codes [N, M] uint8: per subspace the codeword maximizing
    2 x.c - |c|^2, the lower code on a tie. The result does not depend on
    `chunk` (rows per step; the reference's 65536 would make a 6.4 GB score
    tensor at PQ8)."""
    require_full_f32(x)
    n = x.shape[0]
    m, _, ds = codebooks.shape
    cb = codebooks.float()
    cb_t = cb.transpose(1, 2)
    cb_sq = (cb * cb).sum(dim=-1)[:, None, :]  # [M, 1, ksub]
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for s in range(0, n, chunk):
        xs = x[s : s + chunk].float().reshape(-1, m, ds).transpose(0, 1)
        sc = 2.0 * torch.matmul(xs, cb_t) - cb_sq  # [M, rows, ksub]
        out[s : s + chunk] = torch.argmax(sc, dim=-1).T.to(torch.uint8)
    return out


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Reconstruct vectors from codes: [N, M] -> [N, D] f32."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(n, -1).float()


def pq_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query IP lookup tables, flattened: [B, M*ksub] f32 with
    lut[b, m*ksub + c] = q_b[subspace m] . codebook[m, c]."""
    require_full_f32(queries)
    b = queries.shape[0]
    m, ksub, ds = codebooks.shape
    qs = queries.float().reshape(b, m, ds).transpose(0, 1)  # [M, B, ds]
    lut = torch.matmul(qs, codebooks.float().transpose(1, 2))  # [M, B, ksub]
    return lut.transpose(0, 1).reshape(b, m * ksub)


def adc_lookup_sum(
    lut_flat: torch.Tensor, codes: torch.Tensor, ksub: int = 256
) -> torch.Tensor:
    """ADC: the sum of the LUT entries the codes select. lut_flat
    [B, M*ksub]; codes [..., M] uint8 -> scores [B, ...] f32."""
    m = codes.shape[-1]
    lead = codes.shape[:-1]
    base = torch.arange(m, device=codes.device) * ksub
    idx = (codes.long().reshape(-1, m) + base).reshape(-1)
    g = lut_flat[:, idx]  # [B, F*M]
    return g.reshape(lut_flat.shape[0], *lead, m).sum(dim=-1)


def pq_topk(
    queries: torch.Tensor,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    k: int,
    *,
    chunk: int = 32768,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat PQ search (IP): a chunked ADC scan with a running top-k merge.
    Returns (scores [B,k] f32, ids [B,k] i32); the lower row on a tie."""
    n, _ = codes.shape
    b = queries.shape[0]
    k = min(k, n)
    chunk = min(chunk, n)
    ksub = codebooks.shape[1]
    lut = pq_lut(queries, codebooks)
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=codes.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=codes.device)
    for start in range(0, n, chunk):
        cc = codes[start : start + chunk]
        s = adc_lookup_sum(lut, cc, ksub)  # [B, rows]
        cs, ci = _topk(s, min(k, s.shape[1]))
        gids = torch.arange(start, start + cc.shape[0], device=codes.device,
                            dtype=torch.int32)
        cand_s = torch.cat([best_s, cs], dim=1)
        cand_i = torch.cat([best_i, gids[ci]], dim=1)
        best_s, sel = _topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, sel)
    return best_s, best_i


# The reference's PQ4 flat scan is a one-hot matmul, which feeds the TPU's
# matrix unit; on the card the gather scan above does the same sum (the
# reference's CPU path sums in float32, as here).
pq4_topk = pq_topk


# ---------------------------------------------------------------------------
# OPQ: an orthogonal rotation R that lowers the PQ reconstruction error,
# alternating PQ training with a Procrustes update (Ge et al.).
# ---------------------------------------------------------------------------


def train_opq(
    x: torch.Tensor,
    m: int,
    *,
    iters: int = 5,
    pq_iters: int = 8,
    ksub: int = 256,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (R [D, D] orthogonal, codebooks [M, ksub, D/M]); queries and
    rows rotate by R, which keeps inner products."""
    require_full_f32(x)
    n, d = x.shape
    xf = x.float()
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    codebooks = None
    for _ in range(iters):
        z = xf @ r
        codebooks = train_pq(z, m, iters=pq_iters, ksub=ksub, generator=generator)
        recon = pq_decode(pq_encode(z, codebooks, chunk=min(65536, n)), codebooks)
        # Procrustes: argmin ||xR - recon||_F over orthogonal R = U V^T of
        # the SVD of x^T recon
        u, _, vt = torch.linalg.svd(xf.T @ recon, full_matrices=False)
        r = u @ vt
    return r, codebooks


# ---------------------------------------------------------------------------
# IVF-PQ: coarse quantizer + residual PQ codes in the bucketed IVF layout.
# ---------------------------------------------------------------------------


class IVFPQListing(NamedTuple):
    """Device-resident IVF-PQ layout."""

    centroids: torch.Tensor  # [nlist, D] f32
    codebooks: torch.Tensor  # [M, ksub, ds] f32 (residual space)
    code_buckets: torch.Tensor  # [nlist, cap, m_store] uint8
    ids: torch.Tensor  # [nlist, cap] i32, -1 = padding
    list_sizes: torch.Tensor  # [nlist] i32


def build_ivfpq_listing(
    x,
    centroids: torch.Tensor,
    codebooks: torch.Tensor,
    assignments: np.ndarray,
    *,
    cap_factor: float = 2.5,
    rows_per_block: int = 262144,
) -> IVFPQListing:
    """The listing of trained centroids and codebooks, on their device: the
    reference's host id layout (`layout_inverted_lists`), then the residual
    codes of each filled position, encoded a block of rows at a time
    straight into the uint8 code buckets. For PQ4 the buckets are
    lane-padded to m_store = max(128, m rounded up to 128) code columns
    (zeros), the reference's `.npz` layout."""
    dev = centroids.device
    cent = centroids.float()
    ids, sizes = layout_inverted_lists(
        x, cent.cpu().numpy(), assignments, cap_factor=cap_factor
    )
    nlist, cap = ids.shape
    m, ksub, _ = codebooks.shape
    m_store = max(128, _round_up(m, 128)) if ksub == 16 else m
    code_buckets = torch.zeros((nlist, cap, m_store), dtype=torch.uint8, device=dev)
    flat = code_buckets.view(nlist * cap, m_store)
    pos = np.nonzero(ids.reshape(-1) >= 0)[0]
    rows = ids.reshape(-1)[pos]
    a = np.asarray(assignments)
    xt = _as_tensor(x)
    for s in range(0, pos.size, rows_per_block):
        r = torch.from_numpy(rows[s : s + rows_per_block])
        xr = xt[r.to(xt.device)].to(dev, torch.float32)
        res = xr - cent[torch.from_numpy(a[rows[s : s + rows_per_block]]).to(dev).long()]
        p = torch.from_numpy(pos[s : s + rows_per_block]).to(dev)
        flat[p, :m] = pq_encode(res, codebooks)
    return IVFPQListing(
        centroids=cent,
        codebooks=codebooks.float(),
        code_buckets=code_buckets,
        ids=torch.from_numpy(ids).to(dev),
        list_sizes=torch.from_numpy(sizes).to(dev),
    )


def build_ivfpq(
    x,
    nlist: int,
    m: int,
    *,
    train_size: int = 131072,
    kmeans_iters: int = 15,
    pq_iters: int = 12,
    cap_factor: float = 2.5,
    seed: int = 0,
    ksub: int = 256,
) -> IVFPQListing:
    """IVF-PQ build on x's device: coarse k-means, residual PQ training on
    the reference's numpy sample (`seed`), the listing. The k-means and
    codebook inits come from one torch generator seeded with `seed`."""
    xt = _as_tensor(x)
    n = xt.shape[0]
    sel = np.random.default_rng(seed).choice(n, size=min(train_size, n), replace=False)
    sel_t = torch.from_numpy(sel).to(xt.device)
    x_train = xt[sel_t].float()
    g = torch.Generator(device=xt.device).manual_seed(seed)
    centroids, _ = kmeans(x_train, nlist, iters=kmeans_iters, generator=g)
    assignments = assign_clusters(xt, centroids)
    res_train = x_train - centroids[assignments[sel_t].long()]
    del x_train
    codebooks = train_pq(res_train, m, iters=pq_iters, ksub=ksub, generator=g)
    del res_train
    return build_ivfpq_listing(
        xt, centroids, codebooks, assignments.cpu().numpy(), cap_factor=cap_factor
    )


def ivfpq_search(
    listing: IVFPQListing,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    coarse_floor: Optional[torch.Tensor] = None,  # [B, 1] least coarse score
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search (IP, residual codes), the gather-ADC path for any
    ksub: score = q.centroid + ADC(q, codes), probed lists scored
    `_PROBE_CHUNK` at a time with a running top-k merge. The probe set is
    padded to a multiple of `_PROBE_CHUNK` with repeats of the last probe at
    a NEG_INF coarse term, as the reference pads it. `coarse_floor` gives
    probed lists under a caller's threshold a NEG_INF coarse term, as the
    reference does (the sharded search passes the global nprobe-th coarse
    score). Returns (scores [B,k] f32, ids [B,k] i32)."""
    nlist, cap, _ = listing.code_buckets.shape
    m, ksub, _ = listing.codebooks.shape  # m_store may be lane-padded (PQ4)
    nprobe = min(nprobe, nlist)
    b = queries.shape[0]
    qf = queries.float()
    coarse_s, probe = _topk(coarse_scores(listing.centroids, qf), nprobe)
    if coarse_floor is not None:
        coarse_s = torch.where(coarse_s >= coarse_floor, coarse_s, NEG_INF)
    pad = (-nprobe) % _PROBE_CHUNK
    if pad:
        probe = torch.cat([probe, probe[:, -1:].expand(b, pad)], dim=1)
        coarse_s = torch.cat([
            coarse_s,
            torch.full((b, pad), NEG_INF, dtype=torch.float32, device=qf.device),
        ], dim=1)
        nprobe += pad
    lut = pq_lut(qf, listing.codebooks)  # [B, M*ksub]
    base = torch.arange(m, device=qf.device) * ksub
    k_eff = min(k, nprobe * cap)
    dev = qf.device
    best_s = torch.full((b, k_eff), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k_eff), -1, dtype=torch.int32, device=dev)
    for p0 in range(0, nprobe, _PROBE_CHUNK):
        pr = probe[:, p0 : p0 + _PROBE_CHUNK]
        cs = coarse_s[:, p0 : p0 + _PROBE_CHUNK]
        codes_g = listing.code_buckets[pr][..., :m]  # [B, pc, cap, M]
        ids_g = listing.ids[pr]  # [B, pc, cap]
        idx = (codes_g.long() + base).reshape(b, -1)
        s = torch.gather(lut, 1, idx).reshape(codes_g.shape).sum(dim=-1)
        s = torch.where(ids_g >= 0, s + cs[:, :, None], NEG_INF)
        flat_s = s.reshape(b, -1)
        csn, sel = _topk(flat_s, min(k_eff, flat_s.shape[1]))
        cand_s = torch.cat([best_s, csn], dim=1)
        cand_i = torch.cat([best_i, torch.gather(ids_g.reshape(b, -1), 1, sel)], dim=1)
        best_s, msel = _topk(cand_s, k_eff)
        best_i = torch.gather(cand_i, 1, msel)
    return best_s, best_i


# ---------------------------------------------------------------------------
# K6: PQ4 ADC over the batch's unique probed buckets.
# ---------------------------------------------------------------------------


def ivfpq4_adc_scores_plain(
    lut: torch.Tensor,  # [b_pad, m*16] bf16
    code_buckets: torch.Tensor,  # [nlist, cap, m_store] uint8, codes < 16
    slots: torch.Tensor,  # [n_slots] i32
    sizes: torch.Tensor,  # [nlist] i32
) -> torch.Tensor:
    """Plain PyTorch version of K6: scores[s, b, r] = the sum over the m
    subspaces of lut[b, j*16 + codes[slots[s], r, j]] in float32, as sums
    of groups of 8 subspaces, and 0 at positions at or past the list's size
    (the TPU kernel scores the zero codes there; callers mask both by id).
    Returns [n_slots, b_pad, cap] f32; the buckets are gathered 16 slots at
    a time (the gathered table entries are m times a chunk's scores)."""
    slot_chunk = 16
    b_pad, width = lut.shape
    m = width // 16
    cap = code_buckets.shape[1]
    dev = code_buckets.device
    lf = lut.float()
    base = torch.arange(m, device=dev) * 16
    pos = torch.arange(cap, device=dev)
    out = []
    for s0 in range(0, slots.shape[0], slot_chunk):
        sl = slots[s0 : s0 + slot_chunk].long()
        idx = (code_buckets[sl, :, :m].long() & 15) + base  # [S, cap, m]
        g = lf[:, idx]  # [b_pad, S, cap, m]
        sc = g.reshape(*g.shape[:-1], m // 8, 8).sum(dim=-1).sum(dim=-1)
        filled = pos[None, :] < sizes[sl].long()[:, None]  # [S, cap]
        out.append(torch.where(filled[None], sc, 0.0).transpose(0, 1))
    if not out:
        return torch.empty((0, b_pad, cap), dtype=torch.float32, device=dev)
    return torch.cat(out)


def ivfpq4_adc_scores(
    lut: torch.Tensor,
    code_buckets: torch.Tensor,
    slots: torch.Tensor,
    sizes: torch.Tensor,
) -> torch.Tensor:
    """K6: every query's PQ4 ADC score against each unique probed bucket.
    On CUDA tensors this launches csrc/ivfpq4_adc.cu (or raises): the
    reference's one-hot matmul on the tensor cores, 128 positions by up to
    64 queries a block; on CPU tensors it runs `ivfpq4_adc_scores_plain`.
    Returns [n_slots, b_pad, cap] f32."""
    if _on_cpu(lut, code_buckets, "ivfpq4_adc_scores"):
        return ivfpq4_adc_scores_plain(lut, code_buckets, slots, sizes)
    b_pad, width = lut.shape
    nlist, cap, m_store = code_buckets.shape
    m = width // 16
    if lut.dtype != torch.bfloat16 or code_buckets.dtype != torch.uint8:
        raise TypeError("K6 takes a bf16 LUT and uint8 code buckets")
    if b_pad % 8 or width % 128:
        raise ValueError(
            f"K6 needs the LUT padded to a multiple of 8 queries and m % 8 == 0 "
            f"(got {b_pad} x {width})"
        )
    if m_store % 16 or m_store < _round_up(m, 16):
        raise ValueError(
            f"K6 reads code rows in 16-byte chunks: m_store {m_store} must be a "
            f"multiple of 16 and at least {_round_up(m, 16)}"
        )
    for t in (lut, code_buckets):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K6 inputs must be contiguous and 16-byte aligned")
    _index_args(slots, sizes)
    n_slots = slots.shape[0]
    out = torch.empty((n_slots, b_pad, cap), dtype=torch.float32, device=lut.device)
    if n_slots == 0 or b_pad == 0:
        return out
    _kernels.launch(
        "ragtorch_ivfpq4_adc", lut.get_device(), lut.data_ptr(),
        code_buckets.data_ptr(), slots.data_ptr(), sizes.data_ptr(),
        out.data_ptr(), b_pad, m, n_slots, cap, m_store,
    )
    ivfpq4_adc_scores.launches += 1
    return out


ivfpq4_adc_scores.launches = 0  # kernel launches, for chip_smoke.py


def ivfpq4_search_dedup(
    listing: IVFPQListing,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    scan=ivfpq4_adc_scores,
    coarse_floor: Optional[torch.Tensor] = None,  # [B, 1] least coarse score
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ4 search (IP, residual codes) scoring each probed bucket once
    per batch (K6). Needs a PQ4 (ksub=16) listing with m % 8 == 0. Returns
    (scores [B,k] f32, ids [B,k] i32): coarse + ADC approximations.

    The LUT is rounded to bf16 once (round to nearest even) and padded to
    b_pad, a multiple of 8 queries, as the reference feeds its kernel. As
    there, when fewer than k candidates are valid the flat top-k fills up
    with NEG_INF entries in flat order, which may carry the real id of an
    unprobed slot's row.

    `coarse_floor` drops a query's probed lists whose coarse score is under
    its floor (the sharded search's global threshold). It masks membership
    before the dedup, so a list no query keeps takes no slot and K6 scans
    only the kept lists (one host read of their count); the reference
    masks after its kernel. The valid candidates, their scores and their
    order are the same; where fewer than k are valid, the fill is NEG_INF
    and -1 up to the reference's width."""
    nlist, cap, _ = listing.code_buckets.shape
    m, ksub, _ = listing.codebooks.shape
    if ksub != 16:
        raise ValueError("ivfpq4_search_dedup requires a PQ4 (ksub=16) listing")
    if m % 8:
        raise ValueError("the PQ4 ADC kernel needs m % 8 == 0")
    nprobe = min(nprobe, nlist)
    b = queries.shape[0]
    b_pad = _round_up(max(b, 8), 8)
    n_slots = min(nlist, b * nprobe)
    width = min(k, n_slots * cap)
    qf = queries.float()
    coarse = coarse_scores(listing.centroids, qf)
    coarse_s, probe = _topk(coarse, nprobe)
    probe = probe.to(torch.int32)
    if coarse_floor is None:
        slots, member = dedup_probes(probe, nlist, n_slots)
    else:
        slots, member = dedup_kept_probes(probe, coarse_s >= coarse_floor, nlist)
        n_slots = slots.shape[0]
        if n_slots == 0:
            return (
                torch.full((b, width), NEG_INF, dtype=torch.float32, device=qf.device),
                torch.full((b, width), -1, dtype=torch.int32, device=qf.device),
            )
    lut = pq_lut(qf, listing.codebooks)
    lut = torch.nn.functional.pad(lut, (0, 0, 0, b_pad - b)).to(torch.bfloat16)
    scores = scan(lut.contiguous(), listing.code_buckets, slots, listing.list_sizes)
    sl = slots.long()
    ids_g = listing.ids[sl]  # [n_slots, cap]
    # the residual identity: score = q.centroid_probe + q.residual
    s_bq = scores[:, :b].permute(1, 0, 2) + coarse[:, sl][:, :, None]
    del scores
    s_bq.masked_fill_(~member[:, :, None] | (ids_g < 0)[None], NEG_INF)
    flat_s = s_bq.reshape(b, n_slots * cap)
    flat_i = ids_g.reshape(1, n_slots * cap).expand(b, -1)
    top_s, sel = _topk(flat_s, min(k, n_slots * cap))
    top_i = torch.gather(flat_i, 1, sel)
    if top_s.shape[1] < width:  # fewer kept slots than the reference's
        fill = width - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, fill), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, fill), value=-1)
    return top_s, top_i


# ---------------------------------------------------------------------------
# dp-sharded IVF-PQ: the code buckets split over the mesh's dp positions.
# ---------------------------------------------------------------------------


def shard_ivfpq_listing(ctx, listing: IVFPQListing) -> list[IVFPQListing]:
    """The listing with its lists split over dp (centroids, code buckets,
    ids, sizes) and the codebooks once per distinct device (reference
    `ops/pq.py:587`). Needs nlist % dp == 0."""
    nlist = listing.code_buckets.shape[0]
    if nlist % ctx.dp != 0:
        raise ValueError(f"nlist ({nlist}) must be divisible by mesh dp ({ctx.dp})")
    rows = ctx.rows_dp
    cents, buckets, ids, sizes = (
        ctx.put(f, rows) for f in (
            listing.centroids, listing.code_buckets, listing.ids, listing.list_sizes,
        )
    )
    books = ctx.put(listing.codebooks)
    return [
        IVFPQListing(centroids=c, codebooks=cb, code_buckets=bk, ids=i, list_sizes=sz)
        for c, cb, bk, i, sz in zip(cents, books, buckets, ids, sizes)
    ]


def sharded_ivfpq_search(
    ctx,
    shards: list[IVFPQListing],
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    nprobe_local: int = 0,
    scan=ivfpq4_adc_scores,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search over dp-sharded lists (reference `ops/pq.py:611`).

    Probe selection is global, as in `ops/ivf.py::sharded_ivf_search`: the
    nprobe-th best coarse score over all lists is every position's
    `coarse_floor`, and a position's ADC (K6 through `ivfpq4_search_dedup`
    for PQ4, once a shard; the gather ADC for PQ8) scans its top
    `nprobe_local` lists that clear it. Per-shard top-k lists are padded
    with -inf and -1 below k and merged as in `ops/topk.py::sharded_topk`.
    Stored ids are global; re-scoring the merged shortlist is the index's
    job."""
    from .ivf import default_nprobe_local, global_coarse_floor
    from .topk import _merge_shards

    if len(shards) != ctx.dp:
        raise ValueError(f"{len(shards)} shards for a mesh of dp={ctx.dp}")
    nlist_l = shards[0].code_buckets.shape[0]
    nprobe_local = default_nprobe_local(nprobe, nlist_l * ctx.dp, ctx.dp, nprobe_local)
    ksub = shards[0].codebooks.shape[1]
    qf = queries.float()
    qs = [qf.to(dev) for dev in ctx.devices]
    coarse_l = [coarse_scores(loc.centroids, q) for loc, q in zip(shards, qs)]
    floor = global_coarse_floor(ctx, coarse_l, nprobe)
    parts = []
    for dev, loc, q in zip(ctx.devices, shards, qs):
        fl = floor.to(dev)
        if ksub == 16:
            s, i = ivfpq4_search_dedup(
                loc, q, k, nprobe=nprobe_local, scan=scan, coarse_floor=fl
            )
        else:
            s, i = ivfpq_search(loc, q, k, nprobe=nprobe_local, coarse_floor=fl)
        if s.shape[1] < k:
            s = torch.nn.functional.pad(s, (0, k - s.shape[1]), value=-float("inf"))
            i = torch.nn.functional.pad(i, (0, k - i.shape[1]), value=-1)
        parts.append((torch.where(i >= 0, s, -float("inf")), i))
    return _merge_shards(ctx, parts, k)


# ---------------------------------------------------------------------------
# Re-score tiers in device memory: flat residual-PQ8 codes and int4
# per-row-scaled residuals, addressed by row id, sharing the listing's
# coarse centroids.
# ---------------------------------------------------------------------------


class PQFlatTier(NamedTuple):
    """Residual-PQ codes by row id: score(q, id) = q.centroid[assign[id]] +
    ADC(q, codes[id])."""

    centroids: torch.Tensor  # [nlist, D] f32
    codebooks: torch.Tensor  # [M, ksub, ds] f32, residual space
    codes: torch.Tensor  # [N, M] uint8
    assign: torch.Tensor  # [N] i32 coarse list of each row


def build_pq_tier(
    x,
    centroids: torch.Tensor,
    m: int,
    *,
    train_size: int = 131072,
    pq_iters: int = 12,
    seed: int = 0,
    ksub: int = 256,
    generator: Optional[torch.Generator] = None,
) -> PQFlatTier:
    """Train and encode a flat residual-PQ tier against existing centroids,
    on their device, `_ENCODE_ROWS` rows at a time."""
    cent = centroids.float()
    xt = _as_tensor(x)
    n = xt.shape[0]
    sel = np.random.default_rng(seed).choice(n, size=min(train_size, n), replace=False)
    xs = xt[torch.from_numpy(sel).to(xt.device)].to(cent.device, torch.float32)
    res_train = xs - cent[assign_clusters(xs, cent).long()]
    codebooks = train_pq(res_train, m, iters=pq_iters, ksub=ksub, generator=generator)
    codes = torch.empty((n, m), dtype=torch.uint8, device=cent.device)
    assign = torch.empty((n,), dtype=torch.int32, device=cent.device)
    for lo in range(0, n, _ENCODE_ROWS):
        xc = xt[lo : lo + _ENCODE_ROWS].to(cent.device, torch.float32)
        a = assign_clusters(xc, cent)
        codes[lo : lo + _ENCODE_ROWS] = pq_encode(xc - cent[a.long()], codebooks)
        assign[lo : lo + _ENCODE_ROWS] = a
    return PQFlatTier(centroids=cent, codebooks=codebooks, codes=codes, assign=assign)


def pq_rescore_flat(
    queries: torch.Tensor, ids: torch.Tensor, tier: PQFlatTier
) -> torch.Tensor:
    """Shortlist ids [B, S] (-1 = invalid) re-scored against the tier:
    [B, S] f32, NEG_INF at invalid slots."""
    qf = queries.float()
    b, s = ids.shape
    m, ksub, _ = tier.codebooks.shape
    safe = ids.clamp(min=0).long()
    codes_g = tier.codes[safe]  # [B, S, M]
    coarse = coarse_scores(tier.centroids, qf)
    coarse_term = torch.gather(coarse, 1, tier.assign[safe].long())
    lut = pq_lut(qf, tier.codebooks)
    idx = (codes_g.long() + torch.arange(m, device=qf.device) * ksub).reshape(b, -1)
    adc = torch.gather(lut, 1, idx).reshape(b, s, m).sum(dim=-1)
    return torch.where(ids >= 0, coarse_term + adc, NEG_INF)


def pq_tier_rescore_topk(
    queries: torch.Tensor,
    adc_scores: torch.Tensor,
    ids: torch.Tensor,
    tier: PQFlatTier,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shortlist (from any ADC search) -> tier-rescored top-k; the ADC
    scores are replaced by the finer reconstruction."""
    del adc_scores
    scores = pq_rescore_flat(queries, ids, tier)
    top_s, sel = _topk(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(ids, 1, sel)


class Int4ResidualTier(NamedTuple):
    """int4 residuals by row id, with a per-row f16 scale, two codes per
    byte (even dim in the low nibble)."""

    centroids: torch.Tensor  # [nlist, D] f32
    codes: torch.Tensor  # [N, D//2] uint8
    row_scale: torch.Tensor  # [N] f16
    assign: torch.Tensor  # [N] i32


def build_int4_tier(x, centroids: torch.Tensor) -> Int4ResidualTier:
    """Encode x as int4 residuals against the centroids, on their device:
    scale = max(|r|_max / 7, 1e-8) per row, codes round(r / scale) clipped
    to [-8, 7] and stored +8."""
    cent = centroids.float()
    xt = _as_tensor(x)
    n, d = xt.shape
    if d % 2:
        raise ValueError(f"int4 tier requires even dim, got {d}")
    codes = torch.empty((n, d // 2), dtype=torch.uint8, device=cent.device)
    assign = torch.empty((n,), dtype=torch.int32, device=cent.device)
    scales = torch.empty((n,), dtype=torch.float16, device=cent.device)
    for lo in range(0, n, _ENCODE_ROWS):
        xc = xt[lo : lo + _ENCODE_ROWS].to(cent.device, torch.float32)
        a = assign_clusters(xc, cent)
        r = xc - cent[a.long()]
        scale = torch.clamp(r.abs().amax(dim=1) / 7.0, min=1e-8)
        q = torch.clamp(torch.round(r / scale[:, None]), -8, 7).to(torch.int32)
        u = (q + 8).to(torch.uint8)
        codes[lo : lo + _ENCODE_ROWS] = u[:, 0::2] | (u[:, 1::2] << 4)
        assign[lo : lo + _ENCODE_ROWS] = a
        scales[lo : lo + _ENCODE_ROWS] = scale.to(torch.float16)
    return Int4ResidualTier(centroids=cent, codes=codes, row_scale=scales, assign=assign)


def int4_rescore_flat(
    queries: torch.Tensor, ids: torch.Tensor, tier: Int4ResidualTier
) -> torch.Tensor:
    """Shortlist ids [B, S] re-scored against the int4 tier: q.centroid
    (exact f32) + (bf16 q) . (int4 residual) * row scale; NEG_INF at
    invalid slots."""
    qf = queries.float()
    b, s = ids.shape
    safe = ids.clamp(min=0).long()
    codes_g = tier.codes[safe]  # [B, S, D/2]
    coarse_term = torch.gather(
        coarse_scores(tier.centroids, qf), 1, tier.assign[safe].long()
    )
    low = (codes_g & 0x0F).to(torch.int32) - 8
    high = (codes_g >> 4).to(torch.int32) - 8
    r_q = torch.stack([low, high], dim=-1).reshape(b, s, -1).float()
    # |code| <= 8 times a bf16 query value is exact in f32
    qb = queries.to(torch.bfloat16).float()
    resid = torch.einsum("bsd,bd->bs", r_q, qb) * tier.row_scale[safe].float()
    return torch.where(ids >= 0, coarse_term + resid, NEG_INF)


def int4_tier_rescore_topk(
    queries: torch.Tensor,
    adc_scores: torch.Tensor,
    ids: torch.Tensor,
    tier: Int4ResidualTier,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shortlist (from any ADC search) -> int4-tier-rescored top-k."""
    del adc_scores
    scores = int4_rescore_flat(queries, ids, tier)
    top_s, sel = _topk(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(ids, 1, sel)
