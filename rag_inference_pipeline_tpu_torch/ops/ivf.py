"""IVF-Flat: a cluster-bucketed layout and its searches, with the bucket
scans K5 (batch-deduplicated) and K4 (per-query streaming).

Port of `rag_inference_pipeline_tpu/ops/ivf.py` at dp=1. Inverted lists
are a padded dense tensor [nlist, cap, D] with an id map [nlist, cap]
(-1 = padding); a vector that overflows a full list cascades to its
next-nearest centroid with room. The list layout is computed in numpy on
the host exactly as the reference computes it (the overflow order comes
from `np.argsort`), and the buckets are then filled on the device in the
storage dtype, so no [nlist, cap, D] float32 copy exists on the host.

Searches: the coarse probe is a float32 matmul against the centroids
(never TF32: `require_full_f32`) and a stable top-nprobe. Then

- `ivf_search`: the exact plain gather path (ip and l2), as the reference
  runs on the CPU, for the l2 metric and for `exact=True`;
- `ivf_search_dedup`: the batch's probed buckets unioned into slots, every
  query scored against each unique bucket once (K5,
  `ivf_dedup_scores`), membership and padding masked after;
- `ivf_search_scan`: per query, the scores of its probed buckets folded
  into a positional max and the winning probe slot (K4,
  `ivf_scan_partial`), ids resolved after.

On CUDA tensors the K4/K5 wrappers launch `csrc/ivf_scan.cu` /
`csrc/ivf_dedup.cu` (or raise); on CPU tensors they run the plain PyTorch
versions beside them, which are also the kernels' oracles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _kernels
from .kmeans import assign_clusters, kmeans, require_full_f32
from .topk import NEG_INF, _check_words, _on_cpu, _topk

# K5's bf16 grid (csrc/ivf_dedup.cu): bucket positions per block, and the
# most queries a block takes (five n-tiles of 8)
K5_ROWS, K5_MAX_Q = 128, 40


class IVFListing(NamedTuple):
    """Device-resident bucketed IVF layout."""

    centroids: torch.Tensor  # [nlist, D] f32
    buckets: torch.Tensor  # [nlist, cap, D] storage dtype, zero-padded
    ids: torch.Tensor  # [nlist, cap] i32, -1 = padding
    list_sizes: torch.Tensor  # [nlist] i32


def _host_rows(x, rows: np.ndarray) -> np.ndarray:
    """Rows of a numpy array or a tensor (on any device) as host float32."""
    if isinstance(x, torch.Tensor):
        return x[torch.from_numpy(rows).to(x.device)].float().cpu().numpy()
    return np.asarray(x[rows], np.float32)


def layout_inverted_lists(
    x,
    centroids: np.ndarray,
    assignments: np.ndarray,
    *,
    cap_factor: float = 2.5,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side id layout: (ids [nlist, cap] i32, sizes [nlist] i32).

    Rows fill their assigned list in row order; a row that finds its list
    full overflows and cascades, in row order, to the nearest centroid with
    room (the reference's float32 distances and `np.argsort`). `x` ([N, D],
    numpy or tensor) is read only for the overflow rows."""
    a = np.asarray(assignments)
    n = a.shape[0]
    centroids = np.asarray(centroids, np.float32)
    nlist = centroids.shape[0]
    cap = int(np.ceil(cap_factor * n / nlist))
    cap = max(128, ((cap + 127) // 128) * 128)  # lane-aligned, as the reference
    ids = np.full((nlist, cap), -1, np.int32)
    # rank of each row within its list, in row order: the reference's
    # row-by-row fill, vectorized
    order = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=nlist)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - np.repeat(starts, counts)
    keep = rank < cap
    ids[a[keep], rank[keep]] = np.nonzero(keep)[0]
    sizes = np.minimum(counts, cap).astype(np.int32)
    ov = np.nonzero(~keep)[0]
    if ov.size:
        d2 = (
            -2.0 * _host_rows(x, ov) @ centroids.T
            + np.sum(centroids ** 2, axis=1)[None, :]
        )
        order_ov = np.argsort(d2, axis=1)
        for i, row in enumerate(ov):
            for c in order_ov[i]:
                if sizes[c] < cap:
                    ids[c, sizes[c]] = row
                    sizes[c] += 1
                    break
            else:  # pragma: no cover — cap_factor >= 1 makes this impossible
                raise RuntimeError("IVF build: no capacity left anywhere")
    return ids, sizes


def build_ivf_listing(
    x,
    centroids,
    assignments: np.ndarray,
    *,
    cap_factor: float = 2.5,
    storage_dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
    rows_per_block: int = 262144,
) -> IVFListing:
    """List construction from an assignment. `x` is [N, D] (numpy or a
    tensor); the buckets are filled on `device` (default: x's device) in
    `storage_dtype`, a block of rows at a time."""
    dev = torch.device(device) if device is not None else (
        x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    )
    c_host = (
        centroids.float().cpu().numpy() if isinstance(centroids, torch.Tensor)
        else np.asarray(centroids, np.float32)
    )
    ids, sizes = layout_inverted_lists(
        x, c_host, assignments, cap_factor=cap_factor
    )
    nlist, cap = ids.shape
    d = x.shape[1]
    buckets = torch.zeros((nlist, cap, d), dtype=storage_dtype, device=dev)
    flat = buckets.view(nlist * cap, d)
    pos = np.nonzero(ids.reshape(-1) >= 0)[0]
    rows = ids.reshape(-1)[pos]
    xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    for s in range(0, pos.size, rows_per_block):
        r = torch.from_numpy(rows[s : s + rows_per_block]).to(xt.device)
        p = torch.from_numpy(pos[s : s + rows_per_block]).to(dev)
        flat[p] = xt[r].to(dev, torch.float32).to(storage_dtype)
    return IVFListing(
        centroids=torch.from_numpy(c_host).to(dev),
        buckets=buckets,
        ids=torch.from_numpy(ids).to(dev),
        list_sizes=torch.from_numpy(sizes).to(dev),
    )


def build_ivf(
    x,
    nlist: int,
    *,
    train_size: int = 131072,
    iters: int = 15,
    cap_factor: float = 2.5,
    storage_dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> IVFListing:
    """Full IVF build: k-means train + assign on x's device, host layout,
    buckets on x's device. The training sample is the reference's (numpy,
    `seed`); the k-means init and noise come from a torch generator seeded
    with `seed`."""
    xt = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, np.float32)
    )
    n = xt.shape[0]
    sel = np.random.default_rng(seed).choice(
        n, size=min(train_size, n), replace=False
    )
    x_train = xt[torch.from_numpy(sel).to(xt.device)].float()
    g = torch.Generator(device=xt.device).manual_seed(seed)
    centroids, _ = kmeans(x_train, nlist, iters=iters, generator=g)
    del x_train
    assignments = assign_clusters(xt, centroids).cpu().numpy()
    return build_ivf_listing(
        xt, centroids, assignments, cap_factor=cap_factor,
        storage_dtype=storage_dtype, device=xt.device,
    )


def coarse_scores(
    centroids: torch.Tensor, qf: torch.Tensor, metric: str = "ip"
) -> torch.Tensor:
    """Coarse scores [B, nlist] f32 of float32 queries against the
    centroids (full float32, never TF32)."""
    require_full_f32(qf)
    coarse = torch.matmul(qf, centroids.T)
    if metric == "l2":
        coarse = 2.0 * coarse - (centroids * centroids).sum(dim=1)[None, :]
    return coarse


def coarse_probe(
    listing, qf: torch.Tensor, nprobe: int, metric: str = "ip"
) -> torch.Tensor:
    """Coarse scan: the top-nprobe lists per query, [B, nprobe] i32, best
    first, lower list id first on a tie (as `lax.top_k`). `listing` is any
    listing with `centroids` (IVF-Flat or IVF-PQ)."""
    coarse = coarse_scores(listing.centroids, qf, metric)
    return _topk(coarse, nprobe)[1].to(torch.int32)


def ivf_search(
    listing: IVFListing,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    metric: str = "ip",
    query_chunk: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact search within the probed lists (plain gather path). Returns
    (scores [B,k] f32, row ids [B,k] i32). Gathers `query_chunk` queries'
    buckets at a time; the result does not depend on it."""
    nlist, cap, d = listing.buckets.shape
    nprobe = min(nprobe, nlist)
    qf = queries.float()
    probe = coarse_probe(listing, qf, nprobe, metric).long()
    qd = qf.to(listing.buckets.dtype).float()
    k_eff = min(k, nprobe * cap)
    out_s, out_i = [], []
    for s0 in range(0, qf.shape[0], query_chunk):
        pr = probe[s0 : s0 + query_chunk]
        vecs = listing.buckets[pr].float()  # [b, nprobe, cap, D]
        bids = listing.ids[pr]  # [b, nprobe, cap]
        s = torch.einsum("bpcd,bd->bpc", vecs, qd[s0 : s0 + query_chunk])
        if metric == "l2":
            s = 2.0 * s - (vecs * vecs).sum(dim=-1)
        s = torch.where(bids >= 0, s, NEG_INF)
        b = s.shape[0]
        top_s, sel = _topk(s.reshape(b, nprobe * cap), k_eff)
        out_s.append(top_s)
        out_i.append(torch.gather(bids.reshape(b, nprobe * cap), 1, sel))
    return torch.cat(out_s), torch.cat(out_i)


# ---------------------------------------------------------------------------
# K5: batch-deduplicated bucket scores.
# ---------------------------------------------------------------------------


def dedup_probes(
    probe: torch.Tensor, nlist: int, n_slots: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Union the batch's probed lists: probe [B, nprobe] -> (slots
    [n_slots] i32, member [B, n_slots] bool). Probed lists come first in
    ascending id, then unprobed ones in ascending id (the reference's
    `lax.top_k` of a 0/1 mask; a stable sort here, never `torch.topk`)."""
    mask = torch.zeros((nlist,), dtype=torch.float32, device=probe.device)
    mask[probe.reshape(-1).long()] = 1.0
    slots = torch.sort(mask, descending=True, stable=True).indices[:n_slots]
    member = (probe[:, :, None].long() == slots[None, None, :]).any(dim=1)
    return slots.to(torch.int32), member


def ivf_dedup_scores_plain(
    q: torch.Tensor,  # [B, D] in the buckets' dtype
    buckets: torch.Tensor,  # [nlist, cap, D]
    slots: torch.Tensor,  # [n_slots] i32
    sizes: torch.Tensor,  # [nlist] i32
) -> torch.Tensor:
    """Plain PyTorch version of K5: scores[s, b, c] = q[b] . buckets[slots[s],
    c] in float32, 0 at positions at or past the list's size (zero rows in
    the reference's layout). Returns [n_slots, B, cap] f32; the buckets are
    gathered 256 slots at a time."""
    cap = buckets.shape[1]
    qf = q.float()
    pos = torch.arange(cap, device=buckets.device)
    out = []
    for s0 in range(0, slots.shape[0], 256):
        sl = slots[s0 : s0 + 256].long()
        sc = torch.einsum("scd,bd->sbc", buckets[sl].float(), qf)
        filled = pos[None, :] < sizes[sl].long()[:, None]  # [S, cap]
        out.append(torch.where(filled[:, None, :], sc, 0.0))
    return torch.cat(out)


def dedup_query_tiles(b: int) -> tuple[int, int]:
    """K5's split of a bf16 batch of `b` queries into z-tiles: (z_tiles,
    queries per tile), at most K5_MAX_Q a tile and as even as can be. Each
    bucket row is read once per z-tile: once per batch up to K5_MAX_Q."""
    z_tiles = max(1, -(-b // K5_MAX_Q))
    return z_tiles, max(1, -(-b // z_tiles))


def dedup_filled_tiles(slots: torch.Tensor, sizes: torch.Tensor, cap: int) -> int:
    """The (slot, K5_ROWS-position tile) pairs that hold a filled row: the
    blocks of a bf16 K5 launch, per z-tile, that read bucket rows. The
    other blocks of its n_slots x ceil(cap / K5_ROWS) grid write zeros."""
    filled = sizes[slots.long()].long().clamp(0, cap)
    return int(((filled + K5_ROWS - 1) // K5_ROWS).sum())


def _index_args(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("slot, probe and size arrays must be contiguous int32")


def _check_buckets(q: torch.Tensor, buckets: torch.Tensor) -> None:
    if buckets.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"IVF kernels read bf16 or f32 buckets, not {buckets.dtype}")
    if q.dtype != buckets.dtype:
        raise TypeError(f"queries ({q.dtype}) must be in the buckets' dtype")
    _check_words(q, buckets)


def ivf_dedup_scores(
    q: torch.Tensor,
    buckets: torch.Tensor,
    slots: torch.Tensor,
    sizes: torch.Tensor,
) -> torch.Tensor:
    """K5: every query against each unique probed bucket. On CUDA tensors
    this launches csrc/ivf_dedup.cu (or raises): bf16 on the tensor cores,
    K5_ROWS positions by up to K5_MAX_Q queries a block
    (`dedup_query_tiles`); f32 on the CUDA cores. On CPU tensors it runs
    `ivf_dedup_scores_plain`. Returns [n_slots, B, cap] f32."""
    if _on_cpu(q, buckets, "ivf_dedup_scores"):
        return ivf_dedup_scores_plain(q, buckets, slots, sizes)
    _check_buckets(q, buckets)
    _index_args(slots, sizes)
    b, d = q.shape
    cap = buckets.shape[1]
    n_slots = slots.shape[0]
    out = torch.empty((n_slots, b, cap), dtype=torch.float32, device=q.device)
    if b == 0 or n_slots == 0:
        return out
    z_tiles, q_tile = dedup_query_tiles(b)
    _kernels.launch(
        "ragtorch_ivf_dedup", q.get_device(), q.data_ptr(), buckets.data_ptr(),
        slots.data_ptr(), sizes.data_ptr(), out.data_ptr(), b, d, n_slots, cap,
        buckets.element_size(), z_tiles, q_tile,
    )
    ivf_dedup_scores.launches += 1
    return out


ivf_dedup_scores.launches = 0  # kernel launches, for chip_smoke.py


def ivf_search_dedup(
    listing: IVFListing,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    max_slots: int = 0,  # 0 = min(nlist, B * nprobe)
    scan=ivf_dedup_scores,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF search (IP) reading each probed bucket once per batch (K5); exact
    within the probed lists. Returns (scores [B,k] f32, ids [B,k] i32).

    As in the reference, when fewer than k candidates are valid the top-k
    fills up with NEG_INF entries in flat order, which may carry the real
    id of an unprobed slot's row (callers filter on the score or the id)."""
    nlist, cap, _ = listing.buckets.shape
    nprobe = min(nprobe, nlist)
    b = queries.shape[0]
    n_slots = min(max_slots or min(nlist, b * nprobe), nlist)
    qf = queries.float()
    probe = coarse_probe(listing, qf, nprobe)
    slots, member = dedup_probes(probe, nlist, n_slots)
    q = qf.to(listing.buckets.dtype).contiguous()
    scores = scan(q, listing.buckets, slots, listing.list_sizes)
    ids_g = listing.ids[slots.long()]  # [n_slots, cap]
    valid = member[:, :, None] & (ids_g >= 0)[None]
    s_bq = torch.where(valid, scores.permute(1, 0, 2), NEG_INF)
    flat_s = s_bq.reshape(b, n_slots * cap)
    flat_i = ids_g.reshape(1, n_slots * cap).expand(b, -1)
    top_s, sel = _topk(flat_s, min(k, n_slots * cap))
    return top_s, torch.gather(flat_i, 1, sel)


# ---------------------------------------------------------------------------
# K4: per-query streaming bucket scan into a positional max.
# ---------------------------------------------------------------------------


def ivf_scan_partial_plain(
    q: torch.Tensor,  # [B, D] in the buckets' dtype
    buckets: torch.Tensor,  # [nlist, cap, D]
    probe: torch.Tensor,  # [B, nprobe] i32
    sizes: torch.Tensor,  # [nlist] i32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4. For query b and bucket position c:
    vals[b, c] = the best float32 score at position c over b's probed
    lists (positions at or past a list's size count as NEG_INF), win[b, c]
    = the earliest probe slot reaching it, -1 when none is filled.
    Returns (vals [B, cap] f32, win [B, cap] i32)."""
    cap = buckets.shape[1]
    pos = torch.arange(cap, device=buckets.device)
    vals, win = [], []
    for b in range(q.shape[0]):
        pr = probe[b].long()
        s = torch.matmul(buckets[pr].float(), q[b].float())  # [nprobe, cap]
        s = torch.where(pos[None, :] < sizes[pr].long()[:, None], s, NEG_INF)
        m = s.amax(dim=0)
        first = torch.argmax((s == m[None, :]).to(torch.uint8), dim=0)
        vals.append(m)
        win.append(torch.where(m > NEG_INF, first, -1))
    if not vals:
        empty = torch.empty((0, cap), device=buckets.device)
        return empty, empty.to(torch.int32)
    return torch.stack(vals), torch.stack(win).to(torch.int32)


def ivf_scan_partial(
    q: torch.Tensor,
    buckets: torch.Tensor,
    probe: torch.Tensor,
    sizes: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: per query, its probed buckets folded into a positional max. On
    CUDA tensors this launches csrc/ivf_scan.cu (or raises); on CPU tensors
    it runs `ivf_scan_partial_plain`. Returns (vals [B, cap] f32, win
    [B, cap] i32)."""
    if _on_cpu(q, buckets, "ivf_scan_partial"):
        return ivf_scan_partial_plain(q, buckets, probe, sizes)
    _check_buckets(q, buckets)
    _index_args(probe, sizes)
    b, d = q.shape
    cap = buckets.shape[1]
    nprobe = probe.shape[1]
    vals = torch.empty((b, cap), dtype=torch.float32, device=q.device)
    win = torch.empty((b, cap), dtype=torch.int32, device=q.device)
    if b == 0:
        return vals, win
    _kernels.launch(
        "ragtorch_ivf_scan", q.get_device(), q.data_ptr(), buckets.data_ptr(),
        probe.data_ptr(), sizes.data_ptr(), vals.data_ptr(), win.data_ptr(),
        b, d, nprobe, cap, buckets.element_size(),
    )
    ivf_scan_partial.launches += 1
    return vals, win


ivf_scan_partial.launches = 0  # kernel launches, for chip_smoke.py


def ivf_search_scan(
    listing: IVFListing,
    queries: torch.Tensor,
    k: int,
    *,
    nprobe: int = 64,
    scan=ivf_scan_partial,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF search (IP) with the streaming bucket scan (K4), the port of
    the reference's `ivf_search_pallas`: at most one candidate per bucket
    position across a query's probed lists. Returns (scores [B,k] f32,
    ids [B,k] i32), id -1 where no list filled the position."""
    nlist, cap, _ = listing.buckets.shape
    nprobe = min(nprobe, nlist)
    b = queries.shape[0]
    qf = queries.float()
    probe = coarse_probe(listing, qf, nprobe)
    q = qf.to(listing.buckets.dtype).contiguous()
    vals, win = scan(q, listing.buckets, probe.contiguous(), listing.list_sizes)
    clusters = torch.gather(probe.long(), 1, win.long().clamp(min=0))
    pos = torch.arange(cap, device=vals.device).expand(b, cap)
    out_ids = torch.where(win >= 0, listing.ids[clusters, pos], -1)
    top_s, sel = _topk(vals, min(k, cap))
    return top_s, torch.gather(out_ids, 1, sel)
