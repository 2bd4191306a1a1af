"""Flat similarity scan + top-k: exact scan, the bf16/f32 bin-max scan
(kernel K2) with its fused search, the global-scale int8 bin-max scan
(kernel K1) and the fused int8 search with exact bf16 re-score, and the
per-row-scale int8 scan (kernel K3) with its fused search.

Port of `rag_inference_pipeline_tpu/ops/topk.py`. A bin-max scan keeps,
per query, a running (max, earliest row) in each of `nbins` bins (bin =
row % nbins); an exact top-k over the survivors gives the result. On CUDA
tensors `binmax_partial_topk`, `binmax_partial_topk_int8gs` and
`binmax_partial_topk_int8` launch the hand-written Hopper kernels in
`csrc/binmax_bf16.cu`, `csrc/binmax_int8gs.cu` and `csrc/binmax_int8.cu`;
on CPU tensors they run the plain PyTorch versions beside them, which are
also the kernels' oracles.

The sharded searches (`sharded_topk`, `sharded_topk_int8gs`) split the
rows over the dp positions of a `core/mesh.py` mesh: a local scan a
position (K2 or K1 once a shard), ids lifted to global ids, one merge.

Ties: `lax.top_k` puts the lower index first, so every top-k here goes
through `_topk`, an exact selection in that order.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import _kernels

NEG_INF = -3.0e38
INT32_MIN = -(2**31) + 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# entries up to which `_topk` on the card builds the int64 keys of every
# entry (at most 128 MB) in one pass with no host sync: the coarse probes and
# the small flat top-ks; the PQ4 search's at B=64 (168M entries) is above it
_ONE_PASS_MAX = 1 << 24


def _topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis in `lax.top_k`'s order: descending in the
    float total order (NaN first, +0.0 before -0.0), the lower index first
    among equal values.

    float32 is an exact selection with no sort, over the int64 keys
    `(key32 << 32) | (n - 1 - index)`, where key32 is the order-preserving
    integer of the f32 bits (`_order_key`): the keys are distinct, so the
    order `torch.topk` leaves unspecified on ties never arises.

    - On the CPU, and on the card up to `_ONE_PASS_MAX` entries, one
      `torch.topk` over the keys of every entry (CPU `torch.topk` compares
      floats, so -0.0 would tie +0.0).
    - On the card above that, the keys of every entry would be 8 bytes an
      entry read several times, so a selection of the values instead: CUDA
      `torch.topk`'s radix select ranks floats in the total order itself
      (NaN first), so it returns every entry above the k-th value t and
      some of those equal to t. Where a row has more entries equal to t
      than it kept (a host sync decides), a second selection of
      `n - 1 - index` over the entries whose bits equal t's gives the
      lowest-index ties; the k best keys of the two disjoint sets are the
      answer.

    Other dtypes take a stable descending sort."""
    if s.dtype != torch.float32 or k == 0:
        vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    n = s.shape[-1]
    s = s.contiguous()
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=s.device)
    if s.device.type == "cpu" or s.numel() <= _ONE_PASS_MAX:
        comp = (_order_key(s).long() << 32) | rev
        sel = (n - 1) - (torch.topk(comp, k, dim=-1).values & 0xFFFFFFFF)
        return torch.gather(s, -1, sel), sel
    v1, i1 = torch.topk(s, k, dim=-1, sorted=False)
    key1 = _order_key(v1)
    t = key1.amin(dim=-1, keepdim=True)  # the k-th value's key
    rev_i, key = (n - 1) - i1, key1
    # _order_key is its own inverse: t's bits are _order_key(t)
    tied = s.view(torch.int32) == _order_key(t.view(torch.float32))
    if bool((tied.sum(dim=-1) > (key1 == t).sum(dim=-1)).any()):
        v2 = torch.topk(torch.where(tied, rev, -1), k, dim=-1, sorted=False).values
        above = torch.where(key1 > t, rev_i, -1)  # the ties come from v2 alone
        rev_i = torch.cat([above, v2.long()], dim=-1)
        key = torch.cat([key1, t.expand_as(key1)], dim=-1)
    del tied
    comp = torch.where(rev_i >= 0, (key.long() << 32) | rev_i, torch.iinfo(torch.int64).min)
    sel = (n - 1) - (torch.topk(comp, k, dim=-1).values & 0xFFFFFFFF)
    return torch.gather(s, -1, sel), sel


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values that order as the floats' total order
    (a negative float's bits order backwards: flip all but the sign bit)."""
    bits = x.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


# ---------------------------------------------------------------------------
# Exact top-k: chunked scan with a running merge. Oracle + small corpora.
# ---------------------------------------------------------------------------


def exact_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    k: int,
    *,
    chunk: int = 131072,
    metric: str = "ip",
    db_sq_norms: Optional[torch.Tensor] = None,
    ntotal: Optional[int] = None,  # true rows when db carries pad rows
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by score. Returns (scores [B,k] f32, indices [B,k] i32).

    metric 'ip' maximizes q.d; 'l2' maximizes 2*q.d - |d|^2 (equivalent to
    min L2 distance; scores returned are that surrogate)."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be ip|l2, got {metric!r}")
    n = db.shape[0]
    n_true = min(ntotal or n, n)
    b = queries.shape[0]
    k = min(k, n_true)
    chunk = max(min(chunk, n), k)
    q = queries.to(db.dtype)
    best_s = torch.full((b, k), NEG_INF, dtype=torch.float32, device=db.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=db.device)
    for start in range(0, n, chunk):
        rows = db[start : start + chunk]
        s = torch.matmul(q.float(), rows.float().T)
        if metric == "l2":
            norms = (
                db_sq_norms[start : start + chunk].float()
                if db_sq_norms is not None
                else (rows.float() * rows.float()).sum(-1)
            )
            s = 2.0 * s - norms[None, :]
        gids = torch.arange(
            start, start + rows.shape[0], device=db.device, dtype=torch.int32
        )
        s = torch.where(gids[None, :] < n_true, s, NEG_INF)
        # earlier candidates sit first, so `_topk` (the lower index first on
        # a tie) keeps the lower row, as the reference's running merge does
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, gids[None, :].expand(b, -1)], dim=1)
        best_s, sel = _topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, sel)
    return best_s, best_i


def _on_cpu(a: torch.Tensor, b: torch.Tensor, what: str) -> bool:
    """True when both tensors lie on the CPU (run the plain version), False
    when both lie on one CUDA device (launch the kernel); raises otherwise."""
    devs = {a.device.type, b.device.type}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or a.device != b.device:
        raise ValueError(
            f"{what}: tensors on {a.device} and {b.device}: both must be on "
            "one CUDA device (or both on the CPU)"
        )
    return False


def _check_words(*tensors: torch.Tensor) -> None:
    """The scan kernels read 32-bit words from contiguous rows."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 4 != 0:
            raise ValueError("kernel inputs must be contiguous and 4-byte aligned")
        if (t.shape[-1] * t.element_size()) % 4 != 0:
            raise ValueError(
                f"the kernel reads 32-bit words: a row of {t.shape[-1]} "
                f"{t.dtype} is not a whole number of words"
            )


def _nvalid(n: int, ntotal) -> int:
    """Rows the scan may read: `min(ntotal or n, n)`, as the reference."""
    return min(int(ntotal) or n, n) if ntotal is not None else n


# ---------------------------------------------------------------------------
# bf16 / f32 bin-max scan (K2): f32 accumulation, global row ids.
# ---------------------------------------------------------------------------


def binmax_partial_topk_plain(
    queries: torch.Tensor,  # [B, D], cast to db's dtype
    db: torch.Tensor,  # [N, D] bf16 / f32
    *,
    nbins: int = 512,
    ntotal: Optional[int] = None,
    rows_per_chunk: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, on any device.

    Scores are f32 matmuls of the db-dtype values (a bf16 x bf16 product is
    exact in f32), row chunk by row chunk; within a chunk the bin max comes
    from a reshape to [B, steps, nbins] and its earliest row from `argmax`
    over the equality mask. Chunks merge with a strict `>`, so the earliest
    row keeps a tie; rows at or past min(ntotal, N) never enter. Returns
    (vals [B,nbins] f32, NEG_INF = empty bin; idxs [B,nbins] i32, -1)."""
    n = db.shape[0]
    b = queries.shape[0]
    nt = _nvalid(n, ntotal)
    dev = db.device
    vals = torch.full((b, nbins), NEG_INF, dtype=torch.float32, device=dev)
    idxs = torch.full((b, nbins), -1, dtype=torch.int64, device=dev)
    q = queries.to(db.dtype).float()
    col = torch.arange(nbins, device=dev)
    step_rows = _round_up(max(rows_per_chunk, nbins), nbins)
    for start in range(0, nt, step_rows):
        stop = min(start + step_rows, nt)
        s = q @ db[start:stop].float().T  # [B, rows]
        steps = -(-(stop - start) // nbins)
        pad = steps * nbins - (stop - start)
        s = torch.nn.functional.pad(s, (0, pad), value=-float("inf"))
        s3 = s.view(b, steps, nbins)
        m = s3.amax(dim=1)
        first = torch.argmax((s3 == m[:, None, :]).to(torch.uint8), dim=1)
        better = m > vals  # -inf (no row) never beats NEG_INF
        vals = torch.where(better, m, vals)
        idxs = torch.where(better, start + first * nbins + col[None, :], idxs)
    return vals, idxs.to(torch.int32)


def binmax_partial_topk(
    queries: torch.Tensor,  # [B, D]
    db: torch.Tensor,  # [N, D] bf16 or f32
    *,
    nbins: int = 512,
    ntotal: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16/f32 partial top-k (K2): per query, the (score, global row) of
    the best row in each of `nbins` row-residue bins. Returns (vals [B,
    nbins] f32, idxs [B, nbins] i32), unsorted; an empty bin holds NEG_INF
    and -1.

    The result does not depend on the reference kernel's `chunk` (its grid
    step), so there is none here. On CUDA tensors this launches
    csrc/binmax_bf16.cu (or raises); on CPU tensors it runs
    `binmax_partial_topk_plain`."""
    if queries.dim() != 2 or db.dim() != 2:
        raise ValueError("queries and db must be 2-D")
    n, d = db.shape
    b = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"query dim {queries.shape[1]} != db dim {d}")
    nt = _nvalid(n, ntotal)
    if _on_cpu(queries, db, "binmax_partial_topk"):
        return binmax_partial_topk_plain(queries, db, nbins=nbins, ntotal=nt)
    if db.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"binmax_partial_topk scans bf16 or f32, not {db.dtype}")
    q = queries.to(db.dtype).contiguous()
    _check_words(q, db)
    dev = db.device
    vals = torch.empty((b, nbins), dtype=torch.float32, device=dev)
    idxs = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idxs
    groups = _scan_groups(dev, b, nbins, nt)
    part_vals = torch.empty((groups, b, nbins), dtype=torch.float32, device=dev)
    part_steps = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    _kernels.launch(
        "ragtorch_binmax_bf16", dev.index, q.data_ptr(), db.data_ptr(),
        part_vals.data_ptr(), part_steps.data_ptr(), vals.data_ptr(),
        idxs.data_ptr(), b, d, nt, nbins, groups, db.element_size(),
    )
    binmax_partial_topk.launches += 1
    return vals, idxs


binmax_partial_topk.launches = 0  # kernel launches, for chip_smoke.py


def fused_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    k: int,
    *,
    nbins: int = 512,
    ntotal: Optional[int] = None,
    scan=binmax_partial_topk,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused flat-IP search: bin-max scan (K2) + exact top-k over the
    survivors. Returns (scores [B,k] f32, ids [B,k] i32). Requires k <=
    nbins; `scan` is the partial top-k (the K2 wrapper; its plain version
    to compare on the card)."""
    if k > nbins:
        raise ValueError(
            f"fused_topk keeps only nbins={nbins} candidates; k={k} exceeds "
            "it — raise nbins or use exact_topk"
        )
    vals, idxs = scan(queries, db, nbins=nbins, ntotal=ntotal)
    s, sel = _topk(vals, min(k, vals.shape[1]))
    return s, torch.gather(idxs, 1, sel)


# ---------------------------------------------------------------------------
# Global-scale int8 scan (K1): int32-domain compares against one scalar
# scale for the whole corpus.
# ---------------------------------------------------------------------------


def quantize_global_int8(
    x: torch.Tensor, *, clip_pct: float = 99.9
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with ONE global scale, clipped at the
    `clip_pct` percentile (method "lower") of the per-row maxabs so a single
    outlier row cannot crush resolution for everyone.
    Returns (q [N,D] i8, scale f32 0-d tensor).

    The percentile index is computed in float32 as `jnp.percentile` does,
    and the value is picked with `kthvalue`: `torch.quantile` refuses inputs
    above 2^24 elements."""
    xf = x.float()
    maxabs = xf.abs().amax(dim=-1)
    n = maxabs.shape[0]
    pos = np.float32(np.float32(clip_pct) / np.float32(100.0)) * (
        np.float32(n) - np.float32(1.0)
    )
    low = int(np.clip(np.floor(pos), 0, n - 1))
    kth = torch.kthvalue(maxabs, low + 1).values
    clip = torch.clamp(kth, min=1e-9)
    scale = clip / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def binmax_partial_topk_int8gs_plain(
    queries_i8: torch.Tensor,  # [B, D] int8
    db_i8: torch.Tensor,  # [N, D] int8
    *,
    nbins: int = 1024,
    ntotal: Optional[int] = None,
    rows_per_chunk: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, on any device.

    Exact integer scores in float64 (exact for any D: |score| <= D*127^2),
    row chunk by row chunk; the bin max of a chunk comes from a reshape to
    [B, steps, nbins], and its earliest row from `argmax` over the equality
    mask (`argmax` returns the first index). Chunks merge with a strict `>`,
    so the earliest row keeps a tie. Returns (vals [B,nbins] i32, idxs
    [B,nbins] i32, -1 = empty bin)."""
    n = db_i8.shape[0]
    b = queries_i8.shape[0]
    nt = n if ntotal is None else max(min(int(ntotal), n), 0)
    dev = db_i8.device
    vals = torch.full((b, nbins), INT32_MIN, dtype=torch.int64, device=dev)
    idxs = torch.full((b, nbins), -1, dtype=torch.int64, device=dev)
    q = queries_i8.to(torch.float64)
    col = torch.arange(nbins, device=dev)
    step_rows = _round_up(max(rows_per_chunk, nbins), nbins)
    for start in range(0, nt, step_rows):
        stop = min(start + step_rows, nt)
        s = q @ db_i8[start:stop].to(torch.float64).T  # [B, rows] exact ints
        steps = -(-(stop - start) // nbins)
        pad = steps * nbins - (stop - start)
        s = torch.nn.functional.pad(s, (0, pad), value=-float("inf"))
        s3 = s.view(b, steps, nbins)
        m = s3.amax(dim=1)  # [B, nbins]
        first = torch.argmax((s3 == m[:, None, :]).to(torch.uint8), dim=1)
        row = start + first * nbins + col[None, :]
        m_i = torch.where(torch.isinf(m), INT32_MIN, m).to(torch.int64)
        better = (m_i > vals) & ~torch.isinf(m)
        vals = torch.where(better, m_i, vals)
        idxs = torch.where(better, row, idxs)
    return vals.to(torch.int32), idxs.to(torch.int32)


def binmax_partial_topk_int8gs(
    queries_i8: torch.Tensor,  # [B, D] int8 (pre-quantized)
    db_i8: torch.Tensor,  # [N, D] int8, global-scale quantized
    *,
    nbins: int = 1024,
    ntotal: Optional[Union[int, torch.Tensor]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-scale int8 partial top-k (K1). Returns (vals [B,nbins] i32
    raw int-domain scores, idxs [B,nbins] i32 global row ids, -1 = empty).

    `ntotal` (rows past it are never read) is an int or a 0-d tensor. The
    result does not depend on the reference kernel's `chunk` (its grid
    step), so there is none here. On CUDA tensors this launches
    csrc/binmax_int8gs.cu (or raises); on CPU tensors it runs
    `binmax_partial_topk_int8gs_plain`."""
    if queries_i8.dim() != 2 or db_i8.dim() != 2:
        raise ValueError("queries and db must be 2-D")
    n, d = db_i8.shape
    b = queries_i8.shape[0]
    if queries_i8.shape[1] != d:
        raise ValueError(f"query dim {queries_i8.shape[1]} != db dim {d}")
    nt = n if ntotal is None else max(min(int(ntotal), n), 0)
    if _on_cpu(queries_i8, db_i8, "binmax_partial_topk_int8gs"):
        return binmax_partial_topk_int8gs_plain(
            queries_i8, db_i8, nbins=nbins, ntotal=nt
        )
    if queries_i8.dtype != torch.int8 or db_i8.dtype != torch.int8:
        raise TypeError("binmax_partial_topk_int8gs takes int8 tensors")
    if d % 4 != 0:
        raise ValueError(f"the kernel reads int8x4 words: D={d} % 4 != 0")
    for t in (queries_i8, db_i8):
        if not t.is_contiguous() or t.data_ptr() % 4 != 0:
            raise ValueError("queries and db must be contiguous and 4-byte aligned")
    dev = db_i8.device
    vals = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    idxs = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idxs
    groups = _scan_groups(dev, b, nbins, nt)
    part_vals = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    part_steps = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    _kernels.launch(
        "ragtorch_binmax_int8gs", dev.index, queries_i8.data_ptr(),
        db_i8.data_ptr(), part_vals.data_ptr(), part_steps.data_ptr(),
        vals.data_ptr(), idxs.data_ptr(), b, d, nt, nbins, groups,
    )
    binmax_partial_topk_int8gs.launches += 1
    return vals, idxs


binmax_partial_topk_int8gs.launches = 0  # kernel launches, for chip_smoke.py


def _scan_groups(dev: torch.device, b: int, nbins: int, nt: int) -> int:
    """Split of the bin-max kernels' step range (one step: nbins rows) over
    gridDim.z, the same rule for K1, K2 and K3: at most four blocks of
    their grid per SM, two waves of the two that run at once (rounding up
    would start a third, mostly idle wave), and never more groups than
    steps (or than a grid dimension allows). The grid is the kernels' own
    tile (`_kernels.binmax_tile`): bin tiles by ceil(b / max_q) query
    tiles, each of which reads the rows once."""
    bin_tile, max_q = _kernels.binmax_tile()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = -(-nbins // bin_tile) * -(-b // max_q)
    steps = -(-nt // nbins)
    return max(1, min(steps, 4 * sms // base, 65535))


def _rescore(
    queries: torch.Tensor, vals: torch.Tensor, idxs: torch.Tensor,
    rescore_db: torch.Tensor, rescore_k: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-score of the top `rescore_k` scan survivors against
    `rescore_db`, the query cast to its dtype first; empty bins (id -1)
    score NEG_INF. Returns the top k (scores, ids)."""
    shortlist = min(rescore_k, vals.shape[1])
    _, sel = _topk(vals, shortlist)
    cand_ids = torch.gather(idxs, 1, sel)  # [B, S]
    cand = rescore_db[cand_ids.clamp(min=0).long()]  # [B, S, D]
    # products of the working dtype are exact in f32; f32 accumulation
    exact = torch.einsum(
        "bsd,bd->bs", cand.float(), queries.to(cand.dtype).float()
    )
    exact = torch.where(cand_ids >= 0, exact, NEG_INF)
    s, sel2 = _topk(exact, min(k, shortlist))
    return s, torch.gather(cand_ids, 1, sel2)


def fused_topk_int8gs(
    queries: torch.Tensor,  # [B, D] float — quantized internally
    db_i8: torch.Tensor,
    db_scale: torch.Tensor,  # 0-d f32 (from quantize_global_int8)
    k: int,
    *,
    nbins: int = 1024,
    rescore_db: Optional[torch.Tensor] = None,  # [N, D] bf16 rows
    rescore_k: int = 0,
    ntotal: Optional[Union[int, torch.Tensor]] = None,
    scan=binmax_partial_topk_int8gs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global-scale quantized flat search: int8 scan (int32-domain compare)
    + top-k over the nbins survivors, with an exact re-score of the top
    rescore_k candidates against `rescore_db` when rescore_k > k.

    The query scale is ONE scalar for the whole batch, as in the reference,
    so ids depend on the other queries in the batch. `scan` is the partial
    top-k (the K1 wrapper; its plain version to compare on the card)."""
    qf = queries.float()
    q_scale = torch.clamp(qf.abs().amax(), min=1e-9) / 127.0
    q_i8 = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
    vals_i, idxs = scan(q_i8, db_i8, nbins=nbins, ntotal=ntotal)
    vals = torch.where(
        idxs >= 0, vals_i.float() * (q_scale * db_scale.float()), NEG_INF
    )
    if rescore_db is not None and rescore_k > k:
        return _rescore(queries, vals, idxs, rescore_db, rescore_k, k)
    s, sel = _topk(vals, min(k, vals.shape[1]))
    return s, torch.gather(idxs, 1, sel)


# ---------------------------------------------------------------------------
# Per-row-scale int8 scan (K3): scores = float(q_i8 . db_i8) * db_scale[row],
# compared in f32. Reached only through `fused_topk_int8`.
# ---------------------------------------------------------------------------


def quantize_rows_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization. Returns (q [N,D] i8, scales [N]
    f32). Divides by the scale (not a multiply by its reciprocal) and
    rounds half to even, as the reference."""
    xf = x.float()
    scales = torch.clamp(xf.abs().amax(dim=-1), min=1e-9) / 127.0
    q = torch.clamp(torch.round(xf / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def binmax_partial_topk_int8_plain(
    queries_i8: torch.Tensor,  # [B, D] int8
    db_i8: torch.Tensor,  # [N, D] int8
    db_scales: torch.Tensor,  # [N] f32
    *,
    nbins: int = 512,
    rows_per_chunk: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3, on any device: K1's plain scan with
    one f32 multiply by the row scale.

    The float64 dot is exact; its cast to f32 rounds as the reference's
    int32 -> f32 convert does, and the product with the f32 row scale is
    one f32 multiply. A score that is NaN or not above NEG_INF never
    enters a bin (strict `>` from NEG_INF, as the reference). Returns
    (vals [B,nbins] f32, NEG_INF = empty bin; idxs [B,nbins] i32, -1)."""
    n = db_i8.shape[0]
    b = queries_i8.shape[0]
    dev = db_i8.device
    vals = torch.full((b, nbins), NEG_INF, dtype=torch.float32, device=dev)
    idxs = torch.full((b, nbins), -1, dtype=torch.int64, device=dev)
    q = queries_i8.to(torch.float64)
    scales = db_scales.to(torch.float32)
    col = torch.arange(nbins, device=dev)
    step_rows = _round_up(max(rows_per_chunk, nbins), nbins)
    for start in range(0, n, step_rows):
        stop = min(start + step_rows, n)
        s = (q @ db_i8[start:stop].to(torch.float64).T).float()
        s = s * scales[None, start:stop]
        s = torch.where(torch.isnan(s), -float("inf"), s)
        steps = -(-(stop - start) // nbins)
        pad = steps * nbins - (stop - start)
        s = torch.nn.functional.pad(s, (0, pad), value=-float("inf"))
        s3 = s.view(b, steps, nbins)
        m = s3.amax(dim=1)
        first = torch.argmax((s3 == m[:, None, :]).to(torch.uint8), dim=1)
        better = m > vals
        vals = torch.where(better, m, vals)
        idxs = torch.where(better, start + first * nbins + col[None, :], idxs)
    return vals, idxs.to(torch.int32)


def binmax_partial_topk_int8(
    queries_i8: torch.Tensor,  # [B, D] int8 (pre-quantized)
    db_i8: torch.Tensor,  # [N, D] int8
    db_scales: torch.Tensor,  # [N] f32
    *,
    nbins: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-scale int8 partial top-k (K3). Returns (vals [B,nbins] f32
    scores dequantized by the row scale only, idxs [B,nbins] i32 rows, -1
    for an empty bin). The query scale is left out: a positive constant
    per query does not change its ranking.

    The result does not depend on the reference kernel's `chunk`, so
    there is none here. On CUDA tensors this launches csrc/binmax_int8.cu
    (or raises); on CPU tensors it runs `binmax_partial_topk_int8_plain`."""
    if queries_i8.dim() != 2 or db_i8.dim() != 2 or db_scales.dim() != 1:
        raise ValueError("queries and db must be 2-D, db_scales 1-D")
    n, d = db_i8.shape
    b = queries_i8.shape[0]
    if queries_i8.shape[1] != d or db_scales.shape[0] != n:
        raise ValueError(
            f"shapes disagree: queries {tuple(queries_i8.shape)}, db "
            f"{tuple(db_i8.shape)}, scales {tuple(db_scales.shape)}"
        )
    if _on_cpu(queries_i8, db_i8, "binmax_partial_topk_int8"):
        if db_scales.device.type != "cpu":
            raise ValueError("binmax_partial_topk_int8: db_scales not on the CPU")
        return binmax_partial_topk_int8_plain(
            queries_i8, db_i8, db_scales, nbins=nbins
        )
    if db_scales.device != db_i8.device:
        raise ValueError(f"db_scales on {db_scales.device}, db on {db_i8.device}")
    if queries_i8.dtype != torch.int8 or db_i8.dtype != torch.int8:
        raise TypeError("binmax_partial_topk_int8 takes int8 queries and rows")
    if db_scales.dtype != torch.float32:
        raise TypeError(f"db_scales must be float32, not {db_scales.dtype}")
    _check_words(queries_i8, db_i8, db_scales)
    dev = db_i8.device
    vals = torch.empty((b, nbins), dtype=torch.float32, device=dev)
    idxs = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idxs
    groups = _scan_groups(dev, b, nbins, n)
    part_vals = torch.empty((groups, b, nbins), dtype=torch.float32, device=dev)
    part_steps = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    _kernels.launch(
        "ragtorch_binmax_int8", dev.index, queries_i8.data_ptr(),
        db_i8.data_ptr(), db_scales.data_ptr(), part_vals.data_ptr(),
        part_steps.data_ptr(), vals.data_ptr(), idxs.data_ptr(), b, d, n,
        nbins, groups,
    )
    binmax_partial_topk_int8.launches += 1
    return vals, idxs


binmax_partial_topk_int8.launches = 0  # kernel launches, for chip_smoke.py


def fused_topk_int8(
    queries: torch.Tensor,  # [B, D] float — quantized internally
    db_i8: torch.Tensor,
    db_scales: torch.Tensor,  # [N] f32 (from quantize_rows_int8)
    k: int,
    *,
    nbins: int = 512,
    chunk: int = 8192,
    rescore_db: Optional[torch.Tensor] = None,  # [N, D] full-precision rows
    rescore_k: int = 0,
    scan=binmax_partial_topk_int8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-scale quantized flat search: int8 scan (K3) + top-k over the
    nbins survivors, with an exact re-score of the top rescore_k against
    `rescore_db` when rescore_k > k. Returns (scores [B,k] f32, ids [B,k]
    i32).

    `chunk` is the reference kernel's grid step; the result does not
    depend on it, and it is checked as the reference checks it. Without a
    re-score the scores are the scan's times the query's own scale, so an
    empty bin scores NEG_INF * q_scale with id -1, as in the reference.
    `scan` is the partial top-k (the K3 wrapper; its plain version to
    compare on the card)."""
    if chunk % nbins != 0:
        raise ValueError(f"chunk ({chunk}) must be a multiple of nbins ({nbins})")
    q_i8, q_scales = quantize_rows_int8(queries)
    vals, idxs = scan(q_i8, db_i8, db_scales, nbins=nbins)
    vals = vals * q_scales[:, None]
    if rescore_db is not None and rescore_k > k:
        return _rescore(queries, vals, idxs, rescore_db, rescore_k, k)
    s, sel = _topk(vals, min(k, vals.shape[1]))
    return s, torch.gather(idxs, 1, sel)


# ---------------------------------------------------------------------------
# Sharded search: database rows split over the mesh's dp positions; a local
# scan per position, then one merge of the [B, dp*k] candidates.
# ---------------------------------------------------------------------------


def _merge_shards(
    ctx, parts: list[tuple[torch.Tensor, torch.Tensor]], k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's all-gather merge: every position's (scores, ids)
    gathered on the front device in position order, then one `_topk`, so a
    tie goes to the lower shard (as `lax.top_k` over the tiled gather)."""
    front = ctx.front
    s_all = torch.cat([s.to(front) for s, _ in parts], dim=1)
    i_all = torch.cat([i.to(front) for _, i in parts], dim=1)
    ms, sel = _topk(s_all, k)
    return ms, torch.gather(i_all, 1, sel)


def _check_shards(ctx, *placed) -> None:
    for p in placed:
        if p is not None and len(p) != ctx.dp:
            raise ValueError(f"{len(p)} shards for a mesh of dp={ctx.dp}")


def sharded_topk(
    ctx,
    queries: torch.Tensor,
    db_shards,  # dp row blocks of [N_pad, D] (MeshContext.put(db, rows_dp))
    k: int,
    *,
    use_fused: bool = False,
    nbins: int = 512,
    chunk: int = 4096,
    metric: str = "ip",
    ntotal: Optional[int] = None,
    scan=binmax_partial_topk,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a dp-row-sharded database (reference `ops/topk.py:645`).

    Each position scans its rows: K2 through `fused_topk` with
    `use_fused`, else `exact_topk`; local ids are lifted to global ids and
    rows at or past `ntotal` (the even-sharding pad) masked to NEG_INF and
    -1 after the scan, as the reference masks them. Every position's scan
    is launched before any result is read (no host sync between shards),
    so on several devices the scans overlap. `scan` as in `fused_topk`."""
    _check_shards(ctx, db_shards)
    if use_fused and metric != "ip":
        raise ValueError("fused sharded scan supports metric='ip' only")
    shard_rows = db_shards[0].shape[0]
    n_real = ntotal if ntotal is not None else shard_rows * ctx.dp
    parts = []
    for shard, (dev, db_l) in enumerate(zip(ctx.devices, db_shards)):
        q = queries.to(dev)
        if use_fused:
            s, i = fused_topk(q, db_l, k, nbins=nbins, scan=scan)
        else:
            s, i = exact_topk(
                q, db_l, k, chunk=min(chunk * 8, shard_rows), metric=metric
            )
        gid = i + shard * shard_rows
        s = torch.where(gid < n_real, s, NEG_INF)
        parts.append((s, torch.where(gid < n_real, gid, -1)))
    return _merge_shards(ctx, parts, k)


def sharded_topk_int8gs(
    ctx,
    queries: torch.Tensor,  # [B, D] float, the whole batch
    db_i8_shards,  # dp row blocks of [N_pad, D] int8
    db_scale,  # the global scale: a 0-d f32 tensor, or one per position
    k: int,
    *,
    rescore_db_shards=None,  # dp row blocks of [N_pad, D] bf16
    rescore_k: int = 0,
    nbins: int = 1024,
    ntotal: Optional[int] = None,
    scan=binmax_partial_topk_int8gs,
) -> tuple[torch.Tensor, torch.Tensor]:
    """dp-sharded global-scale int8 scan (K1, once a shard) + per-shard bf16
    re-score + merge: the sharded twin of `fused_topk_int8gs` (reference
    `ops/topk.py:705`).

    Each shard passes the rows it owns, `clip(ntotal - shard * shard_rows,
    0, shard_rows)`, as the kernel's `ntotal`, so even-sharding pad rows
    never enter a bin and cannot displace a real negative-scoring
    candidate; a shard that owns no row is not scanned (its candidates are
    the empty bins' NEG_INF and -1). The query's int8 scale is the whole
    batch's on every shard, and `db_scale` is the corpus's, never a
    shard's own. The re-score runs per shard over that shard's rescore_k
    survivors, so ids may differ from the unsharded search's."""
    _check_shards(ctx, db_i8_shards, rescore_db_shards)
    scales = db_scale if isinstance(db_scale, (list, tuple)) else [db_scale] * ctx.dp
    shard_rows = db_i8_shards[0].shape[0]
    n_real = ntotal if ntotal is not None else shard_rows * ctx.dp
    rescore = rescore_db_shards is not None and rescore_k > k
    width = min(k, nbins, rescore_k if rescore else nbins)
    parts = []
    for shard, dev in enumerate(ctx.devices):
        local_rows = max(0, min(n_real - shard * shard_rows, shard_rows))
        q = queries.to(dev)
        if local_rows == 0:
            b = q.shape[0]
            parts.append((
                torch.full((b, width), NEG_INF, dtype=torch.float32, device=dev),
                torch.full((b, width), -1, dtype=torch.int32, device=dev),
            ))
            continue
        s, i = fused_topk_int8gs(
            q, db_i8_shards[shard], scales[shard].to(dev), k, nbins=nbins,
            rescore_db=rescore_db_shards[shard] if rescore else None,
            rescore_k=rescore_k if rescore else 0,
            ntotal=local_rows, scan=scan,
        )
        gid = i + shard * shard_rows
        keep = (i >= 0) & (gid < n_real)
        parts.append((torch.where(keep, s, NEG_INF), torch.where(keep, gid, -1)))
    return _merge_shards(ctx, parts, k)
