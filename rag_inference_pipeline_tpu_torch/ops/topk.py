"""Flat similarity scan + top-k: exact scan, the global-scale int8 bin-max
scan (kernel K1) and the fused int8 search with exact bf16 re-score.

Port of `rag_inference_pipeline_tpu/ops/topk.py`. The int8 scan keeps, per
query, a running (max, earliest row) in each of `nbins` bins (bin = row %
nbins); an exact top-k over the survivors gives the result. On a CUDA
tensor `binmax_partial_topk_int8gs` launches the hand-written Hopper kernel
in `csrc/binmax_int8gs.cu`; on a CPU tensor it runs the plain PyTorch
version beside it, which is also the kernel's oracle.

Ties: `lax.top_k` puts the lower index first, so every top-k here is a
stable descending sort (`_topk`).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

NEG_INF = -3.0e38
INT32_MIN = -(2**31) + 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis; among equal values the lower index first
    (the order `lax.top_k` gives; `torch.topk` promises none)."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
        # earlier candidates sit first, so the stable sort keeps the lower
        # row on a tie, as the reference's running merge does
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, gids[None, :].expand(b, -1)], dim=1)
        best_s, sel = _topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, sel)
    return best_s, best_i


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
    devs = {queries_i8.device.type, db_i8.device.type}
    if devs == {"cpu"}:
        return binmax_partial_topk_int8gs_plain(
            queries_i8, db_i8, nbins=nbins, ntotal=nt
        )
    if devs != {"cuda"} or queries_i8.device != db_i8.device:
        raise ValueError(
            f"queries on {queries_i8.device}, db on {db_i8.device}: both "
            "must be on one CUDA device (or both on the CPU)"
        )
    if queries_i8.dtype != torch.int8 or db_i8.dtype != torch.int8:
        raise TypeError("binmax_partial_topk_int8gs takes int8 tensors")
    if d % 4 != 0:
        raise ValueError(f"the kernel reads int8x4 words: D={d} % 4 != 0")
    for t in (queries_i8, db_i8):
        if not t.is_contiguous() or t.data_ptr() % 4 != 0:
            raise ValueError("queries and db must be contiguous and 4-byte aligned")
    from . import _kernels

    dev = db_i8.device
    vals = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    idxs = torch.empty((b, nbins), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idxs
    groups = _scan_groups(dev, b, nbins, nt)
    part_vals = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    part_steps = torch.empty((groups, b, nbins), dtype=torch.int32, device=dev)
    lib = _kernels.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ragtorch_binmax_int8gs(
            queries_i8.data_ptr(), db_i8.data_ptr(),
            part_vals.data_ptr(), part_steps.data_ptr(),
            vals.data_ptr(), idxs.data_ptr(),
            b, d, nt, nbins, groups, stream,
        )
    if rc != 0:
        raise RuntimeError(f"binmax_int8gs launch failed: cudaError {rc}")
    binmax_partial_topk_int8gs.launches += 1
    return vals, idxs


binmax_partial_topk_int8gs.launches = 0  # kernel launches, for chip_smoke.py


def _scan_groups(dev: torch.device, b: int, nbins: int, nt: int) -> int:
    """Split of K1's step range over gridDim.z: about four blocks per SM,
    and never more groups than steps (or than a grid dimension allows)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    base = -(-nbins // 64) * -(-b // 8)  # the kernel's kBinTile x kQTile
    steps = -(-nt // nbins)
    return max(1, min(steps, -(-4 * sms // base), 65535))


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
    s, sel = _topk(vals, min(k, vals.shape[1]))
    return s, torch.gather(idxs, 1, sel)
