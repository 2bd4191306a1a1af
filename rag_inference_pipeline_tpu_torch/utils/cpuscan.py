"""ctypes wrapper for `native/cpuscan.cc`: the multithreaded CPU scans (the
CPU yardstick a benchmark holds the card against) and the exact re-score of
a device shortlist against a host-RAM store (the flat index's
`rescore_store="host"`, the IVF-PQ `host_int8` and `host_f16` tiers).

Port of `rag_inference_pipeline_tpu/utils/cpuscan.py` with its signatures.
The library is built by `utils/native.py` (per process, renamed into
place), never by `make -C native`. Unlike the reference, whose callers
fall back to numpy when the build fails (`index/flat.py:79-82`,
`index/ivf_pq.py:413-417`), a failed build raises here.

Beside each scan and re-score is its plain numpy version (`*_plain`),
which the tests and `tools/bench_rescore_host.py` hold the native code
against; nothing on a served path calls them. The two differ in ways the
callers must allow for:

- a masked slot (id -1) of a re-score: the native code scores it
  -3.0e38 and keeps it in its size-k heap; the plain versions fill it as
  the reference's numpy fallbacks do (-inf for f16, NEG_INF for int8);
- accumulation order: the native dot products run 16- (AVX-512) or 8-lane
  (AVX/F16C) FMAs and a reduce, the plain ones `einsum` or a matmul;
- ties: the native heap keeps the first of equal scores and sorts
  unstably, the plain versions select with `argpartition` and order by an
  unstable `argsort` (re-scores) or stably (scans).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from . import native

# the reference's NEG_INF (ops/topk.py): the int8 tier's masked fill
NEG_INF = -3.0e38

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)
_I8P = ctypes.POINTER(ctypes.c_int8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U16P = ctypes.POINTER(ctypes.c_uint16)


def load_lib() -> ctypes.CDLL:
    """The built `cpuscan` library with every entry point's argtypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = native.load("cpuscan")
        i32, i64, f32 = ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.cs_scan_f32.argtypes = [_F32P, i32, _F32P, i64, i32, i32, i32, _F32P, _I32P]
        lib.cs_scan_i8.argtypes = [
            _I8P, i32, _I8P, i64, i32, _F32P, i32, i32, _F32P, _I32P,
        ]
        lib.cs_scan_ivf_f32.argtypes = [
            _F32P, i32, _F32P, i32, i32, _F32P, _I32P, _I64P, i32, i32, i32,
            _F32P, _I32P,
        ]
        lib.cs_rescore_i8.argtypes = [
            _F32P, i32, _I8P, i64, i32, f32, _I32P, i32, i32, i32, _F32P, _I32P,
        ]
        lib.cs_rescore_f16.argtypes = [
            _F32P, i32, _U16P, i64, i32, _I32P, i32, i32, i32, _F32P, _I32P,
        ]
        lib.cs_hw_threads.restype = ctypes.c_int
        lib.cs_madvise_hugepage.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.cs_madvise_hugepage.restype = ctypes.c_int
        _lib = lib
        return lib


def hw_threads() -> int:
    return int(load_lib().cs_hw_threads())


def madvise_hugepage(arr: np.ndarray) -> bool:
    """Ask for 2 MB pages under a host store (MADV_HUGEPAGE, then
    MADV_COLLAPSE on Linux 6.1+). False where the array is under 2 MB or
    the OS refuses; the store works on 4 KB pages either way. A failed
    build of the library raises."""
    lib = load_lib()
    if arr.nbytes < (1 << 21):
        return False
    return lib.cs_madvise_hugepage(arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes) == 0


def _out(b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    return np.empty((b, k), np.float32), np.empty((b, k), np.int32)


def _check(q: np.ndarray, rows: np.ndarray, ids: Optional[np.ndarray] = None) -> None:
    """The shapes the native code trusts: [B, D] queries against [N, D]
    rows, and shortlist ids below N."""
    if q.ndim != 2 or rows.ndim != 2 or q.shape[1] != rows.shape[1]:
        raise ValueError(f"queries {q.shape} and rows {rows.shape} disagree on D")
    if ids is not None:
        if ids.ndim != 2 or ids.shape[0] != q.shape[0]:
            raise ValueError(f"ids {ids.shape} are not [B={q.shape[0]}, S]")
        if ids.size and int(ids.max()) >= rows.shape[0]:
            raise ValueError(f"id {int(ids.max())} past the store's {rows.shape[0]} rows")


# ---------------------------------------------------------------------------
# Scans (the CPU yardstick)
# ---------------------------------------------------------------------------


def scan_f32(
    queries: np.ndarray, db: np.ndarray, k: int, *, nthreads: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Exact f32 inner-product top-k over every row (IndexFlatIP). Slots
    past the row count hold (-3.0e38, -1)."""
    q = np.ascontiguousarray(queries, np.float32)
    d = np.ascontiguousarray(db, np.float32)
    _check(q, d)
    out_s, out_i = _out(q.shape[0], k)
    load_lib().cs_scan_f32(
        q.ctypes.data_as(_F32P), q.shape[0], d.ctypes.data_as(_F32P),
        d.shape[0], q.shape[1], k, nthreads,
        out_s.ctypes.data_as(_F32P), out_i.ctypes.data_as(_I32P),
    )
    return out_s, out_i


def scan_i8(
    queries_i8: np.ndarray, db_i8: np.ndarray, scales: np.ndarray, k: int,
    *, nthreads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Int8 scan with a dequant scale per row (SQ8): score =
    scales[row] * (q_i8 . row_i8). The query's own scale is the caller's."""
    q = np.ascontiguousarray(queries_i8, np.int8)
    d = np.ascontiguousarray(db_i8, np.int8)
    sc = np.ascontiguousarray(scales, np.float32)
    _check(q, d)
    if sc.shape != (d.shape[0],):
        raise ValueError(f"scales {sc.shape} are not one a row of {d.shape[0]}")
    out_s, out_i = _out(q.shape[0], k)
    load_lib().cs_scan_i8(
        q.ctypes.data_as(_I8P), q.shape[0], d.ctypes.data_as(_I8P), d.shape[0],
        q.shape[1], sc.ctypes.data_as(_F32P), k, nthreads,
        out_s.ctypes.data_as(_F32P), out_i.ctypes.data_as(_I32P),
    )
    return out_s, out_i


def scan_ivf_f32(
    queries: np.ndarray, centroids: np.ndarray, codes: np.ndarray,
    ids: np.ndarray, offsets: np.ndarray, nprobe: int, k: int,
    *, nthreads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """IVF-Flat probe (IndexIVFFlat): the nprobe best centroids by inner
    product, then an exact scan of their lists. `codes` [n, d] list-major,
    `ids` [n] the rows' global ids, `offsets` [nlist + 1] the list
    boundaries."""
    q = np.ascontiguousarray(queries, np.float32)
    c = np.ascontiguousarray(centroids, np.float32)
    v = np.ascontiguousarray(codes, np.float32)
    li = np.ascontiguousarray(ids, np.int32)
    off = np.ascontiguousarray(offsets, np.int64)
    _check(q, c)
    _check(q, v)
    if li.shape != (v.shape[0],) or off.shape != (c.shape[0] + 1,) or (
        off[0] != 0 or off[-1] != v.shape[0] or (np.diff(off) < 0).any()
    ):
        raise ValueError("ids must be [n] and offsets [nlist + 1], ascending from 0 to n")
    out_s, out_i = _out(q.shape[0], k)
    load_lib().cs_scan_ivf_f32(
        q.ctypes.data_as(_F32P), q.shape[0], c.ctypes.data_as(_F32P), c.shape[0],
        q.shape[1], v.ctypes.data_as(_F32P), li.ctypes.data_as(_I32P),
        off.ctypes.data_as(_I64P), nprobe, k, nthreads,
        out_s.ctypes.data_as(_F32P), out_i.ctypes.data_as(_I32P),
    )
    return out_s, out_i


# ---------------------------------------------------------------------------
# Shortlist re-scores (refine from a host store)
# ---------------------------------------------------------------------------


def rescore_i8(
    queries: np.ndarray, codes: np.ndarray, scale: float, ids: np.ndarray,
    k: int, *, nthreads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact re-score of a shortlist against a host int8 store with one
    global scale: queries [B, D] f32, codes [N, D] int8 C-contiguous, ids
    [B, S] int32 (-1 masked). Returns the top min(k, S), sorted."""
    q = np.ascontiguousarray(queries, np.float32)
    i = np.ascontiguousarray(ids, np.int32)
    if codes.dtype != np.int8 or not codes.flags.c_contiguous:
        raise ValueError("rescore_i8 needs a C-contiguous int8 store")
    _check(q, codes, i)
    b, s = i.shape
    out_s, out_i = _out(b, min(k, s))
    load_lib().cs_rescore_i8(
        q.ctypes.data_as(_F32P), b, codes.ctypes.data_as(_I8P), codes.shape[0],
        q.shape[1], ctypes.c_float(scale), i.ctypes.data_as(_I32P), s,
        out_s.shape[1], nthreads,
        out_s.ctypes.data_as(_F32P), out_i.ctypes.data_as(_I32P),
    )
    return out_s, out_i


def rescore_f16(
    queries: np.ndarray, store_f16: np.ndarray, ids: np.ndarray, k: int,
    *, nthreads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact re-score of a shortlist against a host f16 store [N, D]
    (C-contiguous); otherwise as `rescore_i8`."""
    q = np.ascontiguousarray(queries, np.float32)
    i = np.ascontiguousarray(ids, np.int32)
    if store_f16.dtype != np.float16 or not store_f16.flags.c_contiguous:
        raise ValueError("rescore_f16 needs a C-contiguous float16 store")
    _check(q, store_f16, i)
    b, s = i.shape
    out_s, out_i = _out(b, min(k, s))
    load_lib().cs_rescore_f16(
        q.ctypes.data_as(_F32P), b, store_f16.ctypes.data_as(_U16P),
        store_f16.shape[0], q.shape[1], i.ctypes.data_as(_I32P), s,
        out_s.shape[1], nthreads,
        out_s.ctypes.data_as(_F32P), out_i.ctypes.data_as(_I32P),
    )
    return out_s, out_i


# ---------------------------------------------------------------------------
# Plain numpy versions (tests and benches only)
# ---------------------------------------------------------------------------


def _top_sorted(s: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's numpy selection: `argpartition`, then an unstable
    descending `argsort` of the k kept."""
    k = min(k, s.shape[1])
    sel = np.argpartition(-s, k - 1, axis=1)[:, :k]
    ss = np.take_along_axis(s, sel, axis=1)
    order = np.argsort(-ss, axis=1)
    return (
        np.take_along_axis(ss, order, axis=1),
        np.take_along_axis(np.take_along_axis(ids, sel, axis=1), order, axis=1),
    )


def rescore_f16_plain(
    queries: np.ndarray, store_f16: np.ndarray, ids: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """`rescore_f16` in numpy, as the reference's fallback
    (`index/flat.py:85-99`): an f32 gather, an einsum, -inf at id -1."""
    q = np.asarray(queries, np.float32)
    ids = np.asarray(ids, np.int32)
    cand = store_f16[np.clip(ids, 0, None)].astype(np.float32)  # [B, S, D]
    s = np.einsum("bsd,bd->bs", cand, q)
    return _top_sorted(np.where(ids >= 0, s, -np.inf), ids, k)


def rescore_i8_plain(
    queries: np.ndarray, codes: np.ndarray, scale: float, ids: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """`rescore_i8` in numpy, as the reference's fallback
    (`index/ivf_pq.py:418-431`): the einsum times `scale`, NEG_INF at id
    -1."""
    q = np.asarray(queries, np.float32)
    ids = np.asarray(ids, np.int32)
    cand = codes[np.clip(ids, 0, None)].astype(np.float32)  # [B, S, D]
    s = np.einsum("bsd,bd->bs", cand, q) * scale
    return _top_sorted(np.where(ids >= 0, s, NEG_INF), ids, k)


def _fill_topk(s: np.ndarray, ids: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top k of each row of s [B, n] by a stable descending sort; slots
    past n hold (-3.0e38, -1), as the native scans fill them."""
    b, n = s.shape
    out_s = np.full((b, k), NEG_INF, np.float32)
    out_i = np.full((b, k), -1, np.int32)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    m = order.shape[1]
    out_s[:, :m] = np.take_along_axis(s, order, axis=1)
    out_i[:, :m] = np.take_along_axis(ids, order, axis=1)
    return out_s, out_i


def scan_f32_plain(
    queries: np.ndarray, db: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """`scan_f32` in numpy: one f32 matmul, a stable top-k."""
    s = np.asarray(queries, np.float32) @ np.asarray(db, np.float32).T
    ids = np.broadcast_to(np.arange(s.shape[1], dtype=np.int32), s.shape)
    return _fill_topk(s, ids, k)


def scan_i8_plain(
    queries_i8: np.ndarray, db_i8: np.ndarray, scales: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """`scan_i8` in numpy: exact int32 dots, one f32 multiply by the row's
    scale (so its scores equal the native ones bit for bit)."""
    dots = np.asarray(queries_i8, np.int32) @ np.asarray(db_i8, np.int32).T
    s = np.asarray(scales, np.float32)[None, :] * dots.astype(np.float32)
    ids = np.broadcast_to(np.arange(s.shape[1], dtype=np.int32), s.shape)
    return _fill_topk(s, ids, k)


def scan_ivf_f32_plain(
    queries: np.ndarray, centroids: np.ndarray, codes: np.ndarray,
    ids: np.ndarray, offsets: np.ndarray, nprobe: int, k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """`scan_ivf_f32` in numpy: the nprobe best lists by a stable sort of
    the centroid scores, then the exact scores of their members."""
    q = np.asarray(queries, np.float32)
    c = np.asarray(centroids, np.float32)
    v = np.asarray(codes, np.float32)
    ids = np.asarray(ids, np.int32)
    offsets = np.asarray(offsets, np.int64)
    nprobe = min(nprobe, c.shape[0])
    lists = np.argsort(-(q @ c.T), axis=1, kind="stable")[:, :nprobe]
    out_s = np.full((q.shape[0], k), NEG_INF, np.float32)
    out_i = np.full((q.shape[0], k), -1, np.int32)
    for b in range(q.shape[0]):
        rows = np.concatenate(
            [np.arange(offsets[li], offsets[li + 1]) for li in lists[b]]
        ).astype(np.int64)
        s_b, i_b = _fill_topk((v[rows] @ q[b])[None, :], ids[rows][None, :], k)
        out_s[b], out_i[b] = s_b[0], i_b[0]
    return out_s, out_i
