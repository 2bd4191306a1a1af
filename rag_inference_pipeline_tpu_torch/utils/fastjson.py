"""ctypes wrapper for `native/fastjson.cc`, the JSON codec of the
`/retrieve` hot path (the role orjson/msgspec play for the reference's
service wire).

Port of `rag_inference_pipeline_tpu/utils/fastjson.py` with its contract:
`parse_retrieve` reads the strict retrieve-by-embedding shape straight
into an f32 matrix and returns None for anything else (a text query, a
missing embedding, a dim mismatch, `embeddings_b64`, NaN literals,
escaped keys, malformed JSON, ...). The server then parses with the
stdlib as before, so every 400 and every payload mode is unchanged; the
fast path only answers requests that the stdlib path would answer the
same way. `encode_results` writes the `id_only` response from packed
arrays, scores as `%.9g` (an f32 reads back exactly), or returns None for
a result that carries more than ids and scores.

The library is built by `utils/native.py`; unlike the reference, whose
wrappers return None when the build fails (`fastjson.py:98-99, 145-146`),
a failed build raises here.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import NamedTuple, Optional

import numpy as np

from . import native

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)

# batches past this fall back to the stdlib path (which has no cap)
_MAX_ITEMS = 4096


def load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = native.load("fastjson")
        i64 = ctypes.c_int64
        lib.fj_parse_retrieve.argtypes = [
            ctypes.c_char_p, i64, i64, _F32P, _I32P, i64, _I64P, _I32P,
        ]
        lib.fj_parse_retrieve.restype = ctypes.c_int
        lib.fj_encode_results.argtypes = [_I64P, _F32P, _I64P, i64, ctypes.c_char_p, i64]
        lib.fj_encode_results.restype = ctypes.c_int64
        _lib = lib
        return lib


class ParsedRetrieve(NamedTuple):
    embeddings: np.ndarray  # [n, dim] f32
    item_k: np.ndarray  # [n] i32, -1 = absent
    rerank: bool
    k: Optional[int]  # the request's default k
    response_format: str  # "json" | "b64"


# a `k` written as a float (3.0, 3e0): the native parser takes it for 3,
# the port's stdlib path refuses it (400)
_FLOAT_K = re.compile(rb'"k"\s*:\s*-?[0-9]+[.eE]')


def parse_retrieve(body: bytes, dim: int) -> Optional[ParsedRetrieve]:
    """A `/retrieve` body in the strict shape, or None: the caller then
    parses it with the stdlib. `body` must be `bytes` (its buffer is
    NUL-terminated, which the native number parser relies on).

    Three checks before the native parse decline bodies that the native
    parser would read otherwise than the port's stdlib path: a byte past
    ASCII (the stdlib refuses invalid UTF-8 that the native parser skips
    inside an unknown string), a backslash (an escaped key such as
    `"\\u006b"` is "k" to the stdlib, an unknown key to the native
    parser), and a float-valued `k`. A body in the strict shape has none
    of them."""
    if dim <= 0 or not body or len(body) < 2:
        return None
    if not body.isascii() or b"\\" in body or _FLOAT_K.search(body):
        return None
    # every item costs at least 2 bytes a float
    max_items = min(_MAX_ITEMS, max(1, len(body) // (dim * 2)))
    lib = load_lib()
    emb = np.empty((max_items, dim), np.float32)
    item_k = np.empty((max_items,), np.int32)
    n_out = ctypes.c_int64(-1)
    top = (ctypes.c_int32 * 3)()
    rc = lib.fj_parse_retrieve(
        bytes(body), len(body), dim, emb.ctypes.data_as(_F32P),
        item_k.ctypes.data_as(_I32P), max_items, ctypes.byref(n_out), top,
    )
    if rc != 0:
        return None
    n = n_out.value
    return ParsedRetrieve(
        embeddings=emb[:n],
        item_k=item_k[:n],
        rerank=bool(top[0]),
        k=None if top[1] < 0 else int(top[1]),
        response_format="b64" if top[2] == 1 else "json",
    )


def encode_results(results: list[dict]) -> Optional[bytes]:
    """`{"results": [{"ids": [...], "scores": [...]}, ...]}` as bytes, or
    None when a result carries a field besides ids and scores that is not
    None (the documents and compressed payload modes)."""
    offsets = np.empty((len(results) + 1,), np.int64)
    offsets[0] = 0
    for i, r in enumerate(results):
        if not isinstance(r, dict) or any(
            f not in ("ids", "scores") and r[f] is not None for f in r
        ):
            return None
        ids, scores = r.get("ids"), r.get("scores")
        if ids is None or scores is None or len(ids) != len(scores):
            return None
        offsets[i + 1] = offsets[i] + len(ids)
    total = int(offsets[-1])
    ids_flat = np.empty((total,), np.int64)
    scores_flat = np.empty((total,), np.float32)
    for i, r in enumerate(results):
        ids_flat[offsets[i]:offsets[i + 1]] = r["ids"]
        scores_flat[offsets[i]:offsets[i + 1]] = r["scores"]
    lib = load_lib()
    # an id takes at most 20 characters and a comma, a score 16 and a comma
    cap = 64 + len(results) * 40 + total * 40
    out = ctypes.create_string_buffer(cap)
    n = lib.fj_encode_results(
        ids_flat.ctypes.data_as(_I64P), scores_flat.ctypes.data_as(_F32P),
        offsets.ctypes.data_as(_I64P), len(results), out, cap,
    )
    if n < 0:
        return None
    return out.raw[:n]
