"""Document store: id -> {id, title, content} with batch fetch,
truncation and an LRU cache.

Port of `rag_inference_pipeline_tpu/utils/docstore.py` with its three
backends:

- `native` (the default): the repo's C++ store, `native/docstore.cc` (one
  immutable file, an mmap'd arena and an open-addressing hash of the ids),
  built by `utils/native.py` and read through ctypes. The file format is
  the reference's, so either package reads the other's stores.
  `doc_store_in_memory` maps it with MAP_POPULATE;
- `sqlite`: stdlib sqlite3 over the reference's schema
  `documents(id, title, content)`, one connection per thread (or one
  shared in-memory clone with `doc_store_in_memory`);
- `memory`: a dict, for tests.
"""

from __future__ import annotations

import ctypes
import logging
import sqlite3
import threading
from typing import Optional, Sequence

import numpy as np

from . import native
from .cache import LRUCache

logger = logging.getLogger(__name__)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _load_native_lib() -> ctypes.CDLL:
    """The built doc store library with its argtypes. The string arguments
    and results are declared void*: they are raw bytes with lengths, not
    NUL-terminated strings, and are read by length."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = native.load("docstore")
        vp = ctypes.c_void_p
        vpp, i32p = ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_int32)
        lib.ds_build.restype = ctypes.c_int
        # path, ids, title ptrs, title lens, content ptrs, content lens, n
        # (numpy buffers, passed by address)
        lib.ds_build.argtypes = [ctypes.c_char_p, vp, vp, vp, vp, vp, ctypes.c_int64]
        lib.ds_open.restype = vp
        lib.ds_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ds_close.argtypes = [vp]
        lib.ds_count.restype = ctypes.c_int64
        lib.ds_count.argtypes = [vp]
        lib.ds_get_batch.restype = ctypes.c_int64
        lib.ds_get_batch.argtypes = [
            vp, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, vpp, i32p, vpp, i32p,
        ]
        _lib = lib
        return lib


def _packed(strings: list[bytes]) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One buffer holding every string, with each one's offset and length."""
    lens = np.fromiter((len(b) for b in strings), np.int64, len(strings))
    offs = np.zeros(len(strings), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    return b"".join(strings), offs, lens


def build_native_store(path: str, docs: Sequence[tuple[int, str, str]]) -> None:
    """Write a native store file from (id, title, content) rows, the texts
    as UTF-8. Raises on a duplicate id."""
    lib = _load_native_lib()
    docs = list(docs)
    n = len(docs)
    ids = np.fromiter((d[0] for d in docs), np.int64, n)
    t_buf, t_off, t_len = _packed([d[1].encode() for d in docs])
    c_buf, c_off, c_len = _packed([d[2].encode() for d in docs])
    for lens in (t_len, c_len):
        if n and lens.max() >= 2**31:
            raise ValueError("a title or content of 2 GiB or more")
    # per-row pointers into the two buffers (kept alive until ds_build returns)
    t_mem = ctypes.create_string_buffer(t_buf, len(t_buf) + 1)
    c_mem = ctypes.create_string_buffer(c_buf, len(c_buf) + 1)
    t_ptr = (ctypes.addressof(t_mem) + t_off).astype(np.uint64)
    c_ptr = (ctypes.addressof(c_mem) + c_off).astype(np.uint64)
    t_len32 = t_len.astype(np.int32)
    c_len32 = c_len.astype(np.int32)
    rc = lib.ds_build(
        path.encode(), ids.ctypes.data, t_ptr.ctypes.data, t_len32.ctypes.data,
        c_ptr.ctypes.data, c_len32.ctypes.data, n,
    )
    if rc != 0:
        raise RuntimeError(
            f"ds_build({path!r}) failed with code {rc}"
            + (" (duplicate id)" if rc == -2 else "")
        )


class _NativeBackend:
    def __init__(self, path: str, populate: bool) -> None:
        self.lib = _load_native_lib()
        self.handle = self.lib.ds_open(path.encode(), 1 if populate else 0)
        if not self.handle:
            raise FileNotFoundError(f"cannot open native doc store at {path}")

    def count(self) -> int:
        return int(self.lib.ds_count(self.handle))

    def get_batch(self, ids: Sequence[int]) -> list[Optional[dict]]:
        n = len(ids)
        c_ids = (ctypes.c_int64 * n)(*ids)
        titles = (ctypes.c_void_p * n)()
        contents = (ctypes.c_void_p * n)()
        t_lens = (ctypes.c_int32 * n)()
        c_lens = (ctypes.c_int32 * n)()
        self.lib.ds_get_batch(self.handle, c_ids, n, titles, t_lens, contents, c_lens)
        out: list[Optional[dict]] = []
        for i in range(n):
            if t_lens[i] < 0:
                out.append(None)
                continue
            # by length: the arena holds no NUL between texts
            t = ctypes.string_at(titles[i], t_lens[i]).decode() if t_lens[i] else ""
            c = ctypes.string_at(contents[i], c_lens[i]).decode() if c_lens[i] else ""
            out.append({"id": int(ids[i]), "title": t, "content": c})
        return out

    def close(self) -> None:
        if self.handle:
            self.lib.ds_close(self.handle)
            self.handle = None


class _SqliteBackend:
    def __init__(self, path: str, in_memory: bool) -> None:
        self.path = path
        self._local = threading.local()
        self._memory_conn: Optional[sqlite3.Connection] = None
        if in_memory:
            # a private in-memory clone shared by the threads of this store
            src = sqlite3.connect(path)
            self._memory_conn = sqlite3.connect(":memory:", check_same_thread=False)
            src.backup(self._memory_conn)
            src.close()
            self._memory_lock = threading.Lock()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            self._local.conn = conn
        return conn

    def _query(self, sql: str, args: Sequence = ()) -> list:
        if self._memory_conn is not None:
            with self._memory_lock:
                return self._memory_conn.execute(sql, list(args)).fetchall()
        return self._conn().execute(sql, list(args)).fetchall()

    def count(self) -> int:
        return self._query("SELECT COUNT(*) FROM documents")[0][0]

    def get_batch(self, ids: Sequence[int]) -> list[Optional[dict]]:
        qmarks = ",".join("?" * len(ids))
        rows = self._query(
            f"SELECT id, title, content FROM documents WHERE id IN ({qmarks})", ids
        )
        by_id = {r[0]: {"id": r[0], "title": r[1], "content": r[2]} for r in rows}
        return [by_id.get(i) for i in ids]

    def close(self) -> None:
        if self._memory_conn is not None:
            self._memory_conn.close()


class _MemoryBackend:
    def __init__(self, docs: dict[int, dict]) -> None:
        self.docs = docs

    def count(self) -> int:
        return len(self.docs)

    def get_batch(self, ids: Sequence[int]) -> list[Optional[dict]]:
        return [self.docs.get(i) for i in ids]

    def close(self) -> None:
        pass


def build_sqlite_store(path: str, docs) -> None:
    """Write (id, title, content) rows in the reference's schema."""
    conn = sqlite3.connect(path)
    try:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS documents "
            "(id INTEGER PRIMARY KEY, title TEXT, content TEXT)"
        )
        conn.executemany("INSERT OR REPLACE INTO documents VALUES (?,?,?)", docs)
        conn.commit()
    finally:
        conn.close()


class DocumentStore:
    """The component the services use (the reference's DocumentStore)."""

    def __init__(self, settings, *, docs: Optional[dict[int, dict]] = None) -> None:
        self.settings = settings
        self._docs_override = docs
        self._backend = None
        self.cache = LRUCache(
            settings.document_cache_capacity, ttl_s=settings.document_cache_ttl_s,
            name="document", run_id=settings.run_id, node=str(settings.node_number),
        )

    @property
    def is_loaded(self) -> bool:
        return self._backend is not None

    def load(self) -> None:
        s = self.settings
        backend = s.doc_store_backend
        if self._docs_override is not None or backend == "memory":
            self._backend = _MemoryBackend(self._docs_override or {})
        elif backend == "sqlite":
            if not s.document_db_path:
                raise ValueError("document_db_path required for the sqlite doc store")
            self._backend = _SqliteBackend(s.document_db_path, s.doc_store_in_memory)
        elif backend == "native":
            if not s.document_db_path:
                raise ValueError("document_db_path required for the native doc store")
            self._backend = _NativeBackend(s.document_db_path, s.doc_store_in_memory)
        else:
            raise ValueError(f"unknown doc_store_backend {backend!r}")
        logger.info(
            "doc store loaded: backend=%s count=%d",
            "memory" if self._docs_override is not None else backend,
            self._backend.count(),
        )

    def unload(self) -> None:
        if self._backend is not None:
            self._backend.close()
            self._backend = None
        self.cache.clear()

    def fetch_documents_batch(
        self, ids: Sequence[int], *, truncate_length: Optional[int] = None
    ) -> list[dict]:
        """Batch fetch with truncation; a missing id gives the stub doc
        {id, title "doc_<id>", content ""} (reference `docstore.py:265-295`)."""
        if not self.is_loaded:
            raise RuntimeError("document store not loaded")
        tl = truncate_length or self.settings.truncate_length
        out: list[Optional[dict]] = [None] * len(ids)
        misses, miss_pos = [], []
        for pos, i in enumerate(ids):
            hit = self.cache.get(int(i))
            if hit is not None:
                out[pos] = hit
            else:
                misses.append(int(i))
                miss_pos.append(pos)
        if misses:
            fetched = self._backend.get_batch(misses)
            for pos, doc, i in zip(miss_pos, fetched, misses):
                if doc is None:
                    doc = {"id": i, "title": f"doc_{i}", "content": ""}
                else:
                    self.cache.put(i, doc)
                out[pos] = doc
        return [{**d, "content": d["content"][:tl]} for d in out]
