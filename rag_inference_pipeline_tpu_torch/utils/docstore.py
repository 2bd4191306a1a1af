"""Document store: id -> {id, title, content} with batch fetch,
truncation and an LRU cache.

Port of `rag_inference_pipeline_tpu/utils/docstore.py` with two backends:

- `sqlite`: stdlib sqlite3 over the reference's schema
  `documents(id, title, content)`, one connection per thread (or one
  shared in-memory clone with `doc_store_in_memory`);
- `memory`: a dict, for tests.

The reference's `native` backend (a C++ arena built with `make -C native`
at first use) is refused by name: it is not ported, and nothing in the
port runs that build.
"""

from __future__ import annotations

import logging
import sqlite3
import threading
from typing import Optional, Sequence

from .cache import LRUCache

logger = logging.getLogger(__name__)


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
            settings.document_cache_capacity, ttl_s=settings.document_cache_ttl_s
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
            raise NotImplementedError(
                "DOC_STORE_BACKEND='native' (the C++ arena store) is not "
                "ported yet (ROADMAP.md, Queue 1): use 'sqlite' or 'memory'"
            )
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
