"""Thread-safe LRU cache with an optional TTL.

Port of `rag_inference_pipeline_tpu/utils/cache.py::LRUCache` (reference
`:18-41`), with its hit, miss and eviction counts in `CACHE_EVENTS`
labelled (run_id, node, name). The reference's document cache is the zstd
`CompressedLRUCache`; zstandard is not guaranteed on the GPU machine and
the cache changes no output, so the port's document cache is this one.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from ..telemetry.metrics import CACHE_EVENTS


class LRUCache:
    def __init__(
        self, capacity: int, *, ttl_s: Optional[float] = None, name: str = "cache",
        run_id: str = "dev", node: str = "0",
    ) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._data: OrderedDict[Any, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self._hits = CACHE_EVENTS.labels(run_id, node, name, "hit")
        self._misses = CACHE_EVENTS.labels(run_id, node, name, "miss")
        self._evictions = CACHE_EVENTS.labels(run_id, node, name, "eviction")

    def get(self, key) -> Optional[Any]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                self._misses.inc()
                return None
            ts, value = item
            if self.ttl_s is not None and time.monotonic() - ts > self.ttl_s:
                del self._data[key]
                self._misses.inc()
                return None
            self._data.move_to_end(key)
            self._hits.inc()
            return value

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = (time.monotonic(), value)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self._evictions.inc()

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
