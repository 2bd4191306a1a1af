"""Thread-safe LRU cache with an optional TTL.

Port of `rag_inference_pipeline_tpu/utils/cache.py::LRUCache` without its
Prometheus counters. The reference's document cache is the zstd
`CompressedLRUCache`; zstandard is not guaranteed on the GPU machine and
the cache changes no output, so the port's document cache is this one.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional


class LRUCache:
    def __init__(self, capacity: int, *, ttl_s: Optional[float] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._data: OrderedDict[Any, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key) -> Optional[Any]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                return None
            ts, value = item
            if self.ttl_s is not None and time.monotonic() - ts > self.ttl_s:
                del self._data[key]
                return None
            self._data.move_to_end(key)
            return value

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = (time.monotonic(), value)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
