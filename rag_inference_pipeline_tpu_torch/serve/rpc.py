"""RPC client for the hops between nodes (gateway -> retrieval ->
generation), on the standard library.

Port of `rag_inference_pipeline_tpu/serve/rpc.py:30-123`: JSON bodies,
compressed with zstd when COMPRESSION_ALGORITHM=zstd and worthwhile
(`X-Ragtpu-Encoding: zstd`); responses sniffed for the zstd magic;
`rpc_retries` attempts, each failed one followed by a sleep of
`rpc_backoff_base_s * 2**attempt`; a 5xx, a timeout or a connection error
is retried, a 4xx never; the error taxonomy `RPCError` >
`RPCTimeoutError`, `RPCServiceError` (with the status).

One difference from the reference: a node asks for zstd replies
(`X-Ragtpu-Accept-Encoding`) only when it compresses itself. A node set to
COMPRESSION_ALGORITHM=none may lack `zstandard`, so it must not be sent
zstd bodies.

Each attempt that gets a reply is timed into `RPC_DURATION` by the peer's
role (`target`), as the reference times it (`rpc.py:85`).

Connections: a pool of keep-alive `http.client.HTTPConnection`s per peer,
at most `http_max_connections` in use at once. Every request runs on the
event loop's default executor, never on the loop itself. An idle
connection whose socket turned readable (the peer closed it) is dropped
before reuse.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import select
import threading
import time
import urllib.parse
from typing import Optional

from ..core.config import Settings
from ..telemetry.metrics import RPC_DURATION
from .compression import compress, decompress

ENCODING_HEADER = "X-Ragtpu-Encoding"
ACCEPT_HEADER = "X-Ragtpu-Accept-Encoding"


class RPCError(Exception):
    pass


class RPCTimeoutError(RPCError):
    pass


class RPCServiceError(RPCError):
    def __init__(self, status: int, detail: str) -> None:
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status


def _reusable(conn: http.client.HTTPConnection) -> bool:
    """An idle keep-alive connection with nothing to read: a readable
    socket means the peer closed it (or sent bytes nobody asked for)."""
    if conn.sock is None:
        return False
    readable, _, _ = select.select([conn.sock], [], [], 0)
    return not readable


class _Pool:
    """Idle keep-alive connections to one peer."""

    def __init__(self, host: str, port: int, timeout_s: float) -> None:
        self.host, self.port, self.timeout_s = host, port, timeout_s
        self._idle: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        self._closed = False

    def _take(self) -> http.client.HTTPConnection:
        with self._lock:
            while self._idle:
                conn = self._idle.pop()
                if _reusable(conn):
                    return conn
                conn.close()
        return http.client.HTTPConnection(self.host, self.port, timeout=self.timeout_s)

    def _give(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(conn)
                return
        conn.close()

    def request(
        self, method: str, path: str, body: Optional[bytes], headers: dict
    ) -> tuple[int, bytes]:
        """One blocking round trip: (status, body bytes)."""
        conn = self._take()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except BaseException:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            self._give(conn)
        return resp.status, data

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class RPCClient:
    def __init__(self, settings: Settings) -> None:
        self.settings = settings
        self._pools: dict[tuple[str, int], _Pool] = {}
        self._slots: dict[tuple[str, int], asyncio.Semaphore] = {}
        self._lock = threading.Lock()

    async def _roundtrip(
        self, method: str, url: str, body: Optional[bytes], headers: dict
    ) -> tuple[int, bytes]:
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"RPC url must be http://host:port/...: {url!r}")
        key = (u.hostname, u.port or 80)
        with self._lock:
            pool = self._pools.get(key)
            if pool is None:
                pool = self._pools[key] = _Pool(*key, self.settings.request_timeout_s)
                self._slots[key] = asyncio.Semaphore(self.settings.http_max_connections)
            slot = self._slots[key]
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        async with slot:
            return await asyncio.get_running_loop().run_in_executor(
                None, pool.request, method, path, body, headers
            )

    async def post(self, url: str, payload: dict, *, target: str = "peer") -> dict:
        """POST `payload` as JSON; the decoded JSON reply. `target` names
        the peer's role (the reference labels its latency metric with it)."""
        s = self.settings
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if s.compression_algorithm == "zstd":
            headers[ACCEPT_HEADER] = "zstd"
            body, was = compress(
                body, level=s.compression_level, min_bytes=s.compression_min_bytes,
                run_id=s.run_id, node=str(s.node_number), direction="out",
            )
            if was:
                headers[ENCODING_HEADER] = "zstd"
        last_exc: Optional[RPCError] = None
        m_dur = RPC_DURATION.labels(s.run_id, str(s.node_number), target)
        for attempt in range(s.rpc_retries):
            try:
                t0 = time.monotonic()
                status, data = await self._roundtrip("POST", url, body, headers)
                m_dur.observe(time.monotonic() - t0)
                if 200 <= status < 300:
                    return json.loads(decompress(data))
                detail = decompress(data)[:500].decode(errors="replace")
                if 400 <= status < 500:
                    raise RPCServiceError(status, detail)  # never retried
                last_exc = RPCServiceError(status, detail)
            except TimeoutError as exc:
                last_exc = RPCTimeoutError(f"{target}: {exc or 'timed out'}")
            except (OSError, http.client.HTTPException) as exc:
                last_exc = RPCError(f"connect: {target}: {exc!r}")
            await asyncio.sleep(s.rpc_backoff_base_s * (2**attempt))
        raise last_exc if last_exc else RPCError("rpc failed")

    async def get(self, url: str) -> dict:
        """GET a JSON reply (one attempt)."""
        try:
            status, data = await self._roundtrip("GET", url, None, {})
        except TimeoutError as exc:
            raise RPCTimeoutError(str(exc) or "timed out") from exc
        except (OSError, http.client.HTTPException) as exc:
            raise RPCError(f"connect: {exc!r}") from exc
        if status != 200:
            raise RPCServiceError(status, data[:200].decode(errors="replace"))
        return json.loads(data)

    async def clear_cache(self, base_url: str) -> bool:
        """Clear a peer's caches; False when the peer could not be reached."""
        try:
            await self.post(f"{base_url}/clear_cache", {}, target="clear_cache")
            return True
        except RPCError:
            return False

    async def close(self) -> None:
        with self._lock:
            pools, self._pools = list(self._pools.values()), {}
            self._slots = {}
        for pool in pools:
            pool.close()
