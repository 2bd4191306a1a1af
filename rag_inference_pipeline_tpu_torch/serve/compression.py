"""Payload compression for the hops between nodes.

Port of `rag_inference_pipeline_tpu/serve/compression.py` with the same
wire: a body is compressed with zstd only at `min_bytes` or more and kept
compressed only when it shrinks; `decompress` sniffs the zstd magic and
passes anything else through; the `compressed` payload mode carries
documents as base64 of zstd of their JSON (`pack_docs` / `unpack_docs`).
Without its Prometheus ratio histogram.

`zstandard` is imported inside the functions: the GPU machine does not
guarantee it. A node whose settings ask for zstd checks for it at start
(`require_codec`) and refuses to start without it; nothing falls back to
uncompressed bodies quietly.
"""

from __future__ import annotations

import base64
import json
import threading

from ..core.enums import PayloadMode

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

# zstd contexts are not safe for concurrent use (the C context mutates with
# the GIL released): handler and executor threads both compress, so each
# thread keeps its own
_tls = threading.local()


def _compressor(level: int):
    cache = getattr(_tls, "compressors", None)
    if cache is None:
        cache = _tls.compressors = {}
    if level not in cache:
        import zstandard

        cache[level] = zstandard.ZstdCompressor(level=level)
    return cache[level]


def _decompressor():
    d = getattr(_tls, "decompressor", None)
    if d is None:
        import zstandard

        d = _tls.decompressor = zstandard.ZstdDecompressor()
    return d


def compress(data: bytes, *, level: int = 3, min_bytes: int = 512) -> tuple[bytes, bool]:
    """Compress if worthwhile. Returns (payload, was_compressed)."""
    if len(data) < min_bytes:
        return data, False
    out = _compressor(level).compress(data)
    if len(out) >= len(data):
        return data, False
    return out, True


def decompress(data: bytes) -> bytes:
    """Sniff the zstd magic and decompress when present."""
    if data[:4] == ZSTD_MAGIC:
        return _decompressor().decompress(data)
    return data


def pack_docs(docs: list[dict], *, level: int = 3) -> str:
    """Documents -> b64(zstd(json)) for the `compressed` payload mode."""
    blob = _compressor(level).compress(json.dumps(docs).encode())
    return base64.b64encode(blob).decode()


def unpack_docs(b64: str) -> list[dict]:
    return json.loads(_decompressor().decompress(base64.b64decode(b64)))


def require_codec(settings) -> None:
    """Refuse to start a node whose settings ask for zstd
    (COMPRESSION_ALGORITHM=zstd, the default, or
    DOCUMENTS_PAYLOAD_MODE=compressed) when `zstandard` does not import."""
    wants = []
    if settings.compression_algorithm == "zstd":
        wants.append("COMPRESSION_ALGORITHM=zstd")
    if settings.documents_payload_mode is PayloadMode.COMPRESSED:
        wants.append("DOCUMENTS_PAYLOAD_MODE=compressed")
    if not wants:
        return
    try:
        import zstandard  # noqa: F401
    except ImportError:
        raise RuntimeError(
            f"{' and '.join(wants)} needs the zstandard package, which does not "
            "import here: set COMPRESSION_ALGORITHM=none (and a "
            "DOCUMENTS_PAYLOAD_MODE other than compressed) on every node"
        ) from None
