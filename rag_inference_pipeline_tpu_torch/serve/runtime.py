"""Serving entry point: `python -m rag_inference_pipeline_tpu_torch.serve.runtime`.

A stdlib `ThreadingHTTPServer` over the fused executor, built from
`Settings` (environment variables). It serves:

- `POST /query` `{"query": "...", "request_id"?: "..."}` ->
  `{request_id, generated_response, sentiment, is_toxic}`, the reference's
  QueryResponse keys;
- `GET /health` -> the loaded components, whether their weights are random,
  and the launch count of each hand-written kernel.

Device work is serialized by one lock: each request runs as its own batch.
The aiohttp stack, role profiles, the batcher and the stage-by-stage path
of the JAX package are not ported yet, so the server refuses to start
unless USE_FUSED_PIPELINE=1, with an embedder, a flat index at INDEX_PATH
and DOC_TOKENS_PATH.
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..core.config import Settings, load_settings
from ..core.device import resolve_device
from ..engine.fused_executor import FusedExecutor
from ..index.base import load_index
from ..models.components import (
    EmbedderComponent,
    LLMComponent,
    SentimentComponent,
    ToxicityComponent,
)
from ..ops.topk import binmax_partial_topk_int8gs

logger = logging.getLogger(__name__)


def build_executor(settings: Settings) -> FusedExecutor:
    """Load every component named by `settings` and the fused executor."""
    if not settings.use_fused_pipeline:
        raise ValueError("the port serves the fused pipeline only: set USE_FUSED_PIPELINE=1")
    if settings.index_dtype != "int8":
        raise ValueError("the port's fused pipeline scans an int8 index: set INDEX_DTYPE=int8")
    if not settings.index_path:
        raise ValueError("the fused pipeline needs a flat index at INDEX_PATH")
    if not settings.doc_tokens_path:
        raise ValueError("the fused pipeline needs DOC_TOKENS_PATH")
    device = resolve_device(settings.device_platform)
    embedder = EmbedderComponent(settings, device)
    llm = LLMComponent(settings, device)
    sentiment = SentimentComponent(settings, device)
    toxicity = ToxicityComponent(settings, device)
    for comp in (embedder, llm, sentiment, toxicity):
        comp.load()
    index = load_index(settings.index_path, device)
    if index.dim != embedder.dim:
        raise ValueError(
            f"index dim {index.dim} != embedder width {embedder.dim}"
        )
    ex = FusedExecutor(
        settings, device=device, embedder=embedder, index=index, llm=llm,
        sentiment=sentiment, toxicity=toxicity,
    )
    ex.load()
    return ex


class _Handler(BaseHTTPRequestHandler):
    server: "RAGServer"

    def log_message(self, fmt, *args):  # route the access log to logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path != "/health":
            self._send(404, {"error": f"no route {self.path}"})
            return
        self._send(200, self.server.health())

    def do_POST(self):
        if self.path != "/query":
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            query = req.get("query") if isinstance(req, dict) else None
            if not isinstance(query, str) or not query.strip():
                raise ValueError("query must be a non-empty string")
            request_id = str(req.get("request_id") or uuid.uuid4().hex)
        except ValueError as e:  # bad JSON is a ValueError too
            self._send(400, {"error": str(e), "error_type": "validation"})
            return
        try:
            out = self.server.query(query)
        except Exception as e:  # noqa: BLE001 — the server keeps serving
            logger.exception("query failed")
            self._send(500, {"error": str(e), "error_type": "internal"})
            return
        self._send(200, {"request_id": request_id, **out})


class RAGServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, executor: FusedExecutor, host: str, port: int):
        super().__init__((host, port), _Handler)
        self.executor = executor
        self._device_lock = threading.Lock()

    def query(self, query: str) -> dict:
        with self._device_lock:
            return self.executor.process_batch([{"query": query}])[0]

    def health(self) -> dict:
        ex = self.executor
        comps = {
            "embedder": ex.embedder, "llm": ex.llm, "index": ex.index,
            "sentiment": ex.sentiment, "toxicity": ex.toxicity,
            "fused_executor": ex,
        }
        return {
            "status": "ok",
            "device": str(ex.device),
            "components": {
                k: bool(c is not None and c.is_loaded) for k, c in comps.items()
            },
            "random_weights": [
                k for k, c in comps.items() if getattr(c, "random_weights", False)
            ],
            "kernel_launches": {
                "binmax_int8gs": binmax_partial_topk_int8gs.launches,
            },
        }


def make_server(settings: Settings, port: Optional[int] = None) -> RAGServer:
    """Build the executor and bind the server; `port` overrides
    BASE_PORT + NODE_NUMBER (0 picks a free port)."""
    return RAGServer(
        build_executor(settings), settings.listen_host,
        settings.listen_port if port is None else port,
    )


def main() -> None:
    settings = load_settings()
    logging.basicConfig(
        level=getattr(logging, settings.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    server = make_server(settings)
    logger.info(
        "listening on %s:%d (%s)", *server.server_address[:2],
        torch.cuda.get_device_name(0) if server.executor.device.type == "cuda"
        else "cpu",
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
