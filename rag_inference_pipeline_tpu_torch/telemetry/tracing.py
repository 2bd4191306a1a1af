"""OpenTelemetry tracing, off by default.

Port of `rag_inference_pipeline_tpu/telemetry/tracing.py:20-64`:
`setup_tracing(settings)` installs a global TracerProvider with an OTLP
gRPC exporter to OTLP_ENDPOINT when ENABLE_TRACING is set and the
OpenTelemetry SDK imports (it is imported only here: the GPU machine does
not guarantee it); `span(name, **attrs)` is a no-op context manager
otherwise, so call sites never branch.
"""

from __future__ import annotations

import contextlib
import logging

logger = logging.getLogger(__name__)

_tracer = None


def setup_tracing(settings) -> bool:
    """Install the tracer provider; whether tracing is on."""
    global _tracer
    if not settings.enable_tracing:
        return False
    try:
        from opentelemetry import trace
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor

        provider = TracerProvider(resource=Resource.create({
            "service.name": f"ragtorch-node{settings.node_number}",
            "service.version": "0.1.0",
            "run.id": settings.run_id,
        }))
        provider.add_span_processor(
            BatchSpanProcessor(OTLPSpanExporter(endpoint=settings.otlp_endpoint))
        )
        trace.set_tracer_provider(provider)
        _tracer = trace.get_tracer("ragtorch")
        logger.info("tracing enabled -> %s", settings.otlp_endpoint)
        return True
    except Exception:  # noqa: BLE001 — a missing exporter must not stop serving
        logger.exception("tracing setup failed; continuing without")
        return False


@contextlib.contextmanager
def span(name: str, **attrs):
    """A span named `name` with `attrs`; nothing when tracing is off."""
    if _tracer is None:
        yield None
        return
    with _tracer.start_as_current_span(name) as s:
        for k, v in attrs.items():
            s.set_attribute(k, v)
        yield s
