"""Measurement helpers for the port's tools (`tools/bench_kernel.py`,
`tools/bench_decode_anatomy.py`): port of `rag_inference_pipeline_tpu.bench`."""

from .protocol import (  # noqa: F401
    measure_rtt,
    time_fetch,
    time_inprogram,
    time_pipelined,
)
