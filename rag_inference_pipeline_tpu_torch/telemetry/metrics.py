"""Prometheus metrics, shared across the pipeline, on a registry of the
port's own.

Port of `rag_inference_pipeline_tpu/telemetry/metrics.py:49-115`: the same
16 metrics with the same names, types, help texts, label names and
histogram buckets, registered idempotently (`get_metric`, reference
`:31-46`), and `render_metrics()` in the Prometheus text exposition format
0.0.4 as `prometheus_client.generate_latest` writes it: a `# HELP` and a
`# TYPE` line per family, labels sorted by name, a counter `x_total` as
`x_total` and its creation time under the gauge `x_created`, a histogram's
cumulative `_bucket{le=...}` up to `+Inf`, then `_count`, `_sum` and, in a
gauge family of its own, `_created`; numbers as Go prints them.

`prometheus_client` is not imported: the GPU machine does not guarantee
it. Nor is `psutil`: `update_resource_gauges` reads the RSS from
`/proc/self/statm`, and the device memory from
`torch.cuda.memory_allocated` (the counterpart of JAX's `bytes_in_use`)
for each visible device; without CUDA there is no device sample.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Iterable, Optional

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_LAT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0,
)
_INF = float("inf")


def go_float(d: float) -> str:
    """A number as the exposition format writes it (Go's formatting:
    `+Inf`, `NaN`, exponents from 1e+06 up)."""
    d = float(d)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _line(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {go_float(value)}\n"
    return f"{name} {go_float(value)}\n"


class _Child:
    """One labelled series of a metric."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.created = time.time()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _Metric:
    type = ""

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: Optional["Registry"] = None) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        (REGISTRY if registry is None else registry).register(self)

    def labels(self, *values) -> _Child:
        """The child for these label values (created on first use)."""
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(self.labelnames)} label values expected")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _new_child(self) -> _Child:
        return _Child()

    def _series(self) -> list[tuple[dict[str, str], _Child]]:
        with self._lock:
            return [(dict(zip(self.labelnames, k)), c) for k, c in self._children.items()]

    def render(self) -> str:
        raise NotImplementedError


class Counter(_Metric):
    type = "counter"

    @property
    def family(self) -> str:
        return self.name[: -len("_total")] if self.name.endswith("_total") else self.name

    def render(self) -> str:
        doc = _escape_help(self.documentation)
        fam = self.family
        out = [f"# HELP {fam}_total {doc}\n", f"# TYPE {fam}_total counter\n"]
        created = []
        for labels, c in self._series():
            out.append(_line(f"{fam}_total", labels, c.value))
            created.append(_line(f"{fam}_created", labels, c.created))
        if created:
            out += [f"# HELP {fam}_created {doc}\n", f"# TYPE {fam}_created gauge\n", *created]
        return "".join(out)


class Gauge(_Metric):
    type = "gauge"

    def render(self) -> str:
        out = [f"# HELP {self.name} {_escape_help(self.documentation)}\n",
               f"# TYPE {self.name} gauge\n"]
        out += [_line(self.name, labels, c.value) for labels, c in self._series()]
        return "".join(out)


class _HistogramChild(_Child):
    def __init__(self, bounds: tuple[float, ...]) -> None:
        super().__init__()
        self._bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.sum += value
            for i, b in enumerate(self._bounds):
                if value <= b:
                    self.counts[i] += 1
                    break


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: Optional["Registry"] = None, *,
                 buckets: Iterable[float]) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("buckets not in sorted order")
        if not bounds or bounds[-1] != _INF:
            bounds.append(_INF)
        self.upper_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.upper_bounds)

    def render(self) -> str:
        doc = _escape_help(self.documentation)
        out = [f"# HELP {self.name} {doc}\n", f"# TYPE {self.name} histogram\n"]
        created = []
        for labels, c in self._series():
            with c._lock:
                counts, total, when = list(c.counts), c.sum, c.created
            acc = 0.0
            for b, n in zip(self.upper_bounds, counts):
                acc += n
                out.append(_line(f"{self.name}_bucket", {**labels, "le": go_float(b)}, acc))
            out.append(_line(f"{self.name}_count", labels, acc))
            out.append(_line(f"{self.name}_sum", labels, total))
            created.append(_line(f"{self.name}_created", labels, when))
        if created:
            out += [f"# HELP {self.name}_created {doc}\n",
                    f"# TYPE {self.name}_created gauge\n", *created]
        return "".join(out)


class Registry:
    """Metrics by name, in the order they were registered."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicated timeseries in Registry: {metric.name}")
            self._metrics[metric.name] = metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> bytes:
        return "".join(m.render() for m in self.metrics()).encode("utf-8")


REGISTRY = Registry()


def get_metric(cls, name: str, doc: str, labels: Iterable[str] = (),
               registry: Optional[Registry] = None, **kwargs):
    """Create-or-return a metric: a second registration of a name is a
    lookup."""
    registry = REGISTRY if registry is None else registry
    return registry.get(name) or cls(name, doc, list(labels), registry=registry, **kwargs)


REQUESTS_TOTAL = get_metric(
    Counter, "pipeline_requests_total", "Requests by service and status",
    ["run_id", "node", "service", "status"],
)
REQUEST_LATENCY = get_metric(
    Histogram, "pipeline_request_latency_seconds", "End-to-end request latency",
    ["run_id", "node", "service"], buckets=_LAT_BUCKETS,
)
STAGE_DURATION = get_metric(
    Histogram, "pipeline_stage_duration_seconds", "Per-stage duration",
    ["run_id", "node", "service", "stage"], buckets=_LAT_BUCKETS,
)
BATCH_SIZE = get_metric(
    Histogram, "pipeline_batch_size", "Processed batch sizes",
    ["run_id", "node", "service"],
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)
BATCH_FLUSH = get_metric(
    Counter, "pipeline_batch_flush_total", "Batch flushes by reason",
    ["run_id", "node", "service", "reason"],
)
BATCH_WAIT = get_metric(
    Histogram, "pipeline_batch_wait_seconds",
    "First-enqueue-to-flush wait per batch (the queueing share of p50)",
    ["run_id", "node", "service"], buckets=_LAT_BUCKETS,
)
QUEUE_DEPTH = get_metric(
    Gauge, "pipeline_queue_depth", "Scheduler queue depth",
    ["run_id", "node", "service"],
)
CACHE_EVENTS = get_metric(
    Counter, "pipeline_cache_events_total", "Cache hits/misses/evictions",
    ["run_id", "node", "cache", "event"],
)
RPC_DURATION = get_metric(
    Histogram, "pipeline_rpc_duration_seconds", "Inter-node RPC duration",
    ["run_id", "node", "target"], buckets=_LAT_BUCKETS,
)
ERRORS_TOTAL = get_metric(
    Counter, "pipeline_errors_total", "Errors by type",
    ["run_id", "node", "service", "error_type"],
)
COMPRESSION_RATIO = get_metric(
    Histogram, "pipeline_compression_ratio", "Payload compression ratio",
    ["run_id", "node", "direction"],
    buckets=(1.0, 1.5, 2.0, 3.0, 5.0, 10.0, 25.0),
)
MEMORY_RSS = get_metric(
    Gauge, "pipeline_memory_rss_bytes", "Process RSS", ["run_id", "node"],
)
DEVICE_MEMORY = get_metric(
    Gauge, "pipeline_device_memory_bytes", "Per-device HBM in use",
    ["run_id", "node", "device"],
)
TOKENS_GENERATED = get_metric(
    Counter, "pipeline_tokens_generated_total", "LLM tokens emitted",
    ["run_id", "node"],
)
ENGINE_LANES_ACTIVE = get_metric(
    Gauge, "pipeline_engine_lanes_active",
    "Continuous-batching decode lanes currently holding a request",
    ["run_id", "node"],
)
ENGINE_SEGMENTS = get_metric(
    Counter, "pipeline_engine_segments_total",
    "Decode-engine segments dispatched", ["run_id", "node"],
)


def render_metrics() -> bytes:
    return REGISTRY.render()


def process_memory() -> Optional[tuple[int, int]]:
    """(RSS, virtual size) of this process in bytes from
    `/proc/self/statm`; None where there is no such file."""
    try:
        with open("/proc/self/statm", "rb") as f:
            size, resident = f.read().split()[:2]
    except OSError:
        return None
    page = os.sysconf("SC_PAGE_SIZE")
    return int(resident) * page, int(size) * page


def update_resource_gauges(run_id: str, node: str) -> None:
    """The process's RSS and each visible CUDA device's allocated bytes."""
    mem = process_memory()
    if mem is not None:
        MEMORY_RSS.labels(run_id, node).set(mem[0])
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            DEVICE_MEMORY.labels(run_id, node, str(i)).set(torch.cuda.memory_allocated(i))
