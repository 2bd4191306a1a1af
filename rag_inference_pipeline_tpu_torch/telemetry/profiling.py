"""Sampled per-stage profiles, resource snapshots and device traces.

Port of `rag_inference_pipeline_tpu/telemetry/profiling.py:23-135`:

- `SampledStageProfiler.maybe_start()` draws the per-request sampling
  decision (`random.random() < PROFILING_SAMPLE_RATE` when
  ENABLE_PROFILING is set); a sampled profile's `track(stage)` records the
  stage's duration and RSS delta, observes it in `STAGE_DURATION`, and
  `finish()` logs one `profile_summary {json}` line of
  `{service, total_ms, stages}`; an unsampled one does nothing.
- `get_resource_snapshot()` reads the RSS and virtual size from
  `/proc/self/statm` (the reference asks psutil, which the GPU machine does
  not guarantee). The reference's `cpu_percent` is left out: it asks a
  fresh `psutil.Process` each time, which answers 0.0 every time.
- `DeviceTraceCapture` takes a `torch.profiler` trace where the reference
  takes a `jax.profiler` one: CPU activities and, with CUDA, the device's.
  `stop()` writes a Chrome trace into `log_dir` and returns its path.

A host clock around asynchronous CUDA work times the launch, not the work:
a track ends where the code it wraps reads a result back to the host, or
its docstring says that it times a launch.

The profiler runs on a thread of its own, because PyTorch's profiler must
be stopped on the thread that started it and the HTTP server answers
`/profile/start` and `/profile/stop` on whichever threads it has. It
records the host ops of every thread where the installed PyTorch offers
`profile_all_threads` (of the starting thread only elsewhere); the CUDA
kernels of every thread come from CUPTI, which traces the whole process.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import tempfile
import threading
import time
from typing import Optional

from .metrics import process_memory

logger = logging.getLogger(__name__)

def get_resource_snapshot() -> dict:
    """RSS and virtual size in MB, with the time."""
    out: dict = {"ts": time.time()}
    mem = process_memory()
    if mem is not None:
        out["rss_mb"] = mem[0] / 1e6
        out["vms_mb"] = mem[1] / 1e6
    return out


class _NullProfile:
    @contextlib.contextmanager
    def track(self, stage: str):  # noqa: ARG002
        yield

    def finish(self) -> None:
        pass


NULL_PROFILE = _NullProfile()


class _ActiveProfile:
    def __init__(self, service: str, metric_labels: Optional[tuple] = None) -> None:
        self.service = service
        self.metric_labels = metric_labels
        self.stages: list[dict] = []
        self._t0 = time.monotonic()

    @contextlib.contextmanager
    def track(self, stage: str):
        start = time.monotonic()
        rss0 = get_resource_snapshot().get("rss_mb", 0.0)
        try:
            yield
        finally:
            dur = time.monotonic() - start
            self.stages.append({
                "stage": stage,
                "duration_ms": dur * 1e3,
                "rss_delta_mb": get_resource_snapshot().get("rss_mb", 0.0) - rss0,
            })
            if self.metric_labels is not None:
                from .metrics import STAGE_DURATION

                STAGE_DURATION.labels(*self.metric_labels, stage).observe(dur)

    def finish(self) -> None:
        logger.info("profile_summary %s", json.dumps({
            "service": self.service,
            "total_ms": (time.monotonic() - self._t0) * 1e3,
            "stages": self.stages,
        }))


class SampledStageProfiler:
    """maybe_start() -> a profile; it records nothing unless sampled."""

    def __init__(self, settings, service: str) -> None:
        self.enabled = settings.enable_profiling
        self.rate = settings.profiling_sample_rate
        self.service = service
        self._labels = (settings.run_id, str(settings.node_number), service)

    def maybe_start(self):
        if self.enabled and random.random() < self.rate:
            return _ActiveProfile(self.service, self._labels)
        return NULL_PROFILE


def default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "ragtorch_traces")


class DeviceTraceCapture:
    """On-demand `torch.profiler` trace of the whole process: `start()`
    returns `log_dir`; `stop()` writes `trace_<pid>_<ns>.json` (Chrome
    trace format) there and returns its path. A second `start()`, or a
    `stop()` with no trace running, raises RuntimeError."""

    def __init__(self, log_dir: Optional[str] = None) -> None:
        self.log_dir = log_dir or default_trace_dir()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._result: dict = {}

    @property
    def active(self) -> bool:
        return self._thread is not None

    def start(self) -> str:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("a device trace is already running")
            os.makedirs(self.log_dir, exist_ok=True)
            started = threading.Event()
            self._stop.clear()
            self._result = {}
            self._thread = threading.Thread(
                target=self._run, args=(started,), name="device-trace", daemon=True)
            self._thread.start()
            started.wait()
            if "error" in self._result:
                self._thread.join()
                self._thread = None
                raise RuntimeError(f"device trace failed to start: {self._result['error']}")
            return self.log_dir

    def stop(self) -> str:
        with self._lock:
            if self._thread is None:
                raise RuntimeError("no device trace is running")
            self._stop.set()
            self._thread.join()
            self._thread = None
            if "error" in self._result:
                raise RuntimeError(f"device trace failed: {self._result['error']}")
            return self._result["path"]

    def _run(self, started: threading.Event) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            try:
                from torch._C._profiler import _ExperimentalConfig

                prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            except (ImportError, TypeError):  # a PyTorch without the option
                prof = profile(activities=acts)
            prof.start()
        except Exception as exc:  # noqa: BLE001 — reported by start()
            self._result["error"] = repr(exc)
            started.set()
            return
        started.set()
        self._stop.wait()
        try:
            prof.stop()
            path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            self._result["path"] = path
        except Exception as exc:  # noqa: BLE001 — reported by stop()
            self._result["error"] = repr(exc)
