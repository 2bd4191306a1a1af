"""The port's telemetry, registry, executors and settings against the JAX
package's: the 16 Prometheus metrics (name, type, help, label names,
buckets) and their text rendering, sample for sample; the sampled stage
profiler and its log line; the device trace on the CPU; tracing off; the
component registry's call order and errors; the named thread pools; the
seven telemetry settings.

The reference renders through `prometheus_client`, which this machine has
(the port never imports it). A metric's `_created` sample is the time its
series was made, so those values are compared by presence, not value.
"""

import asyncio
import json
import logging
import os
import re
import threading
import uuid

import prometheus_client
import pytest
import torch
from prometheus_client import CollectorRegistry, generate_latest
from prometheus_client.parser import text_string_to_metric_families

from rag_inference_pipeline_tpu.core import registry as jregistry
from rag_inference_pipeline_tpu.core.config import load_settings as j_load_settings
from rag_inference_pipeline_tpu.telemetry import metrics as jm
from rag_inference_pipeline_tpu.telemetry import profiling as jprof
from rag_inference_pipeline_tpu.telemetry import tracing as jtracing
from rag_inference_pipeline_tpu.utils import executors as jexec
from rag_inference_pipeline_tpu_torch.core import registry as tregistry
from rag_inference_pipeline_tpu_torch.core.config import Settings, load_settings
from rag_inference_pipeline_tpu_torch.telemetry import metrics as tm
from rag_inference_pipeline_tpu_torch.telemetry import profiling as tprof
from rag_inference_pipeline_tpu_torch.telemetry import tracing as ttracing
from rag_inference_pipeline_tpu_torch.utils import executors as texec

METRICS = [
    "REQUESTS_TOTAL", "REQUEST_LATENCY", "STAGE_DURATION", "BATCH_SIZE",
    "BATCH_FLUSH", "BATCH_WAIT", "QUEUE_DEPTH", "CACHE_EVENTS", "RPC_DURATION",
    "ERRORS_TOTAL", "COMPRESSION_RATIO", "MEMORY_RSS", "DEVICE_MEMORY",
    "TOKENS_GENERATED", "ENGINE_LANES_ACTIVE", "ENGINE_SEGMENTS",
]
_CREATED = re.compile(r"^(\S+_created(?:\{.*\})?) \S+$", re.M)


def _run(coro):
    """A coroutine on a loop of its own (asyncio.run would leave the main
    thread's policy without a loop for later files on this worker)."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_sixteen_metrics():
    port_names = [m.name for m in tm.REGISTRY.metrics()]
    assert len(METRICS) == 16 and len(set(port_names)) == len(port_names)
    for name in METRICS:
        assert getattr(tm, name).name in port_names


@pytest.mark.parametrize("name", METRICS)
def test_metric_matches_reference(name):
    """Name, type, help, label names and buckets of the reference's
    collector, read from prometheus_client's default registry."""
    ref, port = getattr(jm, name), getattr(tm, name)
    ref_name = ref._name + ("_total" if ref._type == "counter" else "")
    assert prometheus_client.REGISTRY._names_to_collectors[ref_name] is ref
    assert port.name == ref_name
    assert port.type == ref._type
    assert port.documentation == ref._documentation
    assert port.labelnames == tuple(ref._labelnames)
    if ref._type == "histogram":
        assert port.upper_bounds == tuple(ref._upper_bounds)
    else:
        assert not hasattr(port, "upper_bounds")


def _observe_all(mod, run_id: str) -> None:
    """The same observations through either package's metrics."""
    mod.REQUESTS_TOTAL.labels(run_id, "0", "gateway", "ok").inc()
    mod.REQUESTS_TOTAL.labels(run_id, "0", "gateway", "cache_hit").inc(2)
    mod.REQUEST_LATENCY.labels(run_id, "0", "gateway").observe(0.3)
    for stage, v in (("embed", 0.0009), ("search", 0.001), ("llm", 31.0), ("llm", 2.5)):
        mod.STAGE_DURATION.labels(run_id, "1", "retrieval", stage).observe(v)
    for n in (1, 3, 8, 300):
        mod.BATCH_SIZE.labels(run_id, "0", "gateway").observe(n)
    mod.BATCH_FLUSH.labels(run_id, "0", "gateway", "timeout").inc()
    mod.BATCH_WAIT.labels(run_id, "0", "gateway").observe(0.004)
    mod.QUEUE_DEPTH.labels(run_id, "0", "gateway").set(5)
    mod.QUEUE_DEPTH.labels(run_id, "0", "gateway").set(0)
    mod.CACHE_EVENTS.labels(run_id, "0", "query", "miss").inc()
    mod.RPC_DURATION.labels(run_id, "0", "retrieval").observe(0.05)
    mod.ERRORS_TOTAL.labels(run_id, "0", "http", "ValueError").inc()
    mod.COMPRESSION_RATIO.labels(run_id, "0", "in").observe(4.2)
    mod.MEMORY_RSS.labels(run_id, "0").set(123456789)
    mod.DEVICE_MEMORY.labels(run_id, "0", "0").set(2.5e10)
    mod.TOKENS_GENERATED.labels(run_id, "2").inc(128)
    mod.ENGINE_LANES_ACTIVE.labels(run_id, "2").set(3)
    mod.ENGINE_SEGMENTS.labels(run_id, "2").inc()


def _samples(text: str, run_id: str) -> list:
    out = []
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.labels.get("run_id") == run_id:
                value = None if s.name.endswith("_created") else s.value
                out.append((fam.name, fam.type, s.name, tuple(sorted(s.labels.items())), value))
    return sorted(out, key=repr)


def test_rendering_matches_reference_sample_for_sample():
    """Under a run_id of this test alone, both default registries give the
    same parsed samples."""
    run_id = f'parity "{uuid.uuid4().hex}"\\'
    _observe_all(jm, run_id)
    _observe_all(tm, run_id)
    ref = _samples(generate_latest(prometheus_client.REGISTRY).decode(), run_id)
    got = _samples(tm.render_metrics().decode(), run_id)
    assert len(ref) > 60 and got == ref


def test_rendering_matches_reference_text():
    """The same 16 definitions in fresh registries, the same observations:
    the text is the reference's line for line (creation times aside)."""
    jreg = CollectorRegistry()
    treg = tm.Registry()
    jns, tns = {}, {}
    for name in METRICS:
        ref = getattr(jm, name)
        kw = {"buckets": ref._upper_bounds} if ref._type == "histogram" else {}
        ref_name = ref._name + ("_total" if ref._type == "counter" else "")
        jns[name] = jm.get_metric(type(ref), ref_name, ref._documentation,
                                  ref._labelnames, registry=jreg, **kw)
        tcls = {"counter": tm.Counter, "gauge": tm.Gauge, "histogram": tm.Histogram}
        tns[name] = tm.get_metric(tcls[ref._type], ref_name, ref._documentation,
                                  ref._labelnames, registry=treg, **kw)
        assert tm.get_metric(tcls[ref._type], ref_name, "again", registry=treg) is tns[name]

    class NS:
        def __init__(self, d):
            self.__dict__.update(d)

    _observe_all(NS(jns), "r\n1")
    _observe_all(NS(tns), "r\n1")
    want = _CREATED.sub(r"\1 T", generate_latest(jreg).decode())
    got = _CREATED.sub(r"\1 T", treg.render().decode())
    assert got == want


def test_go_float_matches_prometheus_client():
    from prometheus_client.utils import floatToGoString

    for v in (0.0, 1, 2.5, -3.25, 1e-7, 123456.0, 1234567.0, 1.7e9, 25.0,
              float("inf"), float("-inf"), float("nan"), 0.1 + 0.2):
        assert tm.go_float(v) == floatToGoString(v)


def test_resource_gauges_on_the_cpu(monkeypatch):
    import psutil
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_id = f"res-{uuid.uuid4().hex}"
    tm.update_resource_gauges(run_id, "0")
    rss = tm.MEMORY_RSS.labels(run_id, "0").value
    assert abs(rss - psutil.Process(os.getpid()).memory_info().rss) < 64 * 2**20
    text = tm.render_metrics().decode()
    assert not any(s[2] == "pipeline_device_memory_bytes" for s in _samples(text, run_id))


class _S:
    def __init__(self, **kw):
        self.__dict__.update(dict(enable_profiling=True, profiling_sample_rate=1.0,
                                  run_id="dev", node_number=1), **kw)


def _profile_line(mod, caplog, settings):
    prof = mod.SampledStageProfiler(settings, "retrieval").maybe_start()
    with caplog.at_level(logging.INFO, logger=mod.__name__):
        caplog.clear()
        with prof.track("embed"):
            pass
        with prof.track("search"):
            pass
        prof.finish()
    lines = [r.getMessage() for r in caplog.records if r.name == mod.__name__]
    return prof, lines


@pytest.mark.parametrize("enabled,rate,sampled", [
    (True, 1.0, True), (True, 0.0, False), (False, 1.0, False)])
def test_sampled_stage_profiler_matches_reference(caplog, enabled, rate, sampled):
    run_id = f"prof-{uuid.uuid4().hex}"
    settings = _S(enable_profiling=enabled, profiling_sample_rate=rate, run_id=run_id)
    (jp, jlines), (tp, tlines) = (_profile_line(m, caplog, settings) for m in (jprof, tprof))
    assert (type(jp).__name__, type(tp).__name__) == (
        ("_ActiveProfile",) * 2 if sampled else ("_NullProfile",) * 2)
    assert len(jlines) == len(tlines) == int(sampled)
    ref = _samples(generate_latest(prometheus_client.REGISTRY).decode(), run_id)
    got = _samples(tm.render_metrics().decode(), run_id)
    assert bool(got) == bool(ref) == sampled
    if sampled:
        j, t = (json.loads(line.split("profile_summary ", 1)[1]) for line in (jlines[0], tlines[0]))
        assert set(t) == set(j) == {"service", "total_ms", "stages"}
        assert t["service"] == j["service"] == "retrieval"
        assert [s["stage"] for s in t["stages"]] == [s["stage"] for s in j["stages"]]
        assert all(set(s) == {"stage", "duration_ms", "rss_delta_mb"} for s in t["stages"])
        counts = [s for s in got if s[2].endswith("_count")]
        assert [s[:4] for s in counts] == [s[:4] for s in ref if s[2].endswith("_count")]
        assert [s[4] for s in counts] == [1.0, 1.0]


def test_resource_snapshot_keys():
    snap = tprof.get_resource_snapshot()
    assert set(snap) == {"ts", "rss_mb", "vms_mb"}
    assert snap["rss_mb"] > 0 and snap["vms_mb"] >= snap["rss_mb"]


def test_device_trace_on_the_cpu(tmp_path):
    """A trace of ops run on another thread is written where `stop` says;
    a double start and a stop with none running fail."""
    cap = tprof.DeviceTraceCapture(str(tmp_path / "traces"))
    with pytest.raises(RuntimeError, match="no device trace"):
        cap.stop()
    assert cap.start() == str(tmp_path / "traces")
    with pytest.raises(RuntimeError, match="already running"):
        cap.start()

    def work():
        a = torch.randn(32, 32)
        (a @ a).sum()

    th = threading.Thread(target=work)
    th.start()
    th.join()
    path = cap.stop()
    assert not cap.active and os.path.dirname(path) == str(tmp_path / "traces")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with pytest.raises(RuntimeError):
        cap.stop()
    assert cap.start() and cap.stop() != path  # a second trace, a new file


def test_span_is_a_no_op_when_tracing_is_off():
    for mod in (jtracing, ttracing):
        assert mod.setup_tracing(Settings()) is False
        with mod.span("stage", service="x") as s:
            assert s is None


class _Recorder:
    def __init__(self, name, log, fail=None):
        self.name, self.log, self.fail = name, log, fail

    def load(self):
        self.log.append(("load", self.name))

    def unload(self):
        self.log.append(("unload", self.name))
        if self.fail == "unload":
            raise RuntimeError("unload failed")

    async def start(self):
        self.log.append(("start", self.name))

    async def stop(self):
        self.log.append(("stop", self.name))
        if self.fail == "stop":
            raise RuntimeError("stop failed")

    @property
    def is_loaded(self):
        return self.name != "c"


class _SyncOnly:
    is_loaded = False


def _drive(mod):
    log = []
    reg = mod.ComponentRegistry()
    reg.register("a", _Recorder("a", log))
    reg.register("b", _Recorder("b", log, fail="stop"), load=False)
    reg.register("c", _Recorder("c", log, fail="unload"))
    reg.register("d", _SyncOnly())
    errors = []
    for call in (lambda: reg.register("a", object()), lambda: reg.alias("b", "a"),
                 lambda: reg.alias("x", "nope")):
        with pytest.raises(Exception) as e:
            call()
        errors.append((type(e.value), str(e.value)))
    reg.alias("first", "a")
    with pytest.raises(ValueError):
        reg.alias("first", "c")
    _run(reg.start_all())
    _run(reg.stop_all())
    reg.unload_all()
    view = (reg.names, reg.health(), "first" in reg, reg.get("first").name,
            reg.get_optional("nope"), mod.Component().is_loaded)
    return log, errors, view


def test_registry_matches_reference():
    assert _drive(tregistry) == _drive(jregistry)
    log, errors, view = _drive(tregistry)
    assert log[:2] == [("load", "a"), ("load", "c")]
    assert [e[0] for e in errors] == [ValueError, ValueError, KeyError]
    assert view[1] == {"a": True, "b": True, "c": False, "d": False}


def test_named_executors_match_reference():
    for mod in (jexec, texec):
        pool = mod.get_executor("parity-test", 2)
        assert mod.get_executor("parity-test") is pool and pool._max_workers == 2
        assert _run(mod.run_cpu_bound("parity-test", sum, [1, 2, 3])) == 6
        mod.shutdown_all()
        assert mod.get_executor("parity-test") is not pool
        mod.shutdown_all()


@pytest.mark.parametrize("env", [
    {},
    {"ENABLE_TRACING": "1", "OTLP_ENDPOINT": "http://collector:4317",
     "ENABLE_PROFILING": "yes", "PROFILING_SAMPLE_RATE": "0.5",
     "ENABLE_METRICS": "0", "WARMUP_BUCKETS": "1", "RUN_ID": "sweep-7"},
    {"ENABLE_PROFILING": "off", "PROFILING_SAMPLE_RATE": "1e-1",
     "WARMUP_BUCKETS": "off", "ENABLE_METRICS": "true"},
    {"WARMUP_BUCKETS": "T"}, {"WARMUP_BUCKETS": "n"}, {"WARMUP_BUCKETS": "On"},
])
def test_telemetry_settings_match_reference(env):
    fields = ("enable_tracing", "otlp_endpoint", "enable_profiling",
              "profiling_sample_rate", "enable_metrics", "warmup_buckets", "run_id")
    j, t = j_load_settings(env), load_settings(env)
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]


@pytest.mark.parametrize("bad", ["", "2", " 1", "maybe"])
def test_warmup_tri_state_refuses_what_the_reference_refuses(bad):
    with pytest.raises(Exception):
        j_load_settings({"WARMUP_BUCKETS": bad})
    with pytest.raises(ValueError, match="not a boolean"):
        load_settings({"WARMUP_BUCKETS": bad})
