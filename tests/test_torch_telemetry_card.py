"""Telemetry on the card: a device trace names the CUDA kernels launched
from another thread while it runs, and the device-memory gauge reads the
bytes allocated on each card. Imports no jax; needs a CUDA card (skipped
without one):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_telemetry_card.py
"""

import json
import threading
import uuid

import pytest
import torch

from rag_inference_pipeline_tpu_torch.telemetry import metrics as tm
from rag_inference_pipeline_tpu_torch.telemetry.profiling import DeviceTraceCapture


@pytest.mark.cuda
def test_device_trace_names_kernels_of_another_thread(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cap = DeviceTraceCapture(str(tmp_path))
    cap.start()

    def work():
        a = torch.randn(512, 512, device="cuda")
        for _ in range(4):
            a = torch.relu(a @ a)
        torch.cuda.synchronize()

    th = threading.Thread(target=work)
    th.start()
    th.join()
    with open(cap.stop()) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert len(kernels) >= 8, kernels[:10]
    assert any("gemm" in k.lower() or "cutlass" in k.lower() for k in kernels), kernels[:10]


@pytest.mark.cuda
def test_device_trace_names_the_kernels_of_a_graph_replay(tmp_path):
    """A CUDA graph replayed on another thread: its kernels carry the
    correlation id of the cudaGraphLaunch call (how chip_smoke.py finds a
    decode step's kernels in a node's trace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(256, 256, device="cuda")
    out = torch.empty_like(a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(torch.relu(a @ a))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(torch.relu(a @ a))
    cap = DeviceTraceCapture(str(tmp_path))
    cap.start()
    th = threading.Thread(target=lambda: (graph.replay(), torch.cuda.synchronize()))
    th.start()
    th.join()
    with open(cap.stop()) as f:
        events = json.load(f)["traceEvents"]
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("name") == "cudaGraphLaunch"}
    replayed = [e["name"] for e in events if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in launches]
    assert launches and len(replayed) >= 2, replayed


@pytest.mark.cuda
def test_device_memory_gauge_reads_the_allocation():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run_id = f"card-{uuid.uuid4().hex}"
    held = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    tm.update_resource_gauges(run_id, "0")
    for i in range(torch.cuda.device_count()):
        got = tm.DEVICE_MEMORY.labels(run_id, "0", str(i)).value
        assert got == torch.cuda.memory_allocated(i)
    assert tm.DEVICE_MEMORY.labels(run_id, "0", str(held.device.index)).value >= 64 * 2**20
    assert tm.MEMORY_RSS.labels(run_id, "0").value > 0
