"""SPMD serving on the CPU: two processes in one gloo group on localhost, the
counterparts of `tests/test_dcn_serving.py`.

Each process runs the serving entry point (`serve/runtime.py::main`) with
DIST_NUM_PROCESSES=2 and loads its half of a small int8 flat index;
process 0 serves `/retrieve`, process 1 runs `worker_loop`. The served
ids must equal one in-process sharded search over a mesh of 2 positions
(the `dp_global` merge), and a front door that cannot bind must stop its
worker. Every spawned process checks at exit that it never imported jax.
"""

import json
import os
import random
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.core.distributed import init_distributed
from rag_inference_pipeline_tpu_torch.core.mesh import force_host_devices, make_mesh
from rag_inference_pipeline_tpu_torch.index.base import load_index
from rag_inference_pipeline_tpu_torch.index.flat import FlatIndex
from rag_inference_pipeline_tpu_torch.serve.spmd import is_front_door, is_spmd
from rag_inference_pipeline_tpu_torch.utils.docstore import build_sqlite_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, N_ROWS, K = 64, 12000, 5  # the parts: rows [0, 8192) and [8192, 12000)
TIMEOUT_S = 100  # each test's own limit on its processes

# the entry point, then a check that nothing imported jax (exit code 3)
_ENTRY = (
    "import sys\n"
    "from rag_inference_pipeline_tpu_torch.serve import runtime\n"
    "runtime.main()\n"
    "sys.exit(3 if 'jax' in sys.modules or any(m.split('.')[0] == "
    "'rag_inference_pipeline_tpu' for m in sys.modules) else 0)\n"
)


def _free_port() -> int:
    for _ in range(100):
        port = random.randrange(20000, 60000)
        with socket.socket() as s:
            try:
                s.bind(("0.0.0.0", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx = FlatIndex(DIM, dtype="int8", nbins=512, device="cpu")
    idx.add(x)
    path = str(tmp / "flat.npz")
    idx.save(path)
    build_sqlite_store(str(tmp / "documents.db"),
                       [(i, f"title {i}", f"body {i}") for i in range(N_ROWS)])
    return path, str(tmp / "documents.db"), x


def _env(path, db, rank, coord, port):
    return {
        **os.environ,
        "DEVICE_PLATFORM": "cpu", "DIST_NUM_PROCESSES": "2", "DIST_PROCESS_ID": str(rank),
        "DIST_COORDINATOR": f"127.0.0.1:{coord}", "BASE_PORT": str(port),
        "PIPELINE_ROLE_PROFILE": "retrieval_default", "INDEX_KIND": "flat",
        "INDEX_DTYPE": "int8", "INDEX_PATH": path, "INDEX_DIM": str(DIM), "INDEX_PQ_M": "16",
        "EMBEDDING_MODEL": "tiny-embed", "MODEL_WEIGHTS_DIR": "",
        "DOC_STORE_BACKEND": "sqlite", "DOCUMENT_DB_PATH": db,
        "DOCUMENTS_PAYLOAD_MODE": "id_only", "RETRIEVAL_K": str(K),
        "BATCH_SHAPE_BUCKETS": "1,2,4,8", "WARMUP_BUCKETS": "0",
        "COMPRESSION_ALGORITHM": "none", "OMP_NUM_THREADS": "1",
    }


def _start(path, db, port, logs):
    """Processes 0 and 1, each logging to `logs / rank{r}.log`."""
    coord = _free_port()
    procs = []
    for r in (0, 1):
        with open(logs / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _ENTRY], cwd=ROOT, env=_env(path, db, r, coord, port),
                stdout=log, stderr=subprocess.STDOUT,
            ))
    return procs


def _log(logs, r):
    return (logs / f"rank{r}.log").read_text()[-3000:]


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)


def _wait_health(port, procs, deadline, logs):
    while time.monotonic() < deadline:
        for r, p in enumerate(procs):
            if p.poll() is not None:
                pytest.fail(f"process {r} exited {p.returncode}: {_log(logs, r)}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                if r.status == 200:
                    return json.loads(r.read())
        except OSError:
            time.sleep(0.25)
    pytest.fail("the front door did not come up")


def test_single_process_is_no_spmd():
    """One process: no group is joined, every process is its front door."""
    assert init_distributed(Settings()) is False
    assert not is_spmd() and is_front_door()


def test_two_process_retrieve_matches_the_dp_global_search(corpus, tmp_path):
    """A /retrieve through the front door: each process searches its half
    (K1's plain version, the bf16 re-score), the [B, k] parts gather over
    gloo and merge in rank order; the ids equal one sharded search over a
    2-position mesh of the whole artifact. SIGINT on the front door stops
    the worker through OP_STOP; both exit 0 with no jax imported."""
    path, db, x = corpus
    rng = np.random.default_rng(9)
    q = x[rng.choice(N_ROWS, 4, replace=False)] + 0.05 * rng.standard_normal((4, DIM))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    port = _free_port()
    procs = _start(path, db, port, tmp_path)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        health = _wait_health(port, procs, deadline, tmp_path)
        assert health["components"]["index"] and health["components"]["mesh"]
        body = json.dumps({"items": [{"embedding": row.tolist()} for row in q]}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/retrieve", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            served = [res["ids"] for res in json.loads(r.read())["results"]]
        procs[0].send_signal(2)  # SIGINT: the server closes, OP_STOP goes out
        for r, p in enumerate(procs):
            assert p.wait(timeout=max(1.0, deadline - time.monotonic())) == 0, _log(tmp_path, r)
        # the worker ran the one broadcast search and logs its launch counts
        # (none on the CPU: the plain versions run)
        worker = _log(tmp_path, 1)
        assert "stopping after 1 searches" in worker
        assert '"binmax_int8gs": 0' in worker.split("SPMD worker kernel launches")[1]
    finally:
        _reap(procs)
    mesh = make_mesh(dp=2, devices=force_host_devices(2))
    ref = load_index(path, mesh=mesh)
    _, ids = ref.search(q, K)
    assert served == ids.tolist()
    assert {i >= 8192 for r in served for i in r} == {True, False}  # both parts answer


def test_front_door_bind_failure_stops_the_worker(corpus, tmp_path):
    """The front door's port is taken: it fails to bind, sends OP_STOP as
    its app closes and raises; the worker leaves its loop and exits 0, all
    within the test's limit."""
    path, db, _ = corpus
    with socket.socket() as taken:
        taken.bind(("0.0.0.0", 0))
        taken.listen(1)
        port = taken.getsockname()[1]
        procs = _start(path, db, port, tmp_path)
        try:
            rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
            assert rcs[0] not in (0, 3) and "Address already in use" in _log(tmp_path, 0)
            assert rcs[1] == 0, _log(tmp_path, 1)
            assert "stopping after 0 searches" in _log(tmp_path, 1)  # left on OP_STOP
        finally:
            _reap(procs)


def test_spmd_proxy_and_part_load(corpus):
    """The front door's view of a part: `load_part` keeps rank r's rows of
    the padded artifact with the artifact's global scale, `id_offset` lifts
    its ids, and the proxy reports the whole artifact's row count."""
    from rag_inference_pipeline_tpu_torch.index.flat import load_part
    from rag_inference_pipeline_tpu_torch.serve.spmd import SPMDIndexProxy

    path, _, x = corpus
    whole = load_index(path)
    parts = [load_part(path, r, 2) for r in (0, 1)]
    assert [p.id_offset for p in parts] == [0, parts[0]._db_i8.shape[0]]
    assert sum(p.ntotal for p in parts) == N_ROWS
    assert all(p._db_gscale.item() == whole._db_gscale.item() for p in parts)
    for p in parts:
        lo = p.id_offset
        assert torch.equal(p._db_i8[: p.ntotal], whole._db_i8[lo : lo + p.ntotal])
    proxy = SPMDIndexProxy(parts[0])
    assert proxy.ntotal == N_ROWS and proxy.dim == DIM and proxy.is_loaded


def test_bind_failure_raises_the_oserror_and_closes_the_app(corpus, monkeypatch):
    """One process: a taken port raises the bind's OSError out of
    `make_server` (it raised AttributeError from a half-built server
    before), after the app is closed."""
    from rag_inference_pipeline_tpu_torch.core.config import load_settings
    from rag_inference_pipeline_tpu_torch.serve import runtime

    path, db, _ = corpus
    env = {k: v for k, v in _env(path, db, 0, 0, 0).items() if not k.startswith("DIST_")}
    closed = []
    close = runtime.StagedApp.close
    monkeypatch.setattr(runtime.StagedApp, "close", lambda self: (closed.append(1), close(self)))
    with socket.socket() as taken:
        taken.bind(("0.0.0.0", 0))
        taken.listen(1)
        with pytest.raises(OSError, match="in use"):
            runtime.make_server(load_settings(env), port=taken.getsockname()[1])
    assert closed == [1]
