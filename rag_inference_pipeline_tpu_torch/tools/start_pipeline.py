"""Start a multi-node deployment of the port on one machine.

    TOTAL_NODES=3 BASE_PORT=8000 [other settings] \\
        python -m rag_inference_pipeline_tpu_torch.tools.start_pipeline \\
        [--timeout 600] [--log-dir DIR]

The port's counterpart of the repo's `start_pipeline.sh` (which starts the
JAX package): one `python -m rag_inference_pipeline_tpu_torch.serve.runtime`
process per node, NODE_NUMBER 0 .. TOTAL_NODES-1 (TOTAL_NODES 3 when
unset), each with the environment of this process; every other setting
(NODE_{0,1,2}_IP, the profiles, INDEX_PATH, DOCUMENT_DB_PATH, ...) comes
from it too. Waits until each node's `/health` answers 200, within
`--timeout` seconds, then runs until SIGINT or SIGTERM, or until any node
exits, and stops them all (SIGTERM, then SIGKILL after a grace period).
Exits 0 when every node stopped cleanly on the signal, 1 otherwise.
`--log-dir` writes each node's output to `node<N>.log` there.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional

from ..core.config import Settings, load_settings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENTRY = "rag_inference_pipeline_tpu_torch.serve.runtime"


@dataclass
class Node:
    number: int
    proc: subprocess.Popen
    log_path: Optional[str] = None

    def log_tail(self, nbytes: int = 4000) -> str:
        """The end of the node's output (when it goes to a log file)."""
        if self.log_path is None or not os.path.exists(self.log_path):
            return ""
        with open(self.log_path, "rb") as fh:
            fh.seek(max(0, os.path.getsize(self.log_path) - nbytes))
            return fh.read().decode(errors="replace")


def start_nodes(
    total_nodes: int, env: Optional[dict] = None, log_dir: Optional[str] = None
) -> list[Node]:
    """One serving process per node, with this process's environment
    updated by `env`, NODE_NUMBER and TOTAL_NODES."""
    nodes = []
    for n in range(total_nodes):
        node_env = {**os.environ, **(env or {}),
                    "NODE_NUMBER": str(n), "TOTAL_NODES": str(total_nodes)}
        log_path = None
        out = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(log_dir, f"node{n}.log")
            out = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", ENTRY], cwd=ROOT, env=node_env,
                stdout=out, stderr=subprocess.STDOUT if out else None,
            )
        except BaseException:
            stop_nodes(nodes, 10.0)
            raise
        finally:
            if out is not None:
                out.close()  # the child holds its own descriptor
        nodes.append(Node(n, proc, log_path))
    return nodes


def wait_healthy(settings: Settings, nodes: list[Node], timeout_s: float) -> None:
    """Until each node's `/health` answers 200; raises RuntimeError when a
    node exits first, TimeoutError past `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    for node in nodes:
        url = f"{settings.node_url(node.number)}/health"
        while True:
            if node.proc.poll() is not None:
                raise RuntimeError(
                    f"node {node.number} exited with {node.proc.returncode} "
                    f"before it was healthy:\n{node.log_tail()}"
                )
            try:
                with urllib.request.urlopen(url, timeout=2.0) as r:
                    if r.status == 200:
                        break
            except (urllib.error.URLError, OSError):
                pass  # not listening yet, or not loaded (503)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"node {node.number} not healthy at {url} within "
                    f"{timeout_s:.0f} s:\n{node.log_tail()}"
                )
            time.sleep(0.5)


def stop_nodes(nodes: list[Node], timeout_s: float) -> list[Optional[int]]:
    """SIGTERM every node still running, wait up to `timeout_s` in all,
    SIGKILL any left; each node's exit code (negative: the signal that
    ended it)."""
    for node in nodes:
        if node.proc.poll() is None:
            node.proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout_s
    for node in nodes:
        try:
            node.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            node.proc.kill()
            node.proc.wait()
    return [node.proc.returncode for node in nodes]


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds to wait for every node's /health")
    ap.add_argument("--log-dir", default=None,
                    help="write each node's output to <dir>/node<N>.log")
    args = ap.parse_args(argv)
    env = {"TOTAL_NODES": os.environ.get("TOTAL_NODES", "3")}
    settings = load_settings(env)
    stop = []

    def on_signal(signum, frame):  # noqa: ARG001
        stop.append(signum)

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    nodes = start_nodes(settings.total_nodes, env, args.log_dir)
    died = False
    try:
        wait_healthy(settings, nodes, args.timeout)
        for node in nodes:
            print(f"node {node.number} healthy at {settings.node_url(node.number)}",
                  flush=True)
        print("pipeline up: SIGINT or SIGTERM stops it", flush=True)
        while not stop:
            if any(node.proc.poll() is not None for node in nodes):
                died = True
                break
            time.sleep(0.5)
    except (RuntimeError, TimeoutError) as exc:
        print(exc, file=sys.stderr, flush=True)
        died = True
    finally:
        codes = stop_nodes(nodes, 60.0)
    for node, code in zip(nodes, codes):
        if code != 0:
            print(f"node {node.number} exited with {code}", file=sys.stderr, flush=True)
    return 1 if died or any(c != 0 for c in codes) else 0


if __name__ == "__main__":
    sys.exit(main())
