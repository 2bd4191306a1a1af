"""CUDA graphs for the decode loops.

The JAX package compiles each decode loop into one device program:
`greedy_generate`'s `lax.scan`, `ngram_speculative_generate`'s
`lax.while_loop`, and the decode engine's two segment programs. PyTorch
runs eagerly, and one eager decode step of a 24-layer decoder is some 700
small launches issued from Python. The port's counterpart of the jitted
loop is a `torch.cuda.CUDAGraph`: the loop body is captured once per
static key and replayed.

A body captured here keeps four rules, so that a replay computes what an
eager call of the same body computes:

- carried state lives in tensors allocated before the capture and is
  updated in place (`copy_`, `add_`, `index_copy_`, `scatter_`), never
  rebound to a new tensor: a replay reads and writes the captured
  addresses;
- nothing inside syncs the host (no `.item()`, `.cpu()`, `tolist`);
- a loop position is a device tensor (the greedy loop's output column),
  never a Python int, which the capture would bake in;
- lookup tables (the rope tables) are built before the capture: the
  warm-up call builds them.

On the CPU nothing is captured and callers run the same bodies eagerly;
so does a loop whose tp shards or dp positions span distinct cards
(`uses_graphs`). On CUDA a capture that fails raises; there is no eager
fallback and no setting that turns the graphs off (the eager functions
keep their own names for the tools that compare the two).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Hashable

import torch


def uses_graphs(devices) -> bool:
    """Whether a decode loop whose work runs on `devices` (a device, or the
    devices of a tp-sharded tree) replays captured graphs: when it all runs
    on one CUDA device, so one graph holds every shard's kernels. On the
    CPU never; nor when a tp group or a dp mesh spans distinct cards, where
    one graph cannot hold the step and it runs eagerly (a deliberate
    difference: the reference compiles one program over the mesh)."""
    devs = {torch.device(d) for d in
            ((devices,) if isinstance(devices, (str, torch.device)) else devices)}
    return len(devs) == 1 and next(iter(devs)).type == "cuda"


class HostFlag:
    """A device bool read on the host between replays: a non-blocking copy
    into pinned memory, then a wait on an event recorded after it (on the
    CPU, a plain copy)."""

    def __init__(self, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self.host = torch.zeros((), dtype=torch.bool, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def read(self, flag: torch.Tensor) -> bool:
        self.host.copy_(flag, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()
            self.event.synchronize()
        return bool(self.host)


class CapturedGraph:
    """One captured body: `replay()` runs it again on the current stream.
    `pool` (a `torch.cuda.graph_pool_handle()`) lets graphs share one
    memory pool for their intermediates, which is safe while their replays
    are serialised. `pool_bytes` is the memory the capture added to its
    pool; `capture_s` the host seconds of warm-up and capture."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 pool=None) -> None:
        t0 = time.perf_counter()
        # warm up on a side stream: cuBLAS handles and workspaces, the
        # allocator's blocks and the rope tables exist before the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        # the capture empties the allocator's cache first; so does this, so
        # that the difference below is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: work that other threads run meanwhile (the
            # staged server's retrieval, the encoders) neither breaks the
            # capture nor is refused by it
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                body()
        except Exception as exc:
            raise RuntimeError(f"decode graph capture failed: {exc}") from exc
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()


class GraphCache:
    """Captured graphs by static key, each kept with the state it was
    captured over. One cache belongs to one parameter tree (the graphs
    read its weights' addresses); `lock` serialises the calls that use
    its state, so its graphs share one memory pool (`pool()`): the f32
    head product alone takes ~0.6 GB of intermediates at Qwen2.5-0.5B
    width, once for all keys instead of once a key."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self._entries: dict[Hashable, object] = {}
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key: Hashable, build: Callable[[], object]):
        """The entry for `key`, built by `build()` on first use."""
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = build()
        return entry

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> list:
        """The entries in the order they were built."""
        return list(self._entries.values())

    @property
    def pool_bytes(self) -> int:
        return sum(e.graph.pool_bytes for e in self.entries())

    @property
    def capture_s(self) -> float:
        return sum(e.graph.capture_s for e in self.entries())


def graphs_of(params: torch.nn.Module) -> GraphCache:
    """The graph cache of a parameter tree, made on first use and kept on
    the tree, so that it lives exactly as long as the weights the graphs
    read."""
    return params.__dict__.setdefault("_decode_graphs", GraphCache())
