"""Continuous-batching decode engine: persistent lanes, segment decoding,
admission between segments.

Port of `rag_inference_pipeline_tpu/engine/decode_engine.py`:

- a fixed pool of `lanes` decode slots shares one static-shape KV cache
  [L, lanes, S, Hkv, Dh];
- new requests are admitted into free lanes between segments: a bucketed
  prefill of the admitted prompts, whose cache rows, first tokens and flags
  are copied into their lanes. Admission runs eagerly (its shapes vary with
  the admit and prefill buckets), and copies only the real rows: the
  reference scatters its pad rows to an out-of-range lane with
  `mode="drop"`, and the lane ids are host numbers here;
- a segment decodes `segment_steps` tokens for every lane (plain), or runs
  `spec_rounds` verify rounds of n-gram speculation (speculative), into the
  device emission buffer. On CUDA each kind is one CUDA graph, captured over
  the fixed pool when the engine is built (`models/decode_graph.py`): the
  counterpart of the reference's two compiled programs. On the CPU the same
  body runs eagerly;
- finished lanes (eos, length cap, cache end) free up at segment
  boundaries, so a short generation never waits on a long one.

On a mesh (`mesh=`, the reference's `:352-366`) the lane pool follows
`parallel/sharding.py::kv_cache_sharding`: the lanes split over dp, each
position's block on its tp group with its kv heads split over tp, and
each position decodes its lanes with its tree of the weights (a
`models/layers.py::MeshTree`). The lanes' tokens, flags and emission
buffer stay on the first device. The admission prefill runs on dp position
0's tree and its rows are copied into their lanes' blocks.

Pipelined completion (`pipeline_segments`). Segment N+1 is dispatched
before the host reads segment N's flags. The JAX arrays of the reference
are immutable; here the next replay rewrites `done`, `counts` and the
emission buffer in place. So right after each segment, on the same stream,
the engine copies `done`, `counts` and the emission buffer into one of two
slots of pinned host memory (non-blocking) and records an event.
`_process_done`, in an executor thread, waits on that slot's event only,
never on the segment that follows, and reads the lane's tokens from the
slot. A slot is written again two segments later, after its completions
have been processed. Completion detection may lag one segment; the tokens
are exact.

`submit(prompt_ids, max_new_tokens)` returns the generated ids (eos
excluded). The reference's Prometheus series (`ENGINE_LANES_ACTIVE`,
`ENGINE_SEGMENTS`, `TOKENS_GENERATED`, reference `:334-344`, `:575`,
`:605`, `:613`) are kept, and the same figures as integer attributes.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.mesh import MeshContext
from ..models import decode_graph
from ..models.layers import MeshTree, tree_devices
from ..models.qwen import (
    KVCache,
    QwenConfig,
    cache_grid,
    qwen_decode_step,
    qwen_prefill,
    spec_verify_round,
    tree_all_devices,
)
from ..telemetry.metrics import ENGINE_LANES_ACTIVE, ENGINE_SEGMENTS, TOKENS_GENERATED
from ..utils.shapes import pick_bucket

logger = logging.getLogger(__name__)


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`, without waiting for the work queued there
    (a pageable copy would synchronise the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclass
class _Request:
    prompt_ids: np.ndarray  # [P] unpadded
    max_new_tokens: int
    future: asyncio.Future
    lane: int = -1


class _Snapshot:
    """One slot of the completion ring: host copies of `done`, `counts`
    and the emission buffer taken right after a segment (pinned on CUDA),
    and the event that marks them complete."""

    def __init__(self, lanes: int, width: int, device: torch.device) -> None:
        pin = device.type == "cuda"
        self.done = torch.zeros(lanes, dtype=torch.bool, pin_memory=pin)
        self.counts = torch.zeros(lanes, dtype=torch.int32, pin_memory=pin)
        self.emit = torch.zeros(lanes, width, dtype=torch.int32, pin_memory=pin)
        self.event = torch.cuda.Event() if pin else None

    def take(self, done, counts, emit) -> None:
        nb = self.event is not None
        self.done.copy_(done, non_blocking=nb)
        self.counts.copy_(counts, non_blocking=nb)
        self.emit.copy_(emit, non_blocking=nb)
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class DecodeEngine:
    """Async continuous-batching engine over one lane pool."""

    @torch.inference_mode()
    def __init__(
        self,
        params,
        cfg: QwenConfig,
        *,
        lanes: int = 8,
        cache_len: int = 512,
        segment_steps: int = 8,
        eos_token_id: int = 2,
        admit_buckets: tuple[int, ...] = (1, 2, 4, 8),
        prefill_buckets: tuple[int, ...] = (64, 128, 256),
        pipeline_segments: bool = True,
        speculative: bool = False,
        gamma: int = 8,
        spec_rounds: int = 2,
        inject_accept_p: Optional[float] = None,  # benchmark-only
        mesh: Optional[MeshContext] = None,
        run_id: str = "dev",
        node: str = "0",
    ) -> None:
        # the prefill's tree (dp position 0's) and the segments' (every
        # position's, the batch split over dp)
        self._prefill_params = params
        if mesh is not None and mesh.n_devices > 1:
            from ..parallel.sharding import place_params

            groups = place_params(mesh, params, cfg)
            self._prefill_params = groups[0]
            params = MeshTree(groups) if mesh.dp > 1 else groups[0]
        self.params = params
        self.cfg = cfg
        self.lanes = lanes
        self.cache_len = cache_len
        self.segment_steps = segment_steps
        self.eos = eos_token_id
        self.admit_buckets = tuple(b for b in admit_buckets if b <= lanes) or (1,)
        self.prefill_buckets = tuple(prefill_buckets)
        self.pipeline_segments = pipeline_segments
        self.speculative = speculative
        self.gamma = gamma
        self.spec_rounds = spec_rounds
        self.inject_accept_p = inject_accept_p
        self.device = dev = tree_devices(params)[0]
        # the reference's Prometheus series (`decode_engine.py:334-344`),
        # and the same figures as integers for in-process readers
        self.lanes_active = 0
        self.segments = 0
        self.tokens_generated = 0
        self._m_lanes = ENGINE_LANES_ACTIVE.labels(run_id, node)
        self._m_segments = ENGINE_SEGMENTS.labels(run_id, node)
        self._m_tokens = TOKENS_GENERATED.labels(run_id, node)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # speculative segments place a gamma+1 verify window before the
        # rollback; the headroom keeps the logical capacity of plain mode
        s_alloc = cache_len + (gamma + 1 if speculative else 0)
        cdt = torch.bfloat16 if params.final_ln.dtype == torch.bfloat16 else torch.float32
        self.cache = KVCache.zeros(cfg.layers, lanes, s_alloc, cfg.kv_heads,
                                   cfg.head_dim, dtype=cdt, device=dev,
                                   grid=cache_grid(params))
        self.tokens = zeros(lanes)
        self.done = zeros(lanes, dtype=torch.bool)
        # + headroom: a plain lane's last segment may overrun its budget by
        # up to steps - 1 columns, a verify round by gamma + 1
        width = cache_len + max(segment_steps, gamma + 2)
        self.emit_buf = zeros(lanes, width)
        # each lane's emission count, which is its write column (the
        # reference tracks it on the host in plain mode: the same numbers);
        # speculative mode: limits and the prompt rows the drafts read
        self.counts = zeros(lanes)
        self.limits = zeros(lanes)
        self._pcap = cache_len
        self.prompts = zeros(lanes, self._pcap)
        self.prompt_len = zeros(lanes)
        self._emitted = zeros(lanes, segment_steps)
        self._u = zeros(spec_rounds, lanes, gamma, dtype=torch.float32)
        self._gen = (torch.Generator(device=dev).manual_seed(0)
                     if inject_accept_p is not None else None)
        self._ring = [_Snapshot(lanes, width, dev) for _ in range(2)]
        self._n_dispatched = 0
        self._lane_req: list[Optional[_Request]] = [None] * lanes
        self._waiting: asyncio.Queue[_Request] = asyncio.Queue()
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stopped = False
        self.graph: Optional[decode_graph.CapturedGraph] = None
        if decode_graph.uses_graphs(tree_all_devices(params)):
            self.graph = decode_graph.CapturedGraph(self._segment_body, dev)
        self._reset()

    def _reset(self) -> None:
        """Every lane free (after the capture's warm-up, or a failure)."""
        for t in (self.tokens, self.emit_buf, self.counts, self.limits,
                  self.prompt_len, self.cache.length):
            t.zero_()
        self.done.fill_(True)

    # -- public API --------------------------------------------------------
    async def start(self) -> None:
        if self._loop_task is None:
            self._stopped = False
            self._loop_task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None

    async def submit(self, prompt_ids: np.ndarray, max_new_tokens: int) -> list[int]:
        """Returns the generated token ids (eos excluded)."""
        if not 0 < max_new_tokens <= self.cache_len - 2:
            raise ValueError(
                f"max_new_tokens must be in [1, {self.cache_len - 2}] "
                f"(cache_len={self.cache_len}), got {max_new_tokens}"
            )
        fut = asyncio.get_running_loop().create_future()
        await self._waiting.put(
            _Request(np.asarray(prompt_ids, np.int32), max_new_tokens, fut)
        )
        self._wake.set()
        return await fut

    @property
    def active_lanes(self) -> int:
        return sum(r is not None for r in self._lane_req)

    # -- engine loop -------------------------------------------------------
    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        pending = None  # (slot, snapshot) of the last segment
        while not self._stopped:
            try:
                self._admit_waiting()
                if self.active_lanes == 0:
                    if pending is not None:
                        await loop.run_in_executor(None, self._process_done, *pending)
                        pending = None
                    elif self._waiting.empty():
                        self._wake.clear()
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                        except asyncio.TimeoutError:
                            pass
                    continue
                nxt = self._dispatch_segment()
                if self.pipeline_segments:
                    # segment N+1 runs while N's completions are processed
                    if pending is not None:
                        await loop.run_in_executor(None, self._process_done, *pending)
                    pending = nxt
                else:
                    await loop.run_in_executor(None, self._process_done, *nxt)
            except Exception as exc:  # noqa: BLE001 — a bad batch must not
                # take the loop (and every later submit) down with it
                logger.exception("decode engine iteration failed")
                for lane, r in enumerate(self._lane_req):
                    if r is not None and not r.future.done():
                        r.future.set_exception(exc)
                    self._lane_req[lane] = None
                with torch.inference_mode():
                    self.done.fill_(True)
                pending = None
        # drain on stop: resolve in-flight lanes with what they produced
        if pending is not None:
            self._process_done(*pending)
        held = [(lane, r) for lane, r in enumerate(self._lane_req) if r is not None]
        if held:
            emit = self.emit_buf.cpu().numpy()
            counts = self.counts.cpu().numpy()
            for lane, r in held:
                if not r.future.done():
                    r.future.set_result(self._collect(emit[lane], r, int(counts[lane])))
                self._lane_req[lane] = None
        while not self._waiting.empty():
            r = self._waiting.get_nowait()
            if not r.future.done():
                r.future.set_exception(RuntimeError("decode engine stopped"))

    def _collect(self, row: np.ndarray, req: _Request, written: int) -> list[int]:
        """One lane's emissions from a host copy of its row, cut at eos."""
        n = min(written, req.max_new_tokens, self.cache_len)
        toks = [int(t) for t in row[:n]]
        if self.eos in toks:
            toks = toks[: toks.index(self.eos)]
        return toks

    @torch.inference_mode()
    def _admit_waiting(self) -> int:
        free = [i for i, r in enumerate(self._lane_req) if r is None]
        batch: list[_Request] = []
        while free and not self._waiting.empty() and len(batch) < max(self.admit_buckets):
            req = self._waiting.get_nowait()
            req.lane = free.pop(0)
            batch.append(req)
        if not batch:
            return 0
        a = pick_bucket(len(batch), self.admit_buckets)
        longest = max(len(r.prompt_ids) for r in batch)
        cap = self.cache_len - max(r.max_new_tokens for r in batch) - 1
        p = min(pick_bucket(min(longest, cap), self.prefill_buckets + (cap,)), cap)
        ids = np.zeros((a, p), np.int32)
        mask = np.zeros((a, p), np.int32)
        for j, r in enumerate(batch):
            trunc = r.prompt_ids[:p]
            ids[j, : len(trunc)] = trunc
            mask[j, : len(trunc)] = 1
        mask[len(batch):, 0] = 1  # keep position math valid on pad rows
        ids[len(batch):, 0] = 1
        self._admit(ids, mask, batch)
        for r in batch:
            self._lane_req[r.lane] = r
        return len(batch)

    def _admit(self, ids: np.ndarray, mask: np.ndarray, batch: list[_Request]) -> None:
        """Prefill the admitted prompts and copy the real rows' cache, first
        token and flags into their lanes."""
        dev, n = self.device, len(batch)
        cfg = self.cfg
        ids_t, mask_t = _h2d(ids, dev), _h2d(mask, dev)
        lanes = _h2d(np.array([r.lane for r in batch], np.int64), dev)
        mini = KVCache.zeros(cfg.layers, ids.shape[0], self.cache.max_len,
                             cfg.kv_heads, cfg.head_dim, dtype=self.cache.dtype,
                             device=dev, grid=cache_grid(self._prefill_params))
        logits, mini = qwen_prefill(self._prefill_params, cfg, ids_t, mask_t, mini)
        first = torch.argmax(logits[:n], dim=-1).to(torch.int32)
        self.cache.put_lanes([r.lane for r in batch], mini)
        self.tokens[lanes] = first
        self.done[lanes] = first == self.eos
        self.emit_buf[lanes, 0] = first
        self.counts[lanes] = 1  # the first (prefill-argmax) token
        if self.speculative:
            padded = np.zeros((n, self._pcap), np.int32)
            padded[:, : ids.shape[1]] = ids[:n]
            self.prompts[lanes] = _h2d(padded, dev)
            self.prompt_len[lanes] = mask_t[:n].sum(dim=1).to(torch.int32)
            self.limits[lanes] = _h2d(
                np.array([r.max_new_tokens for r in batch], np.int32), dev)

    # -- segments ----------------------------------------------------------
    def _segment_body(self) -> None:
        if self.speculative:
            self._spec_segment()
        else:
            self._plain_segment()

    def _plain_segment(self) -> None:
        """`segment_steps` decode steps for every lane, appended to the
        emission buffer at each lane's count."""
        steps = self.segment_steps
        s = self.cache.max_len
        for i in range(steps):
            logits, _ = qwen_decode_step(self.params, self.cfg, self.tokens, self.cache)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(self.done, self.eos, nxt).to(torch.int32)
            self.done.logical_or_(nxt == self.eos)
            self.done.logical_or_(self.cache.length >= s - 1)
            self._emitted[:, i] = nxt
            self.tokens.copy_(nxt)
        cap = self.emit_buf.shape[1]
        cols = (self.counts.long().clamp(0, cap - steps)[:, None]
                + torch.arange(steps, device=self.device))
        self.emit_buf.scatter_(1, cols, self._emitted)
        self.counts.add_(steps)

    def _spec_segment(self) -> None:
        """`spec_rounds` verify rounds for every lane (`spec_verify_round`)
        over the lane's prompt, committing into the emission buffer at the
        lane's count: counts stays below limits <= cache_len - 2 < width - 1,
        so the masked writes' scratch column is never read."""
        for r in range(self.spec_rounds):
            spec_verify_round(
                self.params, self.cfg, self.cache, self.prompts, self.prompt_len,
                self.emit_buf, self.counts, self.tokens, self.done, self.limits,
                gamma=self.gamma, eos=self.eos, accept_u=self._u[r],
                accept_p=self.inject_accept_p, cache_guard=True,
            )

    @torch.inference_mode()
    def _dispatch_segment(self):
        """Run one segment (no host sync) and queue its snapshot into the
        next ring slot -> (slot, [(lane, request)])."""
        if self._gen is not None:
            torch.rand(self._u.shape, generator=self._gen, device=self.device,
                       out=self._u)
        if self.graph is not None:
            self.graph.replay()
        else:
            self._segment_body()
        self.segments += 1
        self._m_segments.inc()
        snapshot = [(lane, r) for lane, r in enumerate(self._lane_req) if r is not None]
        slot = self._ring[self._n_dispatched % 2]
        self._n_dispatched += 1
        slot.take(self.done, self.counts, self.emit_buf)
        return slot, snapshot

    def _process_done(self, slot: _Snapshot, snapshot) -> None:
        """Resolve the completions of a dispatched segment from its ring
        slot. With pipelining this runs while the next segment executes."""
        slot.wait()
        done = slot.done.numpy()
        counts = slot.counts.numpy()
        emit = slot.emit.numpy()
        for lane, req in snapshot:
            if self._lane_req[lane] is not req:
                continue  # already resolved (error path / stop drain)
            written = int(counts[lane])
            if done[lane] or written >= req.max_new_tokens:
                toks = self._collect(emit[lane], req, written)
                self.tokens_generated += len(toks)
                self._m_tokens.inc(len(toks))
                if not req.future.done():
                    req.future.get_loop().call_soon_threadsafe(
                        lambda f=req.future, t=toks: (
                            f.set_result(t) if not f.done() else None
                        )
                    )
                self._lane_req[lane] = None
        self.lanes_active = self.active_lanes
        self._m_lanes.set(self.lanes_active)
