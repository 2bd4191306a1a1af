"""Flat index: bf16/f32 vectors scanned by K2, or int8 codes scanned by K1
with an exact rescore copy on the device (bf16) or in host RAM (f16).

Port of `rag_inference_pipeline_tpu/index/flat.py`:

- bf16 / f32 storage (`dtype="bfloat16"` or "float32"):
  on the card an IP search with k <= nbins takes `fused_topk` (kernel K2);
  the CPU, the l2 metric (with the stored squared norms) and k > nbins
  take `exact_topk`, as the reference routes them (`flat.py:357-365`).
- int8 storage (the constructor's default here, as the fused path of the
  port started with it; `make_index` and `_load` always name the dtype):
  codes quantized with one global scale
  (`quantize_global_int8`) carry the scan (kernel K1 through
  `fused_topk_int8gs`); with `rescore_k > 0` a copy of the vectors
  re-scores the shortlist exactly. `rescore_store="device"` keeps that
  copy as bf16 on the card and re-scores inside `fused_topk_int8gs`;
  `rescore_store="host"` keeps it as f16 in host RAM, on 2 MB pages where
  the OS grants them, and no copy goes to the card: K1 returns a shortlist
  of min(max(rescore_k, k + 32), nbins) ids, which `utils/cpuscan.py::
  rescore_f16` re-ranks on the host (the reference's refine-from-storage,
  `flat.py:279-312`; its time is the stage `index`/`host_refine` of
  `pipeline_stage_duration_seconds`). Arrays are padded to a scan-chunk
  multiple at build time and `ntotal` masks the pad rows, as in the
  reference, so artifacts and pipelines see the same layout.

With a `core/mesh.py` mesh of dp > 1 the stores are lists of row shards,
one a dp position (`flat.py:215-260`): int8 codes and their bf16 copy are
padded to a multiple of chunk x dp, bf16/f32 vectors to a dp multiple,
`ntotal` kept; an `.npz` places each shard's rows on its position's device;
the global scale is the artifact's (all rows), never a shard's. Searches
go through `ops/topk.py::sharded_topk_int8gs` (K1 once a shard; the device
re-score, or K1's shortlist then the host refine) and `sharded_topk` (K2
once a shard).

Under SPMD serving (`serve/spmd.py`) each process loads its own row range
of an artifact (`load_part`): rows [rank * R, (rank + 1) * R) of the
artifact padded to world x chunk x dp, its local ids lifted by `id_offset`.

Artifacts are the reference's `.npz` in both directions.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.mesh import MeshContext
from ..ops.topk import (
    _round_up,
    exact_topk,
    fused_topk,
    fused_topk_int8gs,
    quantize_global_int8,
    sharded_topk,
    sharded_topk_int8gs,
)
from ..telemetry.metrics import STAGE_DURATION
from ..utils import cpuscan
from .base import check_metric, save_npz, storage_dtype, validate_queries


def _as_tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(x, copy=True)).to(device=device, dtype=dtype)


class FlatIndex:
    kind = "flat"

    def __init__(
        self,
        dim: int,
        *,
        metric: str = "ip",
        dtype: str = "int8",
        device: Optional[torch.device] = None,
        nbins: int = 512,
        chunk: int = 4096,
        rescore_k: int = 64,  # int8: exact re-score depth (0 = off)
        rescore_store: str = "device",  # "device" (bf16) | "host" (f16 RAM)
        mesh: Optional[MeshContext] = None,
    ) -> None:
        check_metric(metric)
        if dtype == "int8":
            if metric != "ip":
                raise ValueError("int8 storage supports metric='ip' only")
        else:
            storage_dtype(dtype)  # raises on an unsupported name
        if rescore_store not in ("device", "host"):
            raise ValueError("rescore_store must be 'device' or 'host'")
        self.rescore_store = rescore_store
        self.dim = dim
        self.metric = metric
        self.dtype_name = dtype
        if device is None:
            device = mesh.front if mesh is not None else "cpu"
        self.device = torch.device(device)
        # rows sharded over dp: every store below is a list of row blocks
        self.mesh = mesh if mesh is not None and mesh.dp > 1 else None
        self.nbins = nbins
        self.rescore_k = rescore_k
        # int8 rows are padded to a multiple of the reference's int8 scan
        # chunk, which must itself be a multiple of nbins
        self._chunk_i8 = _round_up(min(chunk * 2, 8192), nbins)
        self._db: Optional[torch.Tensor] = None  # vectors, or the int8 rescore copy
        self._db_sq: Optional[torch.Tensor] = None  # l2: squared norms
        self._db_i8: Optional[torch.Tensor] = None
        self._db_gscale: Optional[torch.Tensor] = None  # 0-d f32
        self._host_rescore: Optional[np.ndarray] = None  # f16 [ntotal, D]
        # (run_id, node) of the host refine's stage metric; the serving
        # component sets the node's own
        self.metric_labels = ("dev", "0")
        # SPMD process part (`load_part`): the first global row this process
        # holds, and the artifact's row count
        self.id_offset = 0
        self.ntotal_global = 0
        self.ntotal = 0
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def add(self, vectors) -> None:
        """Append rows ([N, dim] numpy array or tensor). int8 storage
        re-quantizes the whole store with one global scale."""
        if self.dtype_name != "int8":
            new = _as_tensor(vectors, self.device, storage_dtype(self.dtype_name))
            self._check_rows(new)
            db = new if self._db is None else torch.cat([self._rows(self._db), new])
            self._set_db(db)
            return
        new = _as_tensor(vectors, self.device, torch.float32)
        self._check_rows(new)
        host = self.rescore_k > 0 and self.rescore_store == "host"
        if host:
            # the f16 originals stay in host RAM; nothing more reaches the
            # card (f32 -> f16 rounds to nearest even, as numpy's astype)
            rows = new.to(torch.float16).cpu().numpy()
            self._host_rescore = (
                rows if self._host_rescore is None
                else np.concatenate([self._host_rescore[: self.ntotal], rows])
            )
            cpuscan.madvise_hugepage(self._host_rescore)
        if self._db_i8 is not None:
            # re-add keeps the exact originals where a rescore copy has them
            if self._db is not None:
                prev = self._rows(self._db).float()
            elif self._host_rescore is not None:
                prev = torch.from_numpy(
                    self._host_rescore[: self.ntotal].astype(np.float32)
                ).to(self.device)
            else:
                prev = self._rows(self._db_i8).float() * self._front_scale()
            new = torch.cat([prev, new])
        n = new.shape[0]
        # quantize BEFORE padding: pad rows would skew the percentile scale
        db_i8, gscale = quantize_global_int8(new)
        pad = _round_up(n, self._i8_align()) - n
        rescore = (
            torch.nn.functional.pad(new, (0, 0, 0, pad)).to(torch.bfloat16)
            if self.rescore_k > 0 and not host
            else None
        )
        self._put_i8(torch.nn.functional.pad(db_i8, (0, 0, 0, pad)), gscale, rescore)
        self.ntotal = n
        self._loaded = True

    def _i8_align(self, world: int = 1) -> int:
        """Row alignment of the int8 store: a scan-chunk multiple, times dp
        when sharded (and times the processes of an SPMD part), so every
        shard's rows are chunk-aligned."""
        dp = self.mesh.dp if self.mesh is not None else 1
        return self._chunk_i8 * dp * world

    def _put_i8(
        self, db_i8: torch.Tensor, gscale: torch.Tensor,
        rescore: Optional[torch.Tensor],
    ) -> None:
        """Place the padded codes (and the bf16 copy) on the device, or row
        shards of them over the mesh; the scale once per distinct device."""
        if self.mesh is not None:
            rows = self.mesh.rows_dp
            self._db_i8 = self.mesh.put(db_i8, rows)
            self._db_gscale = self.mesh.put(gscale.float())
            self._db = self.mesh.put(rescore, rows) if rescore is not None else None
            return
        self._db_i8 = db_i8.to(self.device)
        self._db_gscale = gscale.to(self.device, torch.float32)
        self._db = rescore.to(self.device) if rescore is not None else None

    def _set_db(self, db: torch.Tensor) -> None:
        """Vectors (bf16/f32) on the device, or padded to a dp multiple and
        row-sharded (`ntotal` masks the pad rows in the sharded scans)."""
        n = db.shape[0]
        if self.mesh is not None:
            pad = _round_up(n, self.mesh.dp) - n
            self._db = self.mesh.put(torch.nn.functional.pad(db, (0, 0, 0, pad)),
                                     self.mesh.rows_dp)
        else:
            self._db = db.to(self.device)
            if self.metric == "l2":
                dbf = self._db.float()
                self._db_sq = (dbf * dbf).sum(dim=-1)
        self.ntotal = n
        self._loaded = True

    def _rows(self, x) -> torch.Tensor:
        """The first ntotal rows of a store (a tensor, or row shards joined
        on the front device)."""
        if isinstance(x, list):
            x = torch.cat([s.to(self.device) for s in x])
        return x[: self.ntotal]

    def _front_scale(self) -> torch.Tensor:
        return self._db_gscale[0] if isinstance(self._db_gscale, list) else self._db_gscale

    def _check_rows(self, new: torch.Tensor) -> None:
        if new.dim() != 2 or new.shape[1] != self.dim:
            raise ValueError(f"vectors must be [N, {self.dim}], got {tuple(new.shape)}")

    def validate_queries(self, q) -> torch.Tensor:
        return validate_queries(q, self.dim, self.device)

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [B,k] f32, ids [B,k] i32) on the index's device."""
        if not self._loaded:
            raise RuntimeError("flat index not loaded")
        q = self.validate_queries(queries)
        if self.dtype_name != "int8":
            fused = self.device.type == "cuda" and self.metric == "ip" and k <= self.nbins
            if self.mesh is not None:
                return sharded_topk(
                    self.mesh, q, self._db, k, use_fused=fused, nbins=self.nbins,
                    metric=self.metric, ntotal=self.ntotal,
                )
            if fused:
                return fused_topk(q, self._db, k, nbins=self.nbins, ntotal=self.ntotal)
            return exact_topk(
                q, self._db, k, metric=self.metric, db_sq_norms=self._db_sq,
                ntotal=self.ntotal,
            )
        if self.rescore_k > 0 and self._host_rescore is not None:
            return self._host_refine(q, k)
        # the re-score runs only when rescore_k > k: deepen the shortlist
        # so it stays on for any k
        r_k = (
            min(max(self.rescore_k, k + 32), self.nbins)
            if self.rescore_k > 0 and self._db is not None
            else 0
        )
        return self._scan_i8(q, k, rescore_k=r_k)

    def _scan_i8(self, q: torch.Tensor, k: int, *, rescore_k: int = 0):
        """K1 (once a shard when sharded), with the device re-score of the
        top rescore_k when rescore_k > 0."""
        rescore = self._db if rescore_k > 0 else None
        if self.mesh is not None:
            return sharded_topk_int8gs(
                self.mesh, q, self._db_i8, self._db_gscale, k, nbins=self.nbins,
                rescore_db_shards=rescore, rescore_k=rescore_k, ntotal=self.ntotal,
            )
        return fused_topk_int8gs(
            q, self._db_i8, self._db_gscale, k, nbins=self.nbins,
            rescore_db=rescore, rescore_k=rescore_k, ntotal=self.ntotal,
        )

    def _host_refine(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """K1's shortlist of s_k ids with no device re-score, then the exact
        f16 re-rank on the host (native `cs_rescore_f16`)."""
        s_k = min(max(self.rescore_k, k + 32), self.nbins)
        _, ids = self._scan_i8(q, s_k)
        qn = q.float().cpu().numpy()
        ids_n = ids.cpu().numpy()
        t0 = time.perf_counter()
        s, i = cpuscan.rescore_f16(qn, self._host_rescore, ids_n, k)
        STAGE_DURATION.labels(*self.metric_labels, "index", "host_refine").observe(
            time.perf_counter() - t0
        )
        return torch.from_numpy(s).to(self.device), torch.from_numpy(i).to(self.device)

    def save(self, path: str) -> None:
        if not self._loaded:
            raise RuntimeError("nothing to save")
        head = dict(kind=self.kind, dim=self.dim, metric=self.metric,
                    dtype=self.dtype_name)
        if self.dtype_name != "int8":
            save_npz(path, **head, vectors=self._rows(self._db).float().cpu().numpy())
            return
        extra = {}
        if self._db is not None:  # rescore copy, float16 on disk
            # bf16 -> f16 rounds once, as the reference's bf16 -> f32 -> f16
            extra["vectors_rescore"] = (
                self._rows(self._db).to(torch.float16).cpu().numpy()
            )
        elif self._host_rescore is not None:
            extra["vectors_rescore"] = self._host_rescore[: self.ntotal]
            extra["rescore_store"] = np.bytes_(b"host")
        save_npz(
            path,
            **head,
            rescore_k=self.rescore_k,
            vectors_i8=self._rows(self._db_i8).cpu().numpy(),
            gscale=np.float32(self._front_scale().item()),
            **extra,
        )

    @classmethod
    def _load(
        cls, path: str, device: Optional[torch.device] = None,
        *, rescore_store: Optional[str] = None, mesh: Optional[MeshContext] = None,
        part: Optional[tuple[int, int]] = None,
    ) -> "FlatIndex":
        """`rescore_store` ("device" | "host") overrides where an int8
        artifact's rescore copy lands (a deployment choice); None keeps the
        artifact's own (`rescore_store=b"host"` when it was saved so).
        `mesh` row-shards the stores; `part=(rank, world)` keeps this
        process's row range only (`load_part`)."""
        with np.load(path, allow_pickle=False) as z:
            idx = cls(
                int(z["dim"]), metric=str(z["metric"]), dtype=str(z["dtype"]),
                device=device, mesh=mesh,
            )
            if rescore_store is not None:
                idx.rescore_store = rescore_store
            key = "vectors" if "vectors" in z else "vectors_i8"
            if key not in z or "scales" in z:
                raise ValueError(
                    f"{path}: not a global-scale int8 or a vector flat artifact"
                )
            n = z[key].shape[0]
            rank, world = part if part is not None else (0, 1)
            if key == "vectors":
                lo, hi = idx._part_rows(n, rank, world, idx.mesh.dp if idx.mesh else 1)
                idx.add(z["vectors"][lo:hi])
                idx.id_offset, idx.ntotal_global = lo, n
                return idx
            idx.rescore_k = int(z["rescore_k"]) if "rescore_k" in z else 0
            lo, hi = idx._part_rows(n, rank, world, idx._i8_align())
            n_pad = _round_up(n, idx._i8_align(world)) // world

            def padded(a, dtype):
                t = torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dtype)
                return torch.nn.functional.pad(t, (0, 0, 0, n_pad - (hi - lo)))

            gscale = torch.tensor(float(z["gscale"]), dtype=torch.float32)
            want_host = idx.rescore_store == "host" or (
                "rescore_store" in z and rescore_store is None
            )
            rescore = None
            if "vectors_rescore" in z and want_host:
                # the f16 copy stays in host RAM: no upload at all
                idx.rescore_store = "host"
                idx._host_rescore = np.ascontiguousarray(z["vectors_rescore"][lo:hi])
                cpuscan.madvise_hugepage(idx._host_rescore)
            elif "vectors_rescore" in z:
                # f16 on disk -> bf16 on the host, then one upload
                rescore = padded(z["vectors_rescore"], torch.bfloat16)
            else:
                idx.rescore_k = 0
            idx._put_i8(padded(z["vectors_i8"], torch.int8), gscale, rescore)
            idx.ntotal = hi - lo
            idx.id_offset, idx.ntotal_global = lo, n
            idx._loaded = True
        return idx

    @staticmethod
    def _part_rows(n: int, rank: int, world: int, align: int) -> tuple[int, int]:
        """Process `rank`'s rows [lo, hi) of n: the artifact padded to a
        multiple of world x align, cut into world equal ranges."""
        per = _round_up(n, align * world) // world
        lo = min(rank * per, n)
        return lo, min(lo + per, n)


def load_part(
    path: str, rank: int, world: int, *, mesh: Optional[MeshContext] = None,
    device: Optional[torch.device] = None, rescore_store: Optional[str] = None,
) -> FlatIndex:
    """Process `rank`'s row range of a flat artifact, for SPMD serving: the
    global scale and rescore rows are the artifact's, `id_offset` lifts the
    part's ids to global ids (`serve/spmd.py::spmd_search`)."""
    return FlatIndex._load(
        path, device, rescore_store=rescore_store, mesh=mesh, part=(rank, world)
    )
