"""Flat index: bf16/f32 vectors scanned by K2, or int8 codes scanned by K1
with an exact rescore copy on the device (bf16) or in host RAM (f16).

Port of the dp=1 paths of `rag_inference_pipeline_tpu/index/flat.py`:

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

Artifacts are the reference's `.npz` in both directions.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.topk import (
    _round_up,
    exact_topk,
    fused_topk,
    fused_topk_int8gs,
    quantize_global_int8,
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
        self.device = torch.device(device) if device is not None else torch.device("cpu")
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
            db = new if self._db is None else torch.cat([self._db[: self.ntotal], new])
            self._db = db
            self.ntotal = db.shape[0]
            if self.metric == "l2":
                dbf = db.float()
                self._db_sq = (dbf * dbf).sum(dim=-1)
            self._loaded = True
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
                prev = self._db[: self.ntotal].float()
            elif self._host_rescore is not None:
                prev = torch.from_numpy(
                    self._host_rescore[: self.ntotal].astype(np.float32)
                ).to(self.device)
            else:
                prev = self._db_i8[: self.ntotal].float() * self._db_gscale
            new = torch.cat([prev, new])
        n = new.shape[0]
        # quantize BEFORE padding: pad rows would skew the percentile scale
        db_i8, gscale = quantize_global_int8(new)
        pad = _round_up(n, self._chunk_i8) - n
        self._db_i8 = torch.nn.functional.pad(db_i8, (0, 0, 0, pad))
        self._db_gscale = gscale
        self._db = (
            torch.nn.functional.pad(new, (0, 0, 0, pad)).to(torch.bfloat16)
            if self.rescore_k > 0 and not host
            else None
        )
        self.ntotal = n
        self._loaded = True

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
            if self.device.type == "cuda" and self.metric == "ip" and k <= self.nbins:
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
        return fused_topk_int8gs(
            q, self._db_i8, self._db_gscale, k, nbins=self.nbins,
            rescore_db=self._db if r_k > 0 else None, rescore_k=r_k,
            ntotal=self.ntotal,
        )

    def _host_refine(self, q: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """K1's shortlist of s_k ids with no device re-score, then the exact
        f16 re-rank on the host (native `cs_rescore_f16`)."""
        s_k = min(max(self.rescore_k, k + 32), self.nbins)
        _, ids = fused_topk_int8gs(
            q, self._db_i8, self._db_gscale, s_k, nbins=self.nbins, ntotal=self.ntotal,
        )
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
            save_npz(path, **head, vectors=self._db[: self.ntotal].float().cpu().numpy())
            return
        extra = {}
        if self._db is not None:  # rescore copy, float16 on disk
            # bf16 -> f16 rounds once, as the reference's bf16 -> f32 -> f16
            extra["vectors_rescore"] = (
                self._db[: self.ntotal].to(torch.float16).cpu().numpy()
            )
        elif self._host_rescore is not None:
            extra["vectors_rescore"] = self._host_rescore[: self.ntotal]
            extra["rescore_store"] = np.bytes_(b"host")
        save_npz(
            path,
            **head,
            rescore_k=self.rescore_k,
            vectors_i8=self._db_i8[: self.ntotal].cpu().numpy(),
            gscale=np.float32(self._db_gscale.item()),
            **extra,
        )

    @classmethod
    def _load(
        cls, path: str, device: Optional[torch.device] = None,
        *, rescore_store: Optional[str] = None,
    ) -> "FlatIndex":
        """`rescore_store` ("device" | "host") overrides where an int8
        artifact's rescore copy lands (a deployment choice); None keeps the
        artifact's own (`rescore_store=b"host"` when it was saved so)."""
        with np.load(path, allow_pickle=False) as z:
            idx = cls(
                int(z["dim"]), metric=str(z["metric"]), dtype=str(z["dtype"]),
                device=device,
            )
            if rescore_store is not None:
                idx.rescore_store = rescore_store
            if "vectors" in z:
                idx.add(z["vectors"])
                return idx
            if "vectors_i8" not in z or "scales" in z:
                raise ValueError(
                    f"{path}: not a global-scale int8 or a vector flat artifact"
                )
            idx.rescore_k = int(z["rescore_k"]) if "rescore_k" in z else 0
            codes = torch.from_numpy(z["vectors_i8"])
            n = codes.shape[0]
            pad = _round_up(n, idx._chunk_i8) - n
            idx._db_i8 = torch.nn.functional.pad(
                codes.to(idx.device), (0, 0, 0, pad)
            )
            idx._db_gscale = torch.tensor(
                float(z["gscale"]), dtype=torch.float32, device=idx.device
            )
            want_host = idx.rescore_store == "host" or (
                "rescore_store" in z and rescore_store is None
            )
            if "vectors_rescore" in z and want_host:
                # the f16 copy stays in host RAM: no upload at all
                idx.rescore_store = "host"
                idx._host_rescore = np.ascontiguousarray(z["vectors_rescore"])
                cpuscan.madvise_hugepage(idx._host_rescore)
            elif "vectors_rescore" in z:
                # f16 on disk -> bf16 on the host, then one upload
                re = torch.from_numpy(z["vectors_rescore"]).to(torch.bfloat16)
                idx._db = torch.nn.functional.pad(
                    re, (0, 0, 0, pad)
                ).to(idx.device)
            else:
                idx.rescore_k = 0
            idx.ntotal = n
            idx._loaded = True
        return idx
