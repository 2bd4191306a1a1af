"""Flat int8 index with a device-resident bf16 rescore copy.

Port of the int8 path of `rag_inference_pipeline_tpu/index/flat.py`: codes
quantized with one global scale (`quantize_global_int8`) carry the scan
(kernel K1 through `fused_topk_int8gs`); with `rescore_k > 0` a bf16 copy
of the vectors re-scores the shortlist exactly. Arrays are padded to a
scan-chunk multiple at build time and `ntotal` masks the pad rows, as in
the reference, so artifacts and pipelines see the same layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.topk import _round_up, fused_topk_int8gs, quantize_global_int8
from .base import save_npz


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
        rescore_k: int = 64,  # exact bf16 re-score depth (0 = off)
    ) -> None:
        if dtype != "int8":
            raise ValueError(
                f"index dtype {dtype!r}: the port's FlatIndex stores int8 "
                "codes only"
            )
        if metric != "ip":
            raise ValueError("int8 storage supports metric='ip' only")
        self.dim = dim
        self.metric = metric
        self.dtype_name = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.nbins = nbins
        self.rescore_k = rescore_k
        # rows are padded to a multiple of the reference's int8 scan chunk,
        # which must itself be a multiple of nbins
        self._chunk_i8 = _round_up(min(chunk * 2, 8192), nbins)
        self._db: Optional[torch.Tensor] = None  # bf16 rescore copy
        self._db_i8: Optional[torch.Tensor] = None
        self._db_gscale: Optional[torch.Tensor] = None  # 0-d f32
        self.ntotal = 0
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def add(self, vectors) -> None:
        """Append rows ([N, dim] numpy array or tensor); re-quantizes the
        whole store with one global scale."""
        new = _as_tensor(vectors, self.device, torch.float32)
        if new.dim() != 2 or new.shape[1] != self.dim:
            raise ValueError(f"vectors must be [N, {self.dim}], got {tuple(new.shape)}")
        if self._db_i8 is not None:
            # re-add keeps the exact originals where the rescore copy has them
            prev = (
                self._db[: self.ntotal].float()
                if self._db is not None
                else self._db_i8[: self.ntotal].float() * self._db_gscale
            )
            new = torch.cat([prev, new])
        n = new.shape[0]
        # quantize BEFORE padding: pad rows would skew the percentile scale
        db_i8, gscale = quantize_global_int8(new)
        pad = _round_up(n, self._chunk_i8) - n
        self._db_i8 = torch.nn.functional.pad(db_i8, (0, 0, 0, pad))
        self._db_gscale = gscale
        self._db = (
            torch.nn.functional.pad(new, (0, 0, 0, pad)).to(torch.bfloat16)
            if self.rescore_k > 0
            else None
        )
        self.ntotal = n
        self._loaded = True

    def validate_queries(self, q) -> torch.Tensor:
        q = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.array(q))
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2:
            raise ValueError(f"queries must be [B, dim], got shape {tuple(q.shape)}")
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if not q.is_floating_point():
            raise ValueError(f"queries must be floating, got {q.dtype}")
        return q.to(self.device)

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [B,k] f32, ids [B,k] i32) on the index's device."""
        if not self._loaded:
            raise RuntimeError("flat index not loaded")
        q = self.validate_queries(queries)
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

    def save(self, path: str) -> None:
        if not self._loaded:
            raise RuntimeError("nothing to save")
        extra = {}
        if self._db is not None:  # rescore copy, float16 on disk
            # bf16 -> f16 rounds once, as the reference's bf16 -> f32 -> f16
            extra["vectors_rescore"] = (
                self._db[: self.ntotal].to(torch.float16).cpu().numpy()
            )
        save_npz(
            path,
            kind=self.kind,
            dim=self.dim,
            metric=self.metric,
            dtype=self.dtype_name,
            rescore_k=self.rescore_k,
            vectors_i8=self._db_i8[: self.ntotal].cpu().numpy(),
            gscale=np.float32(self._db_gscale.item()),
            **extra,
        )

    @classmethod
    def _load(cls, path: str, device: Optional[torch.device] = None) -> "FlatIndex":
        with np.load(path, allow_pickle=False) as z:
            idx = cls(
                int(z["dim"]), metric=str(z["metric"]), dtype=str(z["dtype"]),
                device=device,
            )
            if "vectors_i8" not in z or "scales" in z:
                raise ValueError(
                    f"{path}: not a global-scale int8 flat artifact"
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
            if "vectors_rescore" in z:
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
