"""IVF-Flat index: a k-means coarse quantizer trained on the device and
bucketed lists in device memory.

Port of `rag_inference_pipeline_tpu/index/ivf_flat.py` at dp=1, with the
same search routing (`ivf_flat.py:125-137`): on the card an IP search
takes the batch-deduplicated scan (K5) while its score tensor fits
`_DEDUP_BYTES_BUDGET`, else the streaming scan (K4); the CPU, the l2
metric and `exact=True` take the exact plain path. Artifacts are the
reference's `.npz` (buckets stored as float32) in both directions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.ivf import (
    IVFListing,
    build_ivf,
    ivf_search,
    ivf_search_dedup,
    ivf_search_scan,
)
from .base import check_metric, save_npz, storage_dtype, validate_queries


class IVFFlatIndex:
    kind = "ivf_flat"

    # budget for the dedup path's [n_slots, B_pad, cap] f32 score tensor and
    # the two [B, n_slots*cap] views it reshapes into: it decides which
    # kernel runs, so it is the reference's value
    _DEDUP_BYTES_BUDGET = 1 << 30  # 1 GB

    def __init__(
        self,
        dim: int,
        nlist: int,
        *,
        metric: str = "ip",
        nprobe: int = 64,
        dtype: str = "bfloat16",
        cap_factor: float = 2.5,
        device: Optional[torch.device] = None,
        exact: bool = False,
    ) -> None:
        check_metric(metric)
        storage_dtype(dtype)
        self.dim = dim
        self.metric = metric
        self.nlist = nlist
        self.nprobe = nprobe
        self.dtype_name = dtype
        self.cap_factor = cap_factor
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.exact = exact
        self._listing: Optional[IVFListing] = None
        self.ntotal = 0
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def train_add(
        self,
        vectors,
        *,
        train_size: int = 131072,
        iters: int = 15,
        seed: int = 0,
    ) -> None:
        """k-means train + assign + bucket build in one shot. `vectors` is
        [N, dim], numpy or a tensor (on any device); the build runs on the
        index's device."""
        v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
            np.asarray(vectors, np.float32)
        )
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise ValueError(f"vectors must be [N, {self.dim}], got {tuple(v.shape)}")
        self._listing = build_ivf(
            v.to(self.device, torch.float32), self.nlist,
            train_size=train_size, iters=iters, cap_factor=self.cap_factor,
            storage_dtype=storage_dtype(self.dtype_name), seed=seed,
        )
        self.ntotal = v.shape[0]
        self._loaded = True

    def search(self, queries, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [B,k] f32, ids [B,k] i32) on the index's device."""
        if not self._loaded:
            raise RuntimeError("ivf_flat index not loaded")
        q = validate_queries(queries, self.dim, self.device)
        if not self.exact and self.metric == "ip" and self.device.type == "cuda":
            if self._dedup_fits(q.shape[0]):
                return ivf_search_dedup(self._listing, q, k, nprobe=self.nprobe)
            return ivf_search_scan(self._listing, q, k, nprobe=self.nprobe)
        return ivf_search(
            self._listing, q, k, nprobe=self.nprobe, metric=self.metric
        )

    def _dedup_fits(self, b: int) -> bool:
        """True when the dedup path's score transient fits the budget."""
        nlist, cap, _ = self._listing.buckets.shape
        n_slots = min(nlist, b * self.nprobe)
        b_pad = ((max(b, 8) + 7) // 8) * 8
        return 3 * n_slots * b_pad * cap * 4 <= self._DEDUP_BYTES_BUDGET

    @property
    def imbalance(self) -> float:
        """max/mean list size — diagnostic for k-means balance quality."""
        sizes = self._listing.list_sizes.cpu().numpy()
        return float(sizes.max() / max(1.0, sizes.mean()))

    def save(self, path: str) -> None:
        """The reference's artifact; the buckets go to float32 a list block
        at a time on the host."""
        if not self._loaded:
            raise RuntimeError("nothing to save")
        lst = self._listing
        nlist, cap, d = lst.buckets.shape
        buckets = np.empty((nlist, cap, d), np.float32)
        step = max(1, (1 << 28) // max(1, cap * d * 4))
        for s in range(0, nlist, step):
            buckets[s : s + step] = lst.buckets[s : s + step].float().cpu().numpy()
        save_npz(
            path,
            kind=self.kind,
            dim=self.dim,
            metric=self.metric,
            dtype=self.dtype_name,
            nlist=self.nlist,
            nprobe=self.nprobe,
            ntotal=self.ntotal,
            cap_factor=self.cap_factor,
            centroids=lst.centroids.float().cpu().numpy(),
            buckets=buckets,
            ids=lst.ids.cpu().numpy(),
            list_sizes=lst.list_sizes.cpu().numpy(),
        )

    @classmethod
    def _load(cls, path: str, device: Optional[torch.device] = None) -> "IVFFlatIndex":
        with np.load(path, allow_pickle=False) as z:
            idx = cls(
                int(z["dim"]),
                int(z["nlist"]),
                metric=str(z["metric"]),
                nprobe=int(z["nprobe"]),
                dtype=str(z["dtype"]),
                cap_factor=float(z["cap_factor"]),
                device=device,
            )
            dev = idx.device
            idx._listing = IVFListing(
                centroids=torch.from_numpy(z["centroids"]).to(dev, torch.float32),
                # f32 on disk -> storage dtype on the host, then one upload
                buckets=torch.from_numpy(z["buckets"])
                .to(storage_dtype(idx.dtype_name)).to(dev),
                ids=torch.from_numpy(z["ids"]).to(dev, torch.int32),
                list_sizes=torch.from_numpy(z["list_sizes"]).to(dev, torch.int32),
            )
            idx.ntotal = int(z["ntotal"])
            idx._loaded = True
        return idx
