"""IVF-PQ index: residual product quantization over the bucketed IVF layout,
with an optional re-score of the ADC shortlist.

Port of `rag_inference_pipeline_tpu/index/ivf_pq.py` at dp=1, with its
search routing: PQ4 (ksub=16) scans through `ivfpq4_search_dedup` (kernel
K6 on the card, its plain version on the CPU, where the reference runs
Pallas in interpret mode), PQ8 through the gather-ADC `ivfpq_search`. With
`rescore_k > 0` the top max(k, rescore_k) ADC candidates are re-scored from
one of five stores (`rescore_kind`):

- "exact": bf16 vectors in device memory; the query is cast to bf16 before
  the product, as the reference's `_rescore_kernel` does;
- "int4" / "pq8": the residual tiers of `ops/pq.py` in device memory;
- "host_int8" / "host_f16": int8 codes (global scale) or f16 originals in
  host RAM, re-scored in numpy with the arithmetic of the reference's
  numpy fallbacks (`ivf_pq.py:420-431`, `flat.py:85-99`), their different
  invalid fills (NEG_INF, -inf) and their tie order (`argpartition`, then
  an unstable `argsort`) included. The reference's native multithreaded
  re-score and its huge-page advice are not ported.

Artifacts are the reference's `.npz` in both directions, an OPQ rotation
included; `train_add` builds without one. The sharded search is not ported
(no mesh in the port).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..ops.kmeans import require_full_f32
from ..ops.pq import (
    Int4ResidualTier,
    IVFPQListing,
    PQFlatTier,
    build_int4_tier,
    build_ivfpq,
    build_pq_tier,
    int4_tier_rescore_topk,
    ivfpq4_adc_scores,
    ivfpq4_search_dedup,
    ivfpq_search,
    pq_tier_rescore_topk,
)
from ..ops.topk import NEG_INF, _topk, quantize_global_int8
from .base import save_npz, validate_queries

logger = logging.getLogger(__name__)

RESCORE_KINDS = ("exact", "int4", "pq8", "host_int8", "host_f16")


class IVFPQIndex:
    kind = "ivf_pq"

    def __init__(
        self,
        dim: int,
        nlist: int,
        m: int,
        *,
        nprobe: int = 64,
        cap_factor: float = 2.5,
        rescore_k: int = 0,
        ksub: int = 256,
        rescore_kind: str = "exact",
        rescore_pq_m: int = 0,
        device: Optional[torch.device] = None,
    ) -> None:
        if dim % m != 0:
            raise ValueError(f"dim {dim} not divisible by pq m {m}")
        if ksub not in (16, 256):
            raise ValueError("ksub must be 16 (PQ4) or 256 (PQ8)")
        if rescore_kind not in RESCORE_KINDS:
            raise ValueError(
                "rescore_kind must be 'exact', 'int4', 'pq8', 'host_int8' "
                "or 'host_f16'"
            )
        if rescore_kind == "pq8":
            logger.warning(
                "rescore_kind='pq8' is precision-walled (2 bits/dim cannot "
                "re-rank near-ties); 'int4' or a host_* store ranks better"
            )
        self.dim = dim
        self.metric = "ip"  # the residual-ADC path is IP-metric
        self.ksub = ksub
        self.nlist = nlist
        self.m = m
        self.nprobe = nprobe
        self.cap_factor = cap_factor
        self.rescore_k = rescore_k
        self.rescore_kind = rescore_kind
        # pq8 tier subspaces; 0 = 4-dim subspaces (dim / 4)
        self.rescore_pq_m = rescore_pq_m or dim // 4
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._listing: Optional[IVFPQListing] = None
        self._vectors: Optional[torch.Tensor] = None  # "exact": [N, D] bf16
        self._tier: Optional[PQFlatTier] = None  # "pq8"
        self._int4: Optional[Int4ResidualTier] = None  # "int4"
        self._host_codes: Optional[np.ndarray] = None  # "host_int8": [N, D] i8
        self._host_scale: float = 0.0
        self._host_f16: Optional[np.ndarray] = None  # "host_f16": [N, D]
        self._rotation: Optional[torch.Tensor] = None  # [D, D], OPQ artifacts
        self.ntotal = 0
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    @property
    def opq(self) -> bool:
        """Whether queries rotate by an OPQ rotation, which only a loaded
        artifact carries (`ops/pq.py::train_opq` learns one)."""
        return self._rotation is not None

    def train_add(
        self,
        vectors,
        *,
        train_size: int = 131072,
        kmeans_iters: int = 15,
        pq_iters: int = 12,
        seed: int = 0,
    ) -> None:
        """Train and build on the index's device from [N, dim] rows (numpy
        or a tensor on any device); the re-score store of `rescore_kind`
        when rescore_k > 0."""
        v = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
            np.asarray(vectors, np.float32)
        )
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise ValueError(f"vectors must be [N, {self.dim}], got {tuple(v.shape)}")
        v = v.to(self.device, torch.float32)
        n = v.shape[0]
        self._rotation = None
        self._listing = build_ivfpq(
            v, self.nlist, self.m, train_size=train_size,
            kmeans_iters=kmeans_iters, pq_iters=pq_iters,
            cap_factor=self.cap_factor, seed=seed, ksub=self.ksub,
        )
        if self.rescore_k > 0:
            kind = self.rescore_kind
            if kind == "host_f16":
                self._host_f16 = v.to(torch.float16).cpu().numpy()
            elif kind == "host_int8":
                # the flat int8 quantizer: one percentile-clipped scale
                codes, scale = quantize_global_int8(v)
                self._host_codes = codes.cpu().numpy()
                self._host_scale = float(scale.item())
            elif kind == "int4":
                self._int4 = build_int4_tier(v, self._listing.centroids)
            elif kind == "pq8":
                self._tier = build_pq_tier(
                    v, self._listing.centroids, self.rescore_pq_m,
                    train_size=train_size, pq_iters=pq_iters, seed=seed,
                    generator=torch.Generator(device=self.device).manual_seed(seed + 1),
                )
            else:
                self._vectors = v.to(torch.bfloat16)
        self.ntotal = n
        self._loaded = True

    def search(
        self, queries, k: int, *, scan=ivfpq4_adc_scores
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores [B,k] f32, ids [B,k] i32) on the index's device. `scan`
        is the PQ4 bucket scan (the K6 wrapper; its plain version to compare
        on the card)."""
        if not self._loaded:
            raise RuntimeError("ivf_pq index not loaded")
        q = validate_queries(queries, self.dim, self.device).float()
        if self._rotation is not None:
            require_full_f32(q)
            q = q @ self._rotation

        def adc(kk):
            if self.ksub == 16:
                return ivfpq4_search_dedup(
                    self._listing, q, kk, nprobe=self.nprobe, scan=scan
                )
            return ivfpq_search(self._listing, q, kk, nprobe=self.nprobe)

        if not self.rescore_k:
            return adc(k)
        shortlist = max(k, self.rescore_k)
        s, i = adc(shortlist)
        if self._host_f16 is not None:
            out = _host_rescore(q, self._host_f16, 1.0, i, k, -np.inf)
        elif self._host_codes is not None:
            out = _host_rescore(q, self._host_codes, self._host_scale, i, k, NEG_INF)
        elif self._int4 is not None:
            return int4_tier_rescore_topk(q, s, i, self._int4, k)
        elif self._tier is not None:
            return pq_tier_rescore_topk(q, s, i, self._tier, k)
        elif self._vectors is not None:
            return _exact_rescore(q, self._vectors, i, k)
        else:
            return s, i
        return tuple(torch.from_numpy(a).to(self.device) for a in out)

    def save(self, path: str) -> None:
        if not self._loaded:
            raise RuntimeError("nothing to save")
        lst = self._listing
        extra = {}
        if self._vectors is not None:
            extra["vectors"] = self._vectors.float().cpu().numpy()
        if self._tier is not None:
            extra["tier_codebooks"] = self._tier.codebooks.cpu().numpy()
            extra["tier_codes"] = self._tier.codes.cpu().numpy()
            extra["tier_assign"] = self._tier.assign.cpu().numpy()
        if self._int4 is not None:
            extra["int4_codes"] = self._int4.codes.cpu().numpy()
            extra["int4_scale"] = self._int4.row_scale.cpu().numpy()
            extra["int4_assign"] = self._int4.assign.cpu().numpy()
        if self._host_codes is not None:
            extra["host_codes"] = self._host_codes
            extra["host_scale"] = np.float32(self._host_scale)
        if self._host_f16 is not None:
            extra["host_f16"] = self._host_f16
        if self._rotation is not None:
            extra["rotation"] = self._rotation.cpu().numpy()
        save_npz(
            path,
            kind=self.kind,
            dim=self.dim,
            nlist=self.nlist,
            m=self.m,
            nprobe=self.nprobe,
            ntotal=self.ntotal,
            cap_factor=self.cap_factor,
            rescore_k=self.rescore_k,
            ksub=self.ksub,
            centroids=lst.centroids.cpu().numpy(),
            codebooks=lst.codebooks.cpu().numpy(),
            code_buckets=lst.code_buckets.cpu().numpy(),
            ids=lst.ids.cpu().numpy(),
            list_sizes=lst.list_sizes.cpu().numpy(),
            **extra,
        )

    @classmethod
    def _load(cls, path: str, device: Optional[torch.device] = None) -> "IVFPQIndex":
        with np.load(path, allow_pickle=False) as z:
            idx = cls(
                int(z["dim"]),
                int(z["nlist"]),
                int(z["m"]),
                nprobe=int(z["nprobe"]),
                cap_factor=float(z["cap_factor"]),
                rescore_k=int(z["rescore_k"]),
                ksub=int(z["ksub"]) if "ksub" in z else 256,
                device=device,
            )
            dev = idx.device

            def put(name, dtype=None):
                t = torch.from_numpy(z[name])
                return t.to(dev) if dtype is None else t.to(dev, dtype)

            idx._listing = IVFPQListing(
                centroids=put("centroids", torch.float32),
                codebooks=put("codebooks", torch.float32),
                code_buckets=put("code_buckets", torch.uint8),
                ids=put("ids", torch.int32),
                list_sizes=put("list_sizes", torch.int32),
            )
            if "vectors" in z:
                # f32 on disk -> bf16 on the host, then one upload
                idx._vectors = torch.from_numpy(z["vectors"]).to(torch.bfloat16).to(dev)
            if "tier_codes" in z:
                # the tier shares the listing's coarse centroids
                idx._tier = PQFlatTier(
                    centroids=idx._listing.centroids,
                    codebooks=put("tier_codebooks", torch.float32),
                    codes=put("tier_codes", torch.uint8),
                    assign=put("tier_assign", torch.int32),
                )
                idx.rescore_kind = "pq8"
                idx.rescore_pq_m = int(z["tier_codes"].shape[1])
            if "int4_codes" in z:
                idx._int4 = Int4ResidualTier(
                    centroids=idx._listing.centroids,
                    codes=put("int4_codes", torch.uint8),
                    row_scale=put("int4_scale", torch.float16),
                    assign=put("int4_assign", torch.int32),
                )
                idx.rescore_kind = "int4"
            if "host_codes" in z:
                idx._host_codes = np.ascontiguousarray(z["host_codes"])
                idx._host_scale = float(z["host_scale"])
                idx.rescore_kind = "host_int8"
            if "host_f16" in z:
                idx._host_f16 = np.ascontiguousarray(z["host_f16"])
                idx.rescore_kind = "host_f16"
            if "rotation" in z:
                idx._rotation = put("rotation", torch.float32)
            idx.ntotal = int(z["ntotal"])
            idx._loaded = True
        return idx

    def unload(self) -> None:
        self._listing = None
        self._vectors = None
        self._tier = None
        self._int4 = None
        self._host_codes = None
        self._host_f16 = None
        self._rotation = None
        self._loaded = False
        self.ntotal = 0


def _host_rescore(
    q: torch.Tensor,
    store: np.ndarray,
    scale: float,
    ids: torch.Tensor,
    k: int,
    invalid: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Host re-score of a device shortlist against a host-RAM store (int8
    codes with one scale, or f16 originals with scale 1), as the
    reference's numpy fallbacks compute it: a float32 gather, an einsum,
    `invalid` at id -1 (NEG_INF for int8, -inf for f16), `argpartition`
    then a descending `argsort`."""
    qn = q.cpu().numpy().astype(np.float32)
    ids_n = ids.cpu().numpy()
    cand = store[np.clip(ids_n, 0, None)].astype(np.float32)  # [B, S, D]
    s = np.einsum("bsd,bd->bs", cand, qn)
    if scale != 1.0:
        s = s * scale
    s = np.where(ids_n >= 0, s, invalid)
    k = min(k, s.shape[1])
    sel = np.argpartition(-s, k - 1, axis=1)[:, :k]
    ss = np.take_along_axis(s, sel, axis=1)
    order = np.argsort(-ss, axis=1)
    top_s = np.take_along_axis(ss, order, axis=1)
    top_i = np.take_along_axis(np.take_along_axis(ids_n, sel, axis=1), order, axis=1)
    return top_s, top_i


def _exact_rescore(
    q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-score against the bf16 vectors: the query is cast to bf16
    (as the reference's `_rescore_kernel`), products exact in f32, f32
    sums; NEG_INF at id -1; stable top-k."""
    cand = vectors[ids.clamp(min=0).long()].float()  # [B, S, D]
    s = torch.einsum("bsd,bd->bs", cand, q.to(vectors.dtype).float())
    s = torch.where(ids >= 0, s, NEG_INF)
    top_s, sel = _topk(s, min(k, s.shape[1]))
    return top_s, torch.gather(ids, 1, sel)
