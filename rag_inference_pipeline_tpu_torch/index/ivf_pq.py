"""IVF-PQ index: residual product quantization over the bucketed IVF layout,
with an optional re-score of the ADC shortlist.

Port of `rag_inference_pipeline_tpu/index/ivf_pq.py`, with its
search routing: PQ4 (ksub=16) scans through `ivfpq4_search_dedup` (kernel
K6 on the card, its plain version on the CPU, where the reference runs
Pallas in interpret mode), PQ8 through the gather-ADC `ivfpq_search`. With
`rescore_k > 0` the top max(k, rescore_k) ADC candidates are re-scored from
one of five stores (`rescore_kind`):

- "exact": bf16 vectors in device memory; the query is cast to bf16 before
  the product, as the reference's `_rescore_kernel` does;
- "int4" / "pq8": the residual tiers of `ops/pq.py` in device memory;
- "host_int8" / "host_f16": int8 codes (global scale) or f16 originals in
  host RAM, on 2 MB pages where the OS grants them, re-scored by the
  native multithreaded `utils/cpuscan.py::rescore_i8` / `rescore_f16`:
  the reference's route on a host with `g++` (`ivf_pq.py:402-430`). A
  masked slot scores -3.0e38 there; the numpy versions beside them
  (`cpuscan.rescore_*_plain`, the reference's fallback arithmetic) fill
  NEG_INF and -inf.

Artifacts are the reference's `.npz` in both directions, an OPQ rotation
included; `train_add` builds without one.

With a mesh of dp > 1 and nlist % dp == 0 the code buckets are sharded
over dp (`_maybe_shard`, reference `ivf_pq.py:137-147`) and the ADC runs
through `ops/pq.py::sharded_ivfpq_search` (K6 once a shard for PQ4). The
re-score stores are not sharded: the merged shortlist's ids are global and
it lands on the front device, so each store is held once there (on one card
that is the one copy per distinct device; the reference replicates them).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..core.mesh import MeshContext
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
    shard_ivfpq_listing,
    sharded_ivfpq_search,
)
from ..ops.topk import NEG_INF, _topk, quantize_global_int8
from ..utils import cpuscan
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
        mesh: Optional[MeshContext] = None,
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
        if device is None:
            device = mesh.front if mesh is not None else "cpu"
        self.device = torch.device(device)
        self.mesh = mesh
        self.nprobe_local = 0  # sharded: scan slots a shard, 0 = auto
        self._listing: Optional[IVFPQListing] = None
        self._shards: Optional[list[IVFPQListing]] = None  # when sharded
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
                cpuscan.madvise_hugepage(self._host_f16)
            elif kind == "host_int8":
                # the flat int8 quantizer: one percentile-clipped scale
                codes, scale = quantize_global_int8(v)
                self._host_codes = codes.cpu().numpy()
                self._host_scale = float(scale.item())
                cpuscan.madvise_hugepage(self._host_codes)
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
        self._maybe_shard()
        self._loaded = True

    def _maybe_shard(self) -> None:
        """Shard the lists over dp when the mesh has dp > 1 and nlist % dp
        == 0; the whole listing is dropped for its shards. The re-score
        tiers keep the whole listing's centroids (views of the same rows)."""
        if self.mesh is not None and self.mesh.dp > 1 and self.nlist % self.mesh.dp == 0:
            self._shards = shard_ivfpq_listing(self.mesh, self._listing)
            self._listing = None

    def listing(self) -> IVFPQListing:
        """The whole listing: the one on the device, or the shards joined on
        the host (codebooks from the front position)."""
        if self._shards is None:
            return self._listing
        g = self.mesh.gather_rows
        sh = self._shards
        return IVFPQListing(
            centroids=g([x.centroids for x in sh]), codebooks=sh[0].codebooks.cpu(),
            code_buckets=g([x.code_buckets for x in sh]), ids=g([x.ids for x in sh]),
            list_sizes=g([x.list_sizes for x in sh]),
        )

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
            if self._shards is not None:
                return sharded_ivfpq_search(
                    self.mesh, self._shards, q, kk, nprobe=self.nprobe,
                    nprobe_local=self.nprobe_local, scan=scan,
                )
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
            out = cpuscan.rescore_f16(_host(q), self._host_f16, _host(i), k)
        elif self._host_codes is not None:
            out = cpuscan.rescore_i8(
                _host(q), self._host_codes, self._host_scale, _host(i), k
            )
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
        lst = self.listing()
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
    def _load(
        cls, path: str, device: Optional[torch.device] = None,
        mesh: Optional[MeshContext] = None,
    ) -> "IVFPQIndex":
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
                mesh=mesh,
            )
            dev = idx.device

            def put(name, dtype=None, where=dev):
                t = torch.from_numpy(z[name])
                return t.to(where) if dtype is None else t.to(where, dtype)

            # sharded: the lists go from the host straight to their positions
            lists = "cpu" if mesh is not None and mesh.dp > 1 and idx.nlist % mesh.dp == 0 else dev
            idx._listing = IVFPQListing(
                centroids=put("centroids", torch.float32),
                codebooks=put("codebooks", torch.float32),
                code_buckets=put("code_buckets", torch.uint8, lists),
                ids=put("ids", torch.int32, lists),
                list_sizes=put("list_sizes", torch.int32, lists),
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
                cpuscan.madvise_hugepage(idx._host_codes)
                idx._host_scale = float(z["host_scale"])
                idx.rescore_kind = "host_int8"
            if "host_f16" in z:
                idx._host_f16 = np.ascontiguousarray(z["host_f16"])
                cpuscan.madvise_hugepage(idx._host_f16)
                idx.rescore_kind = "host_f16"
            if "rotation" in z:
                idx._rotation = put("rotation", torch.float32)
            idx.ntotal = int(z["ntotal"])
            idx._maybe_shard()
            idx._loaded = True
        return idx

    def unload(self) -> None:
        self._listing = None
        self._shards = None
        self._vectors = None
        self._tier = None
        self._int4 = None
        self._host_codes = None
        self._host_f16 = None
        self._rotation = None
        self._loaded = False
        self.ntotal = 0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


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
