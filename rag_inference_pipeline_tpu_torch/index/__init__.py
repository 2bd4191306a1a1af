"""Indexes of the port: flat (bf16/f32 or int8), IVF-Flat and IVF-PQ."""

from __future__ import annotations

from typing import Optional

import torch


def make_index(settings, device: Optional[torch.device] = None, mesh=None):
    """Settings -> an empty index of the configured kind (the reference's
    `index/__init__.py::make_index`). INDEX_RESCORE_STORE places the
    flat int8 index's rescore copy (bf16 on the card, or f16 in host RAM);
    the IVF kinds ignore it, as in the reference. `mesh` shards the index
    over its dp positions; the IVF kinds take INDEX_NPROBE_LOCAL."""
    from ..core.enums import IndexKind
    from .flat import FlatIndex
    from .ivf_flat import IVFFlatIndex
    from .ivf_pq import IVFPQIndex

    kind = settings.index_kind
    if kind is IndexKind.FLAT:
        # partial-topk bin count: oversample * k, lane-aligned, >= 512
        nbins = max(
            512,
            -(-settings.retrieval_k * settings.index_search_oversample // 128) * 128,
        )
        return FlatIndex(
            settings.index_dim,
            metric=settings.index_metric,
            dtype=settings.index_dtype,
            device=device,
            nbins=min(nbins, 2048),
            rescore_k=settings.index_rescore_k,
            rescore_store=settings.index_rescore_store,
            mesh=mesh,
        )
    if kind is IndexKind.IVF_FLAT:
        idx = IVFFlatIndex(
            settings.index_dim,
            settings.index_nlist,
            metric=settings.index_metric,
            nprobe=settings.index_nprobe,
            dtype=settings.index_dtype,
            device=device,
            cap_factor=settings.index_cap_factor,
            mesh=mesh,
        )
        idx.nprobe_local = settings.index_nprobe_local
        return idx
    idx = IVFPQIndex(
        settings.index_dim,
        settings.index_nlist,
        settings.index_pq_m,
        nprobe=settings.index_nprobe,
        rescore_k=settings.index_pq_rescore_k,
        cap_factor=settings.index_cap_factor,
        # 4-bit codes -> ksub=16, the K6 bucket scan
        ksub=16 if settings.index_pq_bits == 4 else 256,
        rescore_kind=settings.index_pq_rescore_kind,
        device=device,
        mesh=mesh,
    )
    idx.nprobe_local = settings.index_nprobe_local
    return idx
