"""Index persistence and shared checks: the JAX package's `.npz` artifact
format, the load dispatch on its declared `kind` (flat, ivf_flat, ivf_pq), the
storage dtypes and the query validation of `index/base.py`."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def storage_dtype(name: str) -> torch.dtype:
    """Vector storage dtype by name. float16 is refused: the scan kernels
    read bf16 or f32 words."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported index storage dtype {name!r}: the port stores "
            f"{sorted(_DTYPES)} vectors (or int8 codes in a flat index)"
        ) from None


def check_metric(metric: str) -> None:
    if metric not in ("ip", "l2"):
        raise ValueError(f"metric must be ip|l2, got {metric!r}")


def validate_queries(q, dim: int, device: torch.device) -> torch.Tensor:
    """[B, dim] floating queries on `device` (a 1-D query becomes B=1)."""
    q = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.array(q))
    if q.dim() == 1:
        q = q[None, :]
    if q.dim() != 2:
        raise ValueError(f"queries must be [B, dim], got shape {tuple(q.shape)}")
    if q.shape[1] != dim:
        raise ValueError(f"query dim {q.shape[1]} != index dim {dim}")
    if not q.is_floating_point():
        raise ValueError(f"queries must be floating, got {q.dtype}")
    return q.to(device)


def save_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the temp name ends in .npz so np.savez appends no second extension
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_index(
    path: str, device: Optional[torch.device] = None,
    *, rescore_store: Optional[str] = None, mesh=None,
):
    """Load an index artifact written by either package. `rescore_store`
    ("device" | "host") places a flat int8 artifact's rescore copy, as a
    deployment chooses (reference `index/base.py:91-118`); other kinds
    ignore it. `mesh` (a `core/mesh.py` MeshContext of dp > 1) shards the
    flat rows, or the IVF lists when nlist % dp == 0, over its positions."""
    from .flat import FlatIndex
    from .ivf_flat import IVFFlatIndex
    from .ivf_pq import IVFPQIndex

    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
    impl = {
        "flat": FlatIndex, "ivf_flat": IVFFlatIndex, "ivf_pq": IVFPQIndex,
    }.get(kind)
    if impl is None:
        raise ValueError(f"unknown index kind {kind!r} in {path}")
    if kind == "flat":
        return impl._load(path, device, rescore_store=rescore_store, mesh=mesh)
    return impl._load(path, device, mesh=mesh)
