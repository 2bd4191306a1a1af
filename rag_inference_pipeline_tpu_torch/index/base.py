"""Index persistence: the JAX package's `.npz` artifact format and the load
dispatch on its declared `kind` (only `flat` is ported so far)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def save_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the temp name ends in .npz so np.savez appends no second extension
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_index(path: str, device: Optional[torch.device] = None):
    """Load an index artifact written by either package."""
    from .flat import FlatIndex

    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
    if kind != "flat":
        raise ValueError(
            f"index kind {kind!r} in {path}: the port loads 'flat' only"
        )
    return FlatIndex._load(path, device)
