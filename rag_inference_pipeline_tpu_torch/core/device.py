"""Device resolution from the `DEVICE_PLATFORM` setting.

Unset means CUDA: the port is written for the GPU, and asking for it on a
machine without one raises instead of quietly running on the CPU. `cpu` is
an explicit choice (the CPU tests make it).
"""

from __future__ import annotations

from typing import Optional

import torch

_CUDA_NAMES = ("cuda", "gpu")


def resolve_device(platform: Optional[str] = None) -> torch.device:
    """`None`/`cuda`/`gpu` -> `cuda` (raises without a GPU); `cpu` -> `cpu`."""
    name = (platform or "cuda").lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in _CUDA_NAMES:
        raise ValueError(
            f"DEVICE_PLATFORM={platform!r}: the port runs on 'cuda' or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "DEVICE_PLATFORM asks for CUDA but torch.cuda.is_available() is "
            "false; set DEVICE_PLATFORM=cpu to run on the CPU"
        )
    return torch.device("cuda")


def torch_dtype(name: str) -> torch.dtype:
    """`param_dtype` setting -> torch dtype."""
    dtypes = {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }
    if name not in dtypes:
        raise ValueError(f"unsupported param_dtype {name!r}")
    return dtypes[name]
