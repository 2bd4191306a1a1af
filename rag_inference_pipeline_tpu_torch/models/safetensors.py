"""Safetensors checkpoints read and written with numpy alone.

The format: an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}}`, plus an
optional `"__metadata__"` of strings), then the data buffer: every tensor's
raw little-endian bytes, row-major, at its offsets from the buffer's start.

`load_safetensors_dict` replaces the reference's
(`rag_inference_pipeline_tpu/models/weights.py:37-45`), which reads every
tensor of the directory into host memory through the `safetensors`
package. Here only the headers are read when the files open; a tensor is
read from its file (`os.preadv`) when it is asked for, and is never a view
of the file's pages. `load` reads one tensor (or a block of its rows) onto
a device: on the CPU straight into the new tensor, on a CUDA device
through one pinned staging buffer, so that host memory holds one leaf or
the buffer, never the checkpoint. BF16 has no numpy dtype of its own: its
bytes are read as 16-bit integers and viewed as `torch.bfloat16`.
"""

from __future__ import annotations

import json
import math
import os
from collections.abc import Mapping
from typing import Iterator, Optional

import numpy as np
import torch

# format dtype -> (numpy dtype of the stored bytes, torch dtype)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_BY_TORCH = {t: name for name, (_, t) in _DTYPES.items()}
# the pinned host buffer a CUDA load reads the file through
_STAGING_BYTES = 64 << 20


def _find_safetensors(model_dir: str) -> list[str]:
    """Every `*.safetensors` in `model_dir`, sorted (a sharded checkpoint's
    `model-0000k-of-0000n` files in order)."""
    files = sorted(
        os.path.join(model_dir, f)
        for f in os.listdir(model_dir)
        if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"no .safetensors under {model_dir}")
    return files


class SafetensorsFile:
    """One file: its header checked, its tensors read on demand."""

    def __init__(self, path: str) -> None:
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: {size} bytes, shorter than the header length")
            n = int.from_bytes(f.read(8), "little")
            if 8 + n > size:
                raise ValueError(
                    f"{path}: the header of {n} bytes runs past the file's end "
                    f"({size} bytes)"
                )
            header = json.loads(f.read(n))
            if not isinstance(header, dict):
                raise ValueError(f"{path}: the header is not a JSON object")
            self.metadata = header.pop("__metadata__", None) or {}
            self.entries = {k: self._entry(k, v, size - 8 - n) for k, v in header.items()}
            self._check_overlaps()
            self._base = 8 + n
        self._fd = os.open(path, os.O_RDONLY)

    def _entry(self, name: str, e: dict, data_len: int) -> tuple:
        dtype = e.get("dtype")
        if dtype not in _DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r} has unknown dtype {dtype!r}")
        shape = tuple(e.get("shape", ()))
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"{self.path}: tensor {name!r} has shape {shape!r}")
        begin, end = e.get("data_offsets", (None, None))
        nbytes = math.prod(shape) * np.dtype(_DTYPES[dtype][0]).itemsize
        if not (isinstance(begin, int) and isinstance(end, int)
                and 0 <= begin <= end <= data_len):
            raise ValueError(
                f"{self.path}: tensor {name!r} has offsets [{begin}, {end}] out of "
                f"range of the {data_len}-byte data buffer"
            )
        if end - begin != nbytes:
            raise ValueError(
                f"{self.path}: tensor {name!r} spans {end - begin} bytes, but "
                f"{dtype} {list(shape)} needs {nbytes}"
            )
        return dtype, shape, begin, end

    def _check_overlaps(self) -> None:
        spans = sorted((b, e, k) for k, (_, _, b, e) in self.entries.items() if e > b)
        for (_, e0, k0), (b1, _, k1) in zip(spans, spans[1:]):
            if b1 < e0:
                raise ValueError(
                    f"{self.path}: tensors {k0!r} and {k1!r} have overlapping offsets"
                )

    def read_into(self, name: str, out: torch.Tensor,
                  staging: Optional[torch.Tensor] = None, start: int = 0) -> None:
        """Fill `out` (contiguous) with the tensor's bytes from byte `start`
        on: straight from the file into `out` (a CPU tensor) when there is
        no `staging`, else through `staging` (a pinned uint8 host buffer)
        a buffer at a time, which `out` may be on any device."""
        _, _, begin, end = self.entries[name]
        dst = out.reshape(-1).view(torch.uint8)
        if start + dst.numel() > end - begin:
            raise ValueError(f"{self.path}: read past the end of tensor {name!r}")
        host = memoryview((dst if staging is None else staging).numpy())
        pos = 0
        while pos < dst.numel():
            k = min(len(host), dst.numel() - pos)
            buf = host[pos : pos + k] if staging is None else host[:k]
            got = os.preadv(self._fd, [buf], self._base + begin + start + pos)
            if got <= 0:
                raise ValueError(f"{self.path}: the file ends inside tensor {name!r}")
            if staging is not None:
                dst[pos : pos + got].copy_(staging[:got])
            pos += got

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class SafetensorsDict(Mapping):
    """Name -> CPU tensor over every `*.safetensors` file of a directory,
    each read from its file when it is asked for; a name found in two files
    is an error."""

    def __init__(self, paths: list[str]) -> None:
        self.files = [SafetensorsFile(p) for p in paths]
        self._where: dict[str, SafetensorsFile] = {}
        for f in self.files:
            for name in f.entries:
                if name in self._where:
                    raise ValueError(
                        f"tensor {name!r} appears in both {self._where[name].path} "
                        f"and {f.path}"
                    )
                self._where[name] = f
        self._staging: Optional[torch.Tensor] = None

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.load(name, "cpu")

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def shape(self, name: str) -> tuple:
        """The tensor's shape, from its file's header."""
        return self._where[name].entries[name][1]

    def load(self, name: str, device, rows: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """The tensor, or its rows [a, b) along dim 0, read onto `device` in
        its stored dtype: straight into it on the CPU, through the pinned
        staging buffer on a CUDA device."""
        f = self._where[name]
        dtype, shape, _, _ = f.entries[name]
        a, b = rows or (0, shape[0] if shape else 1)
        out = torch.empty((b - a, *shape[1:]) if rows else shape,
                          dtype=_DTYPES[dtype][1], device=device)
        staging = None
        if out.device.type != "cpu":
            if self._staging is None:
                self._staging = torch.empty(min(_STAGING_BYTES, max(self.nbytes, 1)),
                                            dtype=torch.uint8, pin_memory=True)
            staging = self._staging
        row_bytes = math.prod(shape[1:]) * out.element_size()
        f.read_into(name, out, staging, start=a * row_bytes)
        return out

    @property
    def nbytes(self) -> int:
        """The bytes of every tensor in the files."""
        return sum(e - b for f in self.files for _, _, b, e in f.entries.values())

    def close(self) -> None:
        for f in self.files:
            f.close()
        self._staging = None

    def __enter__(self) -> "SafetensorsDict":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_safetensors_dict(model_dir: str) -> SafetensorsDict:
    """The mapping over every `*.safetensors` of `model_dir` (headers
    read, tensors read when asked for)."""
    return SafetensorsDict(_find_safetensors(model_dir))


def _format_dtype(t) -> str:
    """The format's name for a tensor's or array's dtype."""
    if isinstance(t, np.ndarray):
        if t.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as jax hands it over
            return "BF16"
        dtype = torch.from_numpy(np.empty(0, t.dtype)).dtype
    else:
        dtype = t.dtype
    if dtype not in _BY_TORCH:
        raise ValueError(f"safetensors has no dtype for {dtype}")
    return _BY_TORCH[dtype]


def _raw_bytes(t) -> np.ndarray:
    """A tensor's or array's row-major bytes, as a flat uint8 array."""
    if not isinstance(t, np.ndarray):
        t = t.detach().contiguous().cpu()
        t = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8)


def save_safetensors(
    tensors: Mapping, path: str, metadata: Optional[dict[str, str]] = None,
) -> int:
    """Write `tensors` (name -> torch tensor or numpy array) to `path` as
    the `safetensors` package lays a file out: wider dtypes first, then by
    name, with no gaps, the header padded with spaces to 8 bytes so that
    every tensor starts aligned. One tensor is on the host at a time.
    Returns the bytes written."""
    dtypes = {k: _format_dtype(t) for k, t in tensors.items()}
    size = {k: np.dtype(_DTYPES[d][0]).itemsize for k, d in dtypes.items()}
    order = sorted(tensors, key=lambda k: (-size[k], k))
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for k in order:
        n = math.prod(tensors[k].shape) * size[k]
        header[k] = {"dtype": dtypes[k], "shape": list(tensors[k].shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for k in order:
            f.write(_raw_bytes(tensors[k]))
    return 8 + len(raw) + off
