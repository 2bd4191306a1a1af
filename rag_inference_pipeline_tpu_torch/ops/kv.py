"""In-place KV-cache row write (kernel K7).

Port of the decode-anatomy probe's Pallas row insert
(`scripts/bench_decode_anatomy.py::_row_insert_kernel`): `cache[b,
pos[b]] = new[b]` for every lane, in place. On CUDA tensors
`kv_row_insert` launches the hand-written kernel in `csrc/kv_row_insert.cu`
(or raises); on CPU tensors it runs `kv_row_insert_plain`, its oracle.

A position outside [0, S) writes the nearest row, S-1 past the end: the
Pallas kernel's clamped block index in interpret mode, and the clamp of
the port's decode insert (`models/qwen.py::_block`). The model's decode
step does not use this kernel, as the reference's does not; the probe does.
"""

from __future__ import annotations

import torch


def kv_row_insert_plain(
    cache: torch.Tensor,  # [B, S, H, D], written in place
    new: torch.Tensor,  # [B, H, D]
    positions: torch.Tensor,  # [B] int
) -> torch.Tensor:
    """Plain PyTorch version of K7, on any device; returns `cache`."""
    b, s = cache.shape[:2]
    pos = torch.clamp(positions.long(), 0, s - 1)
    cache[torch.arange(b, device=cache.device), pos] = new.to(cache.dtype)
    return cache


def kv_row_insert(
    cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """cache[b, clamp(pos[b], 0, S-1)] = new[b] in place; returns `cache`.

    The positions stay on the device: the kernel reads them there, so the
    host never waits. On CUDA tensors this launches csrc/kv_row_insert.cu
    (or raises); on CPU tensors it runs `kv_row_insert_plain`."""
    if cache.dim() != 4 or new.dim() != 3 or positions.dim() != 1:
        raise ValueError("cache must be [B, S, H, D], new [B, H, D], positions [B]")
    b, s = cache.shape[:2]
    if new.shape != (b, *cache.shape[2:]) or positions.shape[0] != b:
        raise ValueError(
            f"shapes disagree: cache {tuple(cache.shape)}, new "
            f"{tuple(new.shape)}, positions {tuple(positions.shape)}"
        )
    devs = {cache.device, new.device, positions.device}
    if devs == {torch.device("cpu")}:
        return kv_row_insert_plain(cache, new, positions)
    if len(devs) != 1 or cache.device.type != "cuda":
        raise ValueError(f"kv_row_insert: tensors on {sorted(map(str, devs))}: "
                         "all must be on one CUDA device (or all on the CPU)")
    if new.dtype != cache.dtype:
        raise TypeError(f"new rows are {new.dtype}, the cache {cache.dtype}")
    if positions.dtype != torch.int32:
        raise TypeError(f"positions must be int32, not {positions.dtype}")
    row_bytes = new[0].numel() * new.element_size()
    for t in (cache, new):
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError("cache and new must be contiguous and 16-byte aligned")
    if row_bytes % 16 != 0:
        raise ValueError(f"the kernel copies 16-byte words: a row is {row_bytes} bytes")
    if not positions.is_contiguous():
        raise ValueError("positions must be contiguous")
    if b == 0:
        return cache
    from . import _kernels

    lib = _kernels.load_library()
    with torch.cuda.device(cache.device):
        stream = torch.cuda.current_stream(cache.device).cuda_stream
        rc = lib.ragtorch_kv_row_insert(
            cache.data_ptr(), new.data_ptr(), positions.data_ptr(),
            b, s, row_bytes, stream,
        )
    if rc != 0:
        raise RuntimeError(f"kv_row_insert launch failed: cudaError {rc}")
    kv_row_insert.launches += 1
    return cache


kv_row_insert.launches = 0  # kernel launches, for chip_smoke.py
