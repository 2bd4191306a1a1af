"""In-place KV-cache row write (kernel K7).

Port of the decode-anatomy probe's Pallas row insert
(`scripts/bench_decode_anatomy.py::_row_insert_kernel`): `cache[b,
pos[b]] = new[b]` for every lane, in place. `kv_row_insert` writes one
cache, as the reference's kernel does; `kv_row_insert_pair` writes a
layer's K and V caches in one launch of the same kernel. On CUDA tensors
both launch `csrc/kv_row_insert.cu` (or raise); on CPU tensors they run
`kv_row_insert_plain` / `kv_row_insert_pair_plain`, their oracles.

A position lands where the Pallas kernel's block index puts it in
interpret mode (`lax.dynamic_update_slice`): one below 0 counts from the
end once (-1 is row S-1), then the row is clamped to [0, S-1], so a
position past the end writes row S-1, as the port's decode insert
(`models/qwen.py::_block`) does. The model's decode step does not use this
kernel, as the reference's does not; the probe does.

The wrappers sit on a per-layer decode path, so their checks come
cheapest first, compare shapes as tuples and read each data pointer once;
the launch goes through `_kernels.launch`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernels


def kv_row_insert_plain(
    cache: torch.Tensor,  # [B, S, H, D], written in place
    new: torch.Tensor,  # [B, H, D]
    positions: torch.Tensor,  # [B] int
) -> torch.Tensor:
    """Plain PyTorch version of K7, on any device; returns `cache`."""
    b, s = cache.shape[:2]
    pos = positions.long()
    pos = torch.clamp(torch.where(pos < 0, pos + s, pos), 0, s - 1)
    cache[torch.arange(b, device=cache.device), pos] = new.to(cache.dtype)
    return cache


def kv_row_insert_pair_plain(
    cache_k: torch.Tensor, cache_v: torch.Tensor, new_k: torch.Tensor,
    new_v: torch.Tensor, positions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the K7 pair: two plain inserts at the same
    positions; returns (cache_k, cache_v)."""
    return (kv_row_insert_plain(cache_k, new_k, positions),
            kv_row_insert_plain(cache_v, new_v, positions))


def _check(what: str, cache_k: torch.Tensor, cache_v: torch.Tensor,
           new_k: torch.Tensor, new_v: torch.Tensor,
           positions: torch.Tensor) -> Optional[tuple[int, ...]]:
    """Validates a pair insert, cheapest checks first; the single insert
    passes its cache and rows as both sides. Returns None when every
    tensor lies on the CPU (run the plain version), else the launch's
    arguments: (device index, the caches', new rows' and positions' data
    pointers, B, S, row bytes). Raises on anything the kernel does not
    take. Written out tensor by tensor: on the decode path every
    attribute read costs host time."""
    shape, nshape = cache_k.shape, new_k.shape
    if (len(shape) != 4 or nshape != (shape[0], shape[2], shape[3])
            or positions.shape != (shape[0],) or cache_v.shape != shape
            or new_v.shape != nshape):
        raise ValueError(
            f"{what}: shapes disagree: caches {tuple(shape)}, {tuple(cache_v.shape)} "
            f"must be one [B, S, H, D], new rows {tuple(nshape)}, "
            f"{tuple(new_v.shape)} [B, H, D], positions {tuple(positions.shape)} [B]"
        )
    dtype = cache_k.dtype
    if new_k.dtype != dtype or cache_v.dtype != dtype or new_v.dtype != dtype:
        raise TypeError(f"{what}: new rows and caches must share one dtype, not "
                        f"{dtype}, {cache_v.dtype}, {new_k.dtype}, {new_v.dtype}")
    if not cache_k.is_cuda:
        if (cache_k.is_cpu and cache_v.is_cpu and new_k.is_cpu and new_v.is_cpu
                and positions.is_cpu):
            return None
        raise ValueError(f"{what}: all tensors must be on one CUDA device (or all "
                         "on the CPU)")
    index = cache_k.get_device()
    if not (cache_v.is_cuda and new_k.is_cuda and new_v.is_cuda and positions.is_cuda
            and cache_v.get_device() == index and new_k.get_device() == index
            and new_v.get_device() == index and positions.get_device() == index):
        raise ValueError(f"{what}: all tensors must be on one CUDA device (or all "
                         "on the CPU)")
    if positions.dtype != torch.int32 or not positions.is_contiguous():
        raise TypeError(f"{what}: positions must be contiguous int32, not "
                        f"{positions.dtype}")
    ck, cv = cache_k.data_ptr(), cache_v.data_ptr()
    nk, nv = new_k.data_ptr(), new_v.data_ptr()
    if (ck | cv | nk | nv) % 16 or not (
            cache_k.is_contiguous() and cache_v.is_contiguous()
            and new_k.is_contiguous() and new_v.is_contiguous()):
        raise ValueError(f"{what}: caches and new rows must be contiguous and "
                         "16-byte aligned")
    row_bytes = shape[2] * shape[3] * cache_k.element_size()
    if row_bytes % 16:
        raise ValueError(f"{what}: the kernel copies 16-byte words: a row of "
                         f"{shape[2]} x {shape[3]} {dtype} is not")
    return index, ck, cv, nk, nv, positions.data_ptr(), shape[0], shape[1], row_bytes


def kv_row_insert(
    cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """cache[b, row(pos[b])] = new[b] in place (the row as the module
    docstring places it); returns `cache`.

    The positions stay on the device: the kernel reads them there, so the
    host never waits. On CUDA tensors this launches csrc/kv_row_insert.cu
    (or raises); on CPU tensors it runs `kv_row_insert_plain`."""
    args = _check("kv_row_insert", cache, cache, new, new, positions)
    if args is None:
        return kv_row_insert_plain(cache, new, positions)
    index, ck, _, nk, _, pos, b, s, row_bytes = args
    if b:
        _kernels.launch("ragtorch_kv_row_insert", index, ck, None, nk, None, pos,
                        b, s, row_bytes)
        kv_row_insert.launches += 1
    return cache


def kv_row_insert_pair(
    cache_k: torch.Tensor, cache_v: torch.Tensor, new_k: torch.Tensor,
    new_v: torch.Tensor, positions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both caches of a layer in one launch: cache_k[b, p] = new_k[b] and
    cache_v[b, p] = new_v[b], p = row(pos[b]) as for `kv_row_insert`, in
    place; returns (cache_k, cache_v). On CUDA tensors this launches
    csrc/kv_row_insert.cu once (or raises); on CPU tensors it runs
    `kv_row_insert_pair_plain`."""
    args = _check("kv_row_insert_pair", cache_k, cache_v, new_k, new_v, positions)
    if args is None:
        return kv_row_insert_pair_plain(cache_k, cache_v, new_k, new_v, positions)
    if args[6]:
        _kernels.launch("ragtorch_kv_row_insert", *args)
        kv_row_insert_pair.launches += 1
    return cache_k, cache_v


kv_row_insert.launches = 0  # kernel launches, for chip_smoke.py
kv_row_insert_pair.launches = 0
