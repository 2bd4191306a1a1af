"""Device-memory stream ceiling (kernel K8).

Port of the kernel lab's Pallas stream kernel
(`scripts/bench_kernel.py::stream_kernel`): `out = q + sum over chunks i <
N // chunk of db[i*chunk : i*chunk+8, 0:128]` as int32. The TPU kernel
DMA'd every [chunk, D] block whatever it read of it; on a GPU only the
bytes a kernel loads move, so the port's kernel reads every byte of the
first `N // chunk * chunk` rows and also returns `checksum`, the int64
sum of every byte read. The plain version computes both, so a kernel that
skipped a load would disagree.

On CUDA tensors `stream_sum` launches `csrc/stream.cu` (or raises); on CPU
tensors it runs `stream_sum_plain`, its oracle.
"""

from __future__ import annotations

import torch

from . import _kernels

CORNER = (8, 128)  # the rows and columns of each chunk that `out` sums


def _check(q: torch.Tensor, db: torch.Tensor, chunk: int) -> int:
    """Validates the shapes; returns the rows streamed, N // chunk * chunk."""
    if q.shape != CORNER or q.dtype != torch.int32:
        raise ValueError(f"q must be int32 {CORNER}, got {q.dtype} {tuple(q.shape)}")
    if db.dim() != 2 or db.dtype != torch.int8:
        raise ValueError(f"db must be 2-D int8, got {db.dtype} {tuple(db.shape)}")
    if db.shape[1] < CORNER[1]:
        raise ValueError(f"db rows must hold {CORNER[1]} columns, not {db.shape[1]}")
    if chunk < CORNER[0]:
        raise ValueError(f"chunk ({chunk}) must hold the {CORNER[0]} corner rows")
    return db.shape[0] // chunk * chunk


def stream_sum_plain(
    q: torch.Tensor, db: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8, on any device. Returns (out [8,128]
    int32, checksum 0-d int64)."""
    rows = _check(q, db, chunk)
    body = db[:rows]
    corners = body.view(rows // chunk, chunk, db.shape[1])[:, : CORNER[0], : CORNER[1]]
    out = q + corners.sum(dim=0, dtype=torch.int32)
    return out, body.sum(dtype=torch.int64)


def stream_sum(
    q: torch.Tensor,  # [8, 128] int32
    db: torch.Tensor,  # [N, D] int8
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The stream kernel: (out [8,128] int32, checksum 0-d int64) over the
    first N // chunk * chunk rows, every byte of which is read once.

    On CUDA tensors this launches csrc/stream.cu (or raises); on CPU
    tensors it runs `stream_sum_plain`."""
    rows = _check(q, db, chunk)
    if q.device.type == "cpu" and db.device.type == "cpu":
        return stream_sum_plain(q, db, chunk)
    if q.device != db.device or db.device.type != "cuda":
        raise ValueError(f"stream_sum: tensors on {q.device} and {db.device}: both "
                         "must be on one CUDA device (or both on the CPU)")
    d = db.shape[1]
    if d % 16 != 0 or not db.is_contiguous() or db.data_ptr() % 16 != 0:
        raise ValueError("the kernel reads 16-byte words: db must be contiguous, "
                         f"16-byte aligned, with D % 16 == 0 (D={d})")
    dev = db.device
    out = q.contiguous().clone()
    checksum = torch.zeros((), dtype=torch.int64, device=dev)
    # one wave of 256-thread blocks (8 per SM), and a block's run of rows
    # below 2^31 words
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(8 * sms, -(-rows * (d // 16) // 2**30))
    _kernels.launch(
        "ragtorch_stream_sum", dev.index, db.data_ptr(), out.data_ptr(),
        checksum.data_ptr(), rows, d, chunk, blocks,
    )
    stream_sum.launches += 1
    return out, checksum


stream_sum.launches = 0  # kernel launches, for chip_smoke.py
