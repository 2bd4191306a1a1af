"""Shape bucketing: dynamic request batches are padded up a fixed bucket
ladder, as `rag_inference_pipeline_tpu/utils/shapes.py` pads them (the
query scale of the int8 scan is batch-wide, so the padding changes ids
and must be the reference's)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket caps oversize batches."""
    if n <= 0:
        raise ValueError("n must be positive")
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def chunk_spans(n: int, max_chunk: int) -> list[tuple[int, int]]:
    """Split [0, n) into spans of at most max_chunk rows."""
    return [(s, min(s + max_chunk, n)) for s in range(0, n, max_chunk)]


def pad_rows(arr: np.ndarray, bucket: int, pad_value=0) -> np.ndarray:
    """Pad axis 0 of a numpy array up to `bucket` rows (always a new
    array, so callers may write into the padded rows)."""
    n = arr.shape[0]
    if n > bucket:
        raise ValueError(f"batch {n} exceeds bucket {bucket}")
    pad = [(0, bucket - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=pad_value)
