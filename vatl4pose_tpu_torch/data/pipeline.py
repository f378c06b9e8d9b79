"""Static-shape batching helpers (counterpart of vatl4pose_tpu/data/
pipeline.py: `pad_to` and `bucket_size` only).

Eager PyTorch does not recompile per shape, so the scoring engine does not
pad stage 2 to a bucket; the helpers stay for callers that want fixed
batch shapes (for example a CUDA graph of one chunk)."""

from __future__ import annotations

import numpy as np

__all__ = ["pad_to", "bucket_size"]


def pad_to(arr: np.ndarray, n: int, axis: int = 0):
    """Pad along axis to length n with zeros (static-shape batching)."""
    pad = n - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def bucket_size(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)):
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024
