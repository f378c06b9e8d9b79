"""Local-peak operations on heatmaps (counterpart of vatl4pose_tpu/ops/
peaks.py: `max_filter2d`, `localpeak_mean`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_filter2d", "localpeak_mean"]


def max_filter2d(x, size: int, pad_value: float = 0.0):
    """Sliding-window max over the last two dims with constant padding ==
    scipy.ndimage.maximum_filter(x, size, mode='constant', cval=pad_value)
    per 2-D slice.  The border is the constant, not -inf."""
    r = size // 2
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    x4 = F.pad(x4, (r, r, r, r), value=pad_value)
    return F.max_pool2d(x4, size, stride=1).reshape(lead + x.shape[-2:])


def localpeak_mean(hms, filter_size: int = 3, order: float = 0.5):
    """Mean of all kept local-peak values over the K maps of each sample.

    hms: (..., K, H, W) -> (...,) float32 (local_peak.py:12-22).  Per map:
    peaks = {p : x[p] == maxfilt(x)[p]} with a constant-0 border, kept if
    x[p] >= max(x) * order — the global max, negative ones included.  The
    mean pools the kept peaks of all K maps of a sample.
    """
    mf = max_filter2d(hms, filter_size, 0.0)
    is_peak = hms == mf
    hf = hms.to(torch.float32)
    gmax = hf.amax(dim=(-2, -1), keepdim=True)
    keep = is_peak & (hf >= gmax * order)
    s = torch.where(keep, hf, 0.0).sum(dim=(-3, -2, -1))
    c = keep.sum(dim=(-3, -2, -1))
    return s / c.clamp(min=1)
