"""Local-peak operations on heatmaps (counterpart of vatl4pose_tpu/ops/
peaks.py: `max_filter2d`, `localpeak_mean`, `peak_local_max_topk`,
`compute_mpe`, `compute_margin`, `compute_entropy`).

The top-k peak scan runs over every map of a batch at once: one window max
over all N·K maps, then `num_peaks` rounds of argmax and Chebyshev
suppression on the whole batch.  Its window starts at 0, as the JAX
package's `lax.reduce_window` with init value 0 does, so a local maximum
below 0 is never a peak candidate there (scipy's filter, and the port's
`max_filter2d`, give the window's own max; ROADMAP C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_filter2d", "localpeak_mean", "peak_local_max_topk",
           "compute_mpe", "compute_margin", "compute_entropy"]

_NEG = -3.4e38   # below every f32 heatmap value: "no candidate"


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


def _first_argmax(flat):
    """Row-wise argmax, the first index on ties (jnp.argmax's order;
    torch.argmax documents none on CUDA), and the max."""
    vals = flat.amax(dim=-1)
    pos = torch.arange(flat.shape[-1], device=flat.device)
    idx = torch.where(flat == vals[:, None], pos, flat.shape[-1]).amin(dim=-1)
    return idx, vals


def peak_local_max_topk(hms, min_distance: int = 5, num_peaks: int = 5):
    """Top-k local peaks of every map, descending, as skimage's
    peak_local_max(min_distance=5, num_peaks=5) in the reference
    (ActiveLearning.py:770, :784), batched:
      * candidate = a pixel equal to its 11x11 window max, the window
        starting at 0 (JAX's reduce_window), and strictly above the map's
        global min, at least `min_distance` from the border;
      * `num_peaks` rounds of argmax (first index on ties) and Chebyshev
        suppression around the pick.

    hms: (..., H, W).  Returns vals (..., num_peaks) f32, valid (...,
    num_peaks) bool and the integer peak rows and columns (..., num_peaks)
    (row 0, column 0 where a round found no candidate)."""
    lead = hms.shape[:-2]
    H, W = hms.shape[-2:]
    hm = hms.to(torch.float32).reshape(-1, H, W)
    dev = hm.device
    size = 2 * min_distance + 1
    mf = F.max_pool2d(hm[:, None], size, stride=1,
                      padding=min_distance)[:, 0].clamp(min=0.0)
    gmin = hm.amin(dim=(-2, -1), keepdim=True)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    border = ((yy >= min_distance) & (yy < H - min_distance)
              & (xx >= min_distance) & (xx < W - min_distance))
    cand = torch.where((hm == mf) & (hm > gmin) & border, hm, _NEG)
    cand = cand.reshape(hm.shape[0], H * W)
    ys = torch.arange(H * W, device=dev) // W
    xs = torch.arange(H * W, device=dev) % W
    vals, pys, pxs = [], [], []
    for _ in range(num_peaks):
        idx, val = _first_argmax(cand)
        py, px = idx // W, idx % W
        supp = (((ys[None] - py[:, None]).abs() <= min_distance)
                & ((xs[None] - px[:, None]).abs() <= min_distance))
        cand = torch.where(supp, _NEG, cand)
        vals.append(val)
        pys.append(py)
        pxs.append(px)
    vals = torch.stack(vals, dim=-1)
    shape = lead + (num_peaks,)
    return (vals.reshape(shape), (vals > _NEG / 2).reshape(shape),
            torch.stack(pys, dim=-1).reshape(shape),
            torch.stack(pxs, dim=-1).reshape(shape))


def compute_mpe(hms, min_distance: int = 5, num_peaks: int = 5):
    """Multiple-peak entropy (ActiveLearning.py:762-778).  hms:
    (..., K, H, W) -> (...,): per joint map the entropy of the softmax
    over its top-5 peak values, summed over joints (a map without a peak
    adds 0)."""
    vals, valid, _, _ = peak_local_max_topk(hms, min_distance, num_peaks)
    p = torch.softmax(torch.where(valid, vals, float("-inf")), dim=-1)
    p = torch.where(valid, p, 0.0)
    ent = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=-1)
    ent = torch.where(valid.any(dim=-1), ent, 0.0)
    return ent.sum(dim=-1)


def compute_margin(hms, min_distance: int = 5, num_peaks: int = 5):
    """Top-2 peak margin (ActiveLearning.py:780-788): |peak0 - peak1|
    summed over joints; a map with fewer than 2 peaks adds 0."""
    vals, valid, _, _ = peak_local_max_topk(hms, min_distance, num_peaks)
    m = (vals[..., 0] - vals[..., 1]).abs()
    return torch.where(valid[..., 1], m, 0.0).sum(dim=-1)


def compute_entropy(hms):
    """Flat-heatmap entropy (ActiveLearning.py:790-796), scipy.stats.
    entropy per joint map: p = map / sum, the sum of entr(p) with
    entr(p < 0) = -inf, as the JAX package keeps it; summed over joints."""
    hf = hms.to(torch.float32)
    flat = hf.reshape(hf.shape[:-2] + (-1,))
    p = flat / flat.sum(dim=-1, keepdim=True)
    entr = torch.where(p > 0, -p * torch.log(p),
                       torch.where(p == 0, 0.0, float("-inf")))
    return entr.sum(dim=(-2, -1))
