"""Heatmap decoding on tensors (counterpart of vatl4pose_tpu/ops/
heatmap.py: `get_max_pred`, `subpixel_refine`, `heatmap_to_coord`).

Layout: (..., K, H, W) at the public API (H=64, W=48 for the shipped
configs).
"""

from __future__ import annotations

import torch

from .affine import transform_preds

__all__ = ["get_max_pred", "subpixel_refine", "heatmap_to_coord",
           "crop_to_image"]


def get_max_pred(hms):
    """Per-joint argmax decode.  hms: (..., K, H, W).

    Returns coords (..., K, 2) float (x, y) and maxvals (..., K).
    Row-major flat argmax, first max wins (transforms.py:710-727), written
    as the minimum flat index among the maxima: `torch.argmax` documents no
    tie order on CUDA.  Coords are zeroed where maxval <= 0.
    """
    W = hms.shape[-1]
    flat = hms.reshape(hms.shape[:-2] + (-1,))
    maxvals = flat.amax(dim=-1)
    pos = torch.arange(flat.shape[-1], device=hms.device)
    idx = torch.where(flat == maxvals[..., None], pos,
                      flat.shape[-1]).amin(dim=-1)
    x = (idx % W).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / W)
    coords = torch.stack([x, y], dim=-1)
    coords = coords * (maxvals > 0.0)[..., None]
    return coords, maxvals


def subpixel_refine(hms, coords):
    """±0.25 gradient-sign subpixel shift (transforms.py:561-568), applied
    only when 1 < px < W-1 and 1 < py < H-1 (strict) on the rounded
    coords."""
    H, W = hms.shape[-2], hms.shape[-1]
    px = torch.round(coords[..., 0]).to(torch.long)
    py = torch.round(coords[..., 1]).to(torch.long)
    ok = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
    pxc = px.clamp(1, W - 2)
    pyc = py.clamp(1, H - 2)
    flat = hms.reshape(hms.shape[:-2] + (-1,))

    def gather(yy, xx):
        return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

    dx = gather(pyc, pxc + 1) - gather(pyc, pxc - 1)
    dy = gather(pyc + 1, pxc) - gather(pyc - 1, pxc)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return coords + shift * ok[..., None].to(coords.dtype)


def crop_to_image(coords, bbox_xyxy, hm_size):
    """Heatmap-space coords (..., K, 2) -> image space through the crop box
    (..., 4) it was warped from (transforms.py:550-583).  hm_size: (W, H)."""
    bbox = bbox_xyxy.to(torch.float32)
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    center = torch.stack([bbox[..., 0] + 0.5 * w, bbox[..., 1] + 0.5 * h],
                         dim=-1)
    scale = torch.stack([w, h], dim=-1)
    return transform_preds(coords, center, scale, hm_size)


def heatmap_to_coord(hms, bbox_xyxy):
    """Full decode: argmax → subpixel → inverse-affine back-projection.
    Returns (coords (..., K, 2) in image space, scores (..., K)); all
    arithmetic in f32 (bf16 heatmaps are upcast exactly)."""
    hms = hms.to(torch.float32)
    H, W = hms.shape[-2], hms.shape[-1]
    coords, maxvals = get_max_pred(hms)
    coords = subpixel_refine(hms, coords)
    return crop_to_image(coords, bbox_xyxy, (W, H)), maxvals
