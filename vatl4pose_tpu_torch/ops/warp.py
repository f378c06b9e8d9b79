"""Person crops + normalization on the device (counterpart of
vatl4pose_tpu/ops/warp.py: `crop_batch` and `RGB_MEAN`).

Every scoring crop is axis-aligned (rot=0), so the bilinear warp with a
constant-0 border is separable: out[n] = Wy[n] @ frames[fi[n]] @ Wx[n]^T
with hat-kernel (tent) weight rows, two batched matrix products.
Out-of-range source coordinates get all-zero weight rows, which is
BORDER_CONSTANT 0 exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .affine import box_to_center_scale, center_scale_to_box, get_affine_transform

__all__ = ["warp_axis_aligned_batch", "crop_batch", "RGB_MEAN"]

# peak-memory cap for the (chunk, H, W, C) gathered-frames buffer: large
# source frames are warped in sub-chunks under it
_WARP_BUDGET_BYTES = 256 * 2 ** 20

# channel means subtracted after /255 (simple_transform.py:94-96), RGB order
RGB_MEAN = np.array([0.406, 0.457, 0.480], dtype=np.float32)


def _hat(s, size):
    i = torch.arange(size, dtype=torch.float32, device=s.device)
    return (1.0 - (s[..., None] - i).abs()).clamp(0.0, 1.0)


def warp_axis_aligned_batch(frames, frame_idx, inv_mats, out_size,
                            dtype=torch.float32):
    """frames: (F, H, W, C) uint8 or float; frame_idx: (N,) long;
    inv_mats: (N, 2, 3) dst->src without rotation.  Returns
    (N, out_h, out_w, C) in `dtype` (bf16 serving stores the gathered
    frames, the weights and both products in bf16)."""
    out_h, out_w = int(out_size[0]), int(out_size[1])
    F_, H, W, C = frames.shape
    dev = frames.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    sy = inv_mats[:, 1, 1, None] * ys + inv_mats[:, 1, 2, None]  # (N, oh)
    sx = inv_mats[:, 0, 0, None] * xs + inv_mats[:, 0, 2, None]  # (N, ow)
    wy = _hat(sy, H).to(dtype)                 # (N, oh, H)
    wx = _hat(sx, W).to(dtype)                 # (N, ow, W)
    N = frame_idx.shape[0]
    out = torch.empty((N, out_h, out_w, C), dtype=dtype, device=dev)
    itemsize = torch.finfo(dtype).bits // 8
    chunk = max(1, _WARP_BUDGET_BYTES // max(1, H * W * C * itemsize))
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        imgs = frames[frame_idx[s:e]].to(dtype)              # (n, H, W, C)
        tmp = torch.einsum("now,nhwc->nhoc", wx[s:e], imgs)
        out[s:e] = torch.einsum("noh,nhxc->noxc", wy[s:e], tmp)
    return out


def crop_batch(frames, frame_idx, bboxes_xyxy, input_size, aspect_ratio=None,
               normalize: bool = True, dtype=torch.float32):
    """Normalized person crops for a batch of boxes.

    frames: (F, H, W, 3) in [0, 255] (uint8 or float, RGB); frame_idx:
    (N,); bboxes_xyxy: (N, 4) raw person boxes; input_size: (inp_h, inp_w).
    Returns (crops (N, inp_h, inp_w, 3) NHWC in `dtype`, bbox_crop (N, 4)
    xyxy f32 — the aspect-corrected 1.25-padded crop box).
    """
    inp_h, inp_w = int(input_size[0]), int(input_size[1])
    if aspect_ratio is None:
        aspect_ratio = float(inp_w) / float(inp_h)
    dev = frames.device
    bb = torch.as_tensor(bboxes_xyxy, dtype=torch.float32, device=dev)
    center, scale = box_to_center_scale(
        bb[:, 0], bb[:, 1], bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1],
        aspect_ratio)
    inv_mats = get_affine_transform(center, scale, 0.0, (inp_w, inp_h),
                                    inv=True)
    bbox_crop = center_scale_to_box(center, scale)
    fi = torch.as_tensor(np.asarray(frame_idx), dtype=torch.long, device=dev)
    crops = warp_axis_aligned_batch(frames, fi, inv_mats, (inp_h, inp_w),
                                    dtype=dtype)
    if normalize:
        mean = torch.as_tensor(RGB_MEAN, device=dev).to(dtype)
        crops = crops / 255.0 - mean
    return crops, bbox_crop
