"""Person crops + normalization on the device (counterpart of
vatl4pose_tpu/ops/warp.py: `warp_affine_bilinear`, `crop_batch` and
`RGB_MEAN`).

`warp_affine_bilinear_batch` is the general crop: any dst->src affine
(rotation, scale, flip), 4-tap bilinear with a constant-0 border per tap
(cv2.warpAffine INTER_LINEAR + BORDER_CONSTANT 0, up to cv2's 5-bit
coefficient quantization).  It is the plain version of the training crop
kernel (kernels/rot_warp.py), and every operation of it is one tensor op
rounded on its own, so the kernel can repeat its arithmetic bit for bit.

`crop_batch` is the scoring crop: rot=0 matrices from the person boxes,
normalized through the crop kernel (kernels/rot_warp.py), which on the
CPU is this gather form.  The JAX package computes the same axis-aligned
warp as two batched matrix products (separable hat-kernel weights, the
TPU's MXU being fast and its gathers slow); the two agree up to f32
rounding.  `warp_axis_aligned_batch` keeps that separable form, the JAX
function's counterpart, for unnormalized crops.
"""

from __future__ import annotations

import numpy as np
import torch

from .affine import box_to_center_scale, center_scale_to_box, get_affine_transform

__all__ = ["warp_affine_bilinear", "warp_affine_bilinear_batch",
           "warp_axis_aligned_batch", "crop_geometry", "crop_batch",
           "normalize_crops", "RGB_MEAN"]

# peak-memory cap for the (chunk, H, W, C) gathered-frames buffer: large
# source frames are warped in sub-chunks under it
_WARP_BUDGET_BYTES = 256 * 2 ** 20

# channel means subtracted after /255 (simple_transform.py:94-96), RGB order
RGB_MEAN = np.array([0.406, 0.457, 0.480], dtype=np.float32)


def warp_affine_bilinear_batch(frames, frame_idx, inv_mats, out_size):
    """frames: (F, H, W, C) uint8 or float in [0, 255]; frame_idx: (N,)
    integer; inv_mats: (N, 2, 3) dst->src.  Returns (N, out_h, out_w, C)
    float32, not normalized.

    Per output pixel: s = M (x, y, 1) as (m0*x + m1*y) + m2, the taps at
    floor(s) and +1, each read as 0 outside the frame, and the sum
    ((v00*w00 + v01*w01) + v10*w10) + v11*w11 with w00 = (1-fx)*(1-fy),
    w01 = fx*(1-fy), w10 = (1-fx)*fy, w11 = fx*fy."""
    out_h, out_w = int(out_size[0]), int(out_size[1])
    F_, H, W, C = frames.shape
    dev = frames.device
    f32 = torch.float32
    m = torch.as_tensor(inv_mats, dtype=f32, device=dev)[..., None, None]
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=f32, device=dev),
                            torch.arange(out_w, dtype=f32, device=dev),
                            indexing="ij")
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]     # (N, oh, ow)
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i = x0.to(torch.long)
    y0i = y0.to(torch.long)
    fi = torch.as_tensor(frame_idx, dtype=torch.long,
                         device=dev)[:, None, None]
    flat = frames.reshape(F_ * H * W, C)

    def sample(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        idx = (fi * H + yy.clamp(0, H - 1)) * W + xx.clamp(0, W - 1)
        return flat[idx].to(f32) * inb[..., None].to(f32)

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)
    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def warp_affine_bilinear(image, inv_mat, out_size):
    """Bilinear warp of one (H, W, C) image by the dst->src (2, 3)
    `inv_mat`; out_size (out_h, out_w).  Out-of-bounds taps read 0."""
    image = torch.as_tensor(image)
    inv_mat = torch.as_tensor(inv_mat, dtype=torch.float32,
                              device=image.device)
    return warp_affine_bilinear_batch(image[None], [0], inv_mat[None],
                                      out_size)[0]


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


def crop_geometry(bboxes_xyxy, input_size, aspect_ratio=None, device=None):
    """The scoring crops' rot=0 geometry for a batch of raw person boxes
    (N, 4) xyxy: (inv_mats (N, 2, 3) dst->src float32, bbox_crop (N, 4)
    xyxy float32, the aspect-corrected 1.25-padded crop box)."""
    inp_h, inp_w = int(input_size[0]), int(input_size[1])
    if aspect_ratio is None:
        aspect_ratio = float(inp_w) / float(inp_h)
    bb = torch.as_tensor(bboxes_xyxy, dtype=torch.float32, device=device)
    center, scale = box_to_center_scale(
        bb[:, 0], bb[:, 1], bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1],
        aspect_ratio)
    inv_mats = get_affine_transform(center, scale, 0.0, (inp_w, inp_h),
                                    inv=True)
    return inv_mats.contiguous(), center_scale_to_box(center, scale)


def crop_batch(frames, frame_idx, bboxes_xyxy, input_size, aspect_ratio=None,
               normalize: bool = True, dtype=torch.float32):
    """Normalized person crops for a batch of boxes.

    frames: (F, H, W, 3) in [0, 255] (uint8 or float32, RGB); frame_idx:
    (N,); bboxes_xyxy: (N, 4) raw person boxes; input_size: (inp_h, inp_w).
    Returns (crops (N, inp_h, inp_w, 3) NHWC in `dtype`, bbox_crop (N, 4)
    xyxy f32 — the aspect-corrected 1.25-padded crop box).  Normalized
    crops come from the crop kernel (computed in f32, rounded once to
    `dtype`); normalize=False returns the separable warp in `dtype`.
    """
    from ..kernels.rot_warp import rot_warp_crop   # it imports this module
    out_size = (int(input_size[0]), int(input_size[1]))
    dev = frames.device
    inv_mats, bbox_crop = crop_geometry(bboxes_xyxy, out_size, aspect_ratio,
                                        dev)
    fi = torch.as_tensor(np.asarray(frame_idx), dtype=torch.long, device=dev)
    if normalize:
        return rot_warp_crop(frames, fi, inv_mats, out_size,
                             dtype=dtype), bbox_crop
    return warp_axis_aligned_batch(frames, fi, inv_mats, out_size,
                                   dtype=dtype), bbox_crop


def normalize_crops(crops_u8, device, dtype=torch.float32):
    """Host-warped uint8 crops (N, h, w, 3) → on `device` (through pinned
    memory, without waiting, from the host to a card), /255 - RGB_MEAN in
    f32, then rounded once to `dtype`: the streaming paths' input."""
    x = torch.as_tensor(crops_u8)
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory().to(device, non_blocking=True)
    x = x.to(device, torch.float32) / 255.0 \
        - torch.as_tensor(RGB_MEAN, device=device)
    return x.to(dtype)
