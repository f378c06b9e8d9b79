"""The plain scoring pass: what VATL's uncertainty pass computes for every
sample of a video, written out in float32 torch from the published
formulas, with no kernel and no batching but blocks of rows.

  crop      the person box aspect-corrected to the input's ratio and
            padded 1.25x (AlphaPose's box_to_center_scale), a rot-0
            dst->src affine, bilinear taps with a constant-0 border
            (cv2.warpAffine INTER_LINEAR), then /255 - RGB mean;
  model     the estimator in eval mode: heatmaps and the embedding;
  decode    row-major argmax (first maximum), coordinates zeroed where
            the maximum is <= 0, the +-0.25 shift toward the larger
            neighbour inside the strict window 1 < p < size - 1, and the
            inverse crop affine to image space;
  OKS       COCO sigmas, the mean over visible ground-truth joints;
  THC       sum |H - H_adj| / K over the track's neighbours, one
            neighbour counted twice where the other is missing;
  WPU       the 38-d hybrid feature (15 centred x, 15 centred y over the
            score-weighted centre, divided by the crop box's height, and 8
            joint-triangle angles) through the autoencoder, its mean
            squared reconstruction error.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RGB_MEAN", "COCO_VARS", "crop_geometry", "crops", "decode",
           "oks", "thc", "hybrid", "wpu"]

RGB_MEAN = (0.406, 0.457, 0.480)
COCO_VARS = (np.array([.26, .25, .25, .35, .35, .79, .79, .72, .72, .62,
                       .62, 1.07, 1.07, .87, .87, .89, .89]) / 10.0 * 2) ** 2
# the joint triangles of the hybrid feature's angles, and the joints kept
# for its centred coordinates (the ears dropped)
TRIANGLES = ((8, 6, 12), (6, 8, 10), (5, 7, 9), (7, 5, 11),
             (11, 12, 14), (12, 11, 13), (12, 14, 16), (11, 13, 15))
NO_EARS = (0, 1, 2) + tuple(range(5, 17))


def crop_geometry(boxes_xyxy, input_size):
    """(N, 4) f32 person boxes -> (dst->src affines (N, 2, 3), crop boxes
    (N, 4) xyxy), input_size (h, w)."""
    h_in, w_in = input_size
    ar = w_in / h_in
    b = boxes_xyxy
    w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    cx, cy = b[:, 0] + w * 0.5, b[:, 1] + h * 0.5
    h2 = torch.where(w > ar * h, w / ar, h)
    w2 = torch.where(w < ar * h, h * ar, w)
    sw, sh = w2 * 1.25, h2 * 1.25
    s = sw / float(w_in)
    zero = torch.zeros_like(s)
    mats = torch.stack([
        torch.stack([s, zero, cx - s * w_in * 0.5], -1),
        torch.stack([zero, s, cy - s * h_in * 0.5], -1)], -2)
    xmin, ymin = cx - sw * 0.5, cy - sh * 0.5
    return mats, torch.stack([xmin, ymin, xmin + sw, ymin + sh], -1)


def crops(frames, frame_idx, mats, out_size):
    """Normalised crops (N, h, w, 3) f32 of uint8 frames (F, H, W, 3)."""
    oh, ow = out_size
    F_, H, W, C = frames.shape
    dev = frames.device
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    m = mats[..., None, None]
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    fi = frame_idx.long()[:, None, None]
    flat = frames.reshape(-1, C)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        idx = (fi * H + yy.clamp(0, H - 1)) * W + xx.clamp(0, W - 1)
        return flat[idx].float() * inside[..., None].float()

    out = tap(y0, x0) * ((1 - fx) * (1 - fy))[..., None] \
        + tap(y0, x0 + 1) * (fx * (1 - fy))[..., None] \
        + tap(y0 + 1, x0) * ((1 - fx) * fy)[..., None] \
        + tap(y0 + 1, x0 + 1) * (fx * fy)[..., None]
    return out / 255.0 - torch.tensor(RGB_MEAN, device=dev)


def decode(hms, crop_boxes):
    """hms (N, K, H, W) f32 -> (image coords (N, K, 2), maxvals (N, K),
    heatmap cells (N, K, 2) long, shifts (N, K, 2), neighbour differences
    (N, K, 2))."""
    N, K, H, W = hms.shape
    flat = hms.reshape(N, K, -1)
    maxv = flat.amax(-1)
    pos = torch.arange(H * W, device=hms.device)
    idx = torch.where(flat == maxv[..., None], pos, H * W).amin(-1)
    keep = maxv > 0
    px = torch.where(keep, idx % W, 0)
    py = torch.where(keep, idx // W, 0)
    inside = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
    pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)

    def at(yy, xx):
        return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

    diff = torch.stack([at(pyc, pxc + 1) - at(pyc, pxc - 1),
                        at(pyc + 1, pxc) - at(pyc - 1, pxc)], -1)
    shift = torch.sign(diff) * 0.25 * inside[..., None]
    cells = torch.stack([px, py], -1)
    hm_xy = cells.float() + shift
    b = crop_boxes[:, None, :]
    s = (b[..., 2] - b[..., 0]) / W
    ox = b[..., 0] + (b[..., 2] - b[..., 0]) * 0.5 - s * W * 0.5
    oy = b[..., 1] + (b[..., 3] - b[..., 1]) * 0.5 - s * H * 0.5
    img = torch.stack([s * hm_xy[..., 0] + ox, s * hm_xy[..., 1] + oy], -1)
    return img, maxv, cells, shift, diff


def oks(kpts, gt, box_xywh):
    """OKS of (N, 3K) predictions against (N, 3K) ground truth with
    (N, 4) annotation boxes; the box-distance form where no joint is
    visible."""
    var = torch.as_tensor(COCO_VARS, dtype=torch.float32, device=kpts.device)
    xd, yd = kpts[:, 0::3], kpts[:, 1::3]
    xg, yg, vg = gt[:, 0::3], gt[:, 1::3], gt[:, 2::3]
    vis = vg > 0
    nvis = vis.sum(-1)
    bx, by, bw, bh = box_xywh.unbind(-1)
    x0, x1 = (bx - bw)[:, None], (bx + bw * 2)[:, None]
    y0, y1 = (by - bh)[:, None], (by + bh * 2)[:, None]
    dx = torch.where(nvis[:, None] > 0, xd - xg,
                     (x0 - xd).clamp(min=0) + (xd - x1).clamp(min=0))
    dy = torch.where(nvis[:, None] > 0, yd - yg,
                     (y0 - yd).clamp(min=0) + (yd - y1).clamp(min=0))
    e = torch.exp(-((dx ** 2 + dy ** 2) / var
                    / (bw * bh + np.spacing(1))[:, None] * 0.5))
    return torch.where(nvis > 0,
                       (e * vis).sum(-1) / nvis.clamp(min=1), e.mean(-1))


def thc(hms, is_prev, is_next):
    """THC with the L1 norm over (N, K, H, W) track-sorted heatmaps."""
    K = hms.shape[1]
    d_prev = (hms - torch.roll(hms, 1, 0)).abs().sum((1, 2, 3)) / K
    d_next = (hms - torch.roll(hms, -1, 0)).abs().sum((1, 2, 3)) / K
    both = is_prev & is_next
    w_prev = torch.where(both, 1.0, torch.where(is_prev, 2.0, 0.0))
    w_next = torch.where(both, 1.0, torch.where(is_next, 2.0, 0.0))
    return w_prev * d_prev + w_next * d_next


def hybrid(crop_boxes, kpts):
    """The 38-d hybrid feature of (N, 3K) keypoints in their crop boxes."""
    height = crop_boxes[:, 3] - crop_boxes[:, 1]
    x, y, s = kpts[:, 0::3], kpts[:, 1::3], kpts[:, 2::3]
    keep = list(NO_EARS)
    xs, ys, ss = x[:, keep], y[:, keep], s[:, keep]
    cx = (xs * ss).sum(-1) / ss.sum(-1)
    cy = (ys * ss).sum(-1) / ss.sum(-1)
    t = torch.as_tensor(TRIANGLES, device=kpts.device)
    m1 = (y[:, t[:, 1]] - y[:, t[:, 0]]) / (x[:, t[:, 1]] - x[:, t[:, 0]]
                                            + 1e-6)
    m2 = (y[:, t[:, 2]] - y[:, t[:, 1]]) / (x[:, t[:, 2]] - x[:, t[:, 1]]
                                            + 1e-6)
    ang = torch.arctan(((m1 - m2) / (1 + m1 * m2 + 1e-6)).abs())
    return torch.cat([(xs - cx[:, None]) / height[:, None],
                      (ys - cy[:, None]) / height[:, None], ang], -1)


def wpu(ae, crop_boxes, kpts):
    feat = hybrid(crop_boxes, kpts)
    return (ae(feat) - feat).square().mean(-1)
