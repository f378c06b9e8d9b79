"""The general traffic generator: a synthetic tracked-person video made
from a traffic file's `video` parameters and the run's seed.

Track, box and keypoint arithmetic follow the port's synthetic fixture
(data/synthetic.py: box sizes as fractions of the frame, a 17-keypoint
template in the box, a constant velocity per person, visibility drawn per
joint), with one change for long videos: a person's position reflects at
the frame's margins, so that every box stays inside the frame for any
number of frames.  Samples are in the dataset's track-sorted order
(person, then frame), so index +-1 is the same person in the adjacent
frame and `is_prev`/`is_next` mark those neighbours.

The frames are made on the device: a uniform background from a seeded
device Generator plus a Gaussian blob at every keypoint, summed as one
separable product per frame and channel in float64 (deterministic, and
the same under every precision setting), rounded down to uint8.  The same
seed gives the same video on the same device.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.weights import generator

__all__ = ["make_video", "POSETRACK_JOINT_PAIRS"]

# a 17-keypoint COCO-order human template in a unit box (x, y)
TEMPLATE = np.array([
    [0.50, 0.08], [0.46, 0.05], [0.54, 0.05], [0.40, 0.07], [0.60, 0.07],
    [0.35, 0.22], [0.65, 0.22], [0.28, 0.38], [0.72, 0.38], [0.24, 0.52],
    [0.76, 0.52], [0.40, 0.55], [0.60, 0.55], [0.38, 0.75], [0.62, 0.75],
    [0.37, 0.95], [0.63, 0.95]], dtype=np.float32)
POSETRACK_JOINT_PAIRS = [[5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
                         [15, 16]]


def _reflect(x, lo, hi):
    """x folded into [lo, hi] by reflection at both ends."""
    span = hi - lo
    t = np.mod(x - lo, 2 * span)
    return lo + np.where(t <= span, t, 2 * span - t)


def _tracks(p, rng):
    """Per (frame, person): keypoints (F, P, 17, 2), visibility
    (F, P, 17) and raw xywh boxes (F, P, 4)."""
    F_, P, W, H = p["frames"], p["persons"], p["width"], p["height"]
    w_lo, w_hi = p["box_w"][0] * W, p["box_w"][1] * W
    h_lo, h_hi = p["box_h"][0] * H, p["box_h"][1] * H
    sizes = rng.uniform([w_lo, h_lo], [w_hi, h_hi], size=(P, 2))
    lo = np.array([10.0, 10.0])
    hi = np.array([W - w_hi - 20.0, H - h_hi - 15.0])
    base = rng.uniform(lo, hi, size=(P, 2))
    vel = rng.uniform(-p["speed"], p["speed"], size=(P, 2))
    f = np.arange(F_, dtype=np.float64)[:, None, None]
    xy = _reflect(base[None] + vel[None] * f, lo, hi)          # (F, P, 2)
    kps = TEMPLATE[None, None] * sizes[None, :, None] + xy[:, :, None]
    kps = np.clip(kps, 0, [W - 1, H - 1]).astype(np.float32)
    vis = rng.uniform(size=(F_, P, 17)) > 1.0 - p["vis_prob"]
    vis[..., 0] |= ~vis.any(axis=-1)       # every person has a visible joint
    x0 = np.maximum(0.0, xy[..., 0] - 5)
    y0 = np.maximum(0.0, xy[..., 1] - 5)
    bw = np.minimum(sizes[None, :, 0] + 10, W - x0)
    bh = np.minimum(sizes[None, :, 1] + 10, H - y0)
    boxes = np.stack([x0, y0, bw, bh], -1).astype(np.float32)
    return kps, vis.astype(np.float32), boxes


@torch.no_grad()
def _frames(p, kps, seed, device):
    """(F, H, W, 3) uint8 on `device`: background noise plus a blob of
    `blob_amp` and `blob_sigma` at every keypoint in channel person % 3."""
    F_, P, W, H = p["frames"], p["persons"], p["width"], p["height"]
    g = generator(seed, 3, device)
    out = torch.empty((F_, H, W, 3), dtype=torch.uint8, device=device)
    k = torch.as_tensor(kps, dtype=torch.float64, device=device) \
        .reshape(F_, P * 17, 2)
    chan = torch.arange(P * 17, device=device) // 17 % 3
    onehot = (chan[None] == torch.arange(3, device=device)[:, None]) \
        .to(torch.float64)                                  # (3, K)
    ys = torch.arange(H, dtype=torch.float64, device=device)
    xs = torch.arange(W, dtype=torch.float64, device=device)
    s2 = 2.0 * p["blob_sigma"] ** 2
    step = 8
    for f0 in range(0, F_, step):
        kk = k[f0:f0 + step]
        gy = torch.exp(-(ys[None, :, None] - kk[:, None, :, 1]) ** 2 / s2)
        gx = torch.exp(-(xs[None, None, :] - kk[:, :, 0, None]) ** 2 / s2)
        # (n, 3, H, K) @ (n, 1, K, W): channel c sums its persons' blobs
        blobs = torch.matmul(gy[:, None] * onehot[None, :, None, :],
                             gx[:, None]) * p["blob_amp"]
        bg = torch.rand((kk.shape[0], H, W, 3), generator=g, device=device,
                        dtype=torch.float32) * p["bg_level"]
        img = bg.to(torch.float64) + blobs.permute(0, 2, 3, 1)
        out[f0:f0 + step] = img.clamp(0, 255).to(torch.uint8)
    return out


def make_video(p, seed: int, device):
    """The video of traffic parameters `p` (a traffic file's `video`) for
    `seed`: frames on `device` and the per-sample arrays (numpy, dataset
    order) that the port's VideoPoseData holds, plus `bbox_ann_xywh`, the
    clipped box as xywh, which the AL loop hands to scoring for OKS."""
    rng = np.random.default_rng(int(seed) % 2 ** 63)
    kps, vis, boxes = _tracks(p, rng)
    F_, P, W, H = p["frames"], p["persons"], p["width"], p["height"]

    def order(a):
        """(F, P, ...) -> (P * F, ...): person, then frame."""
        return np.swapaxes(a, 0, 1).reshape((F_ * P,) + a.shape[2:])

    joints_xy, joints_vis, raw = order(kps), order(vis), order(boxes)
    # the dataset's box: x2 = x1 + max(0, w - 1), clipped to the frame
    x1 = np.clip(raw[:, 0], 0, W - 1)
    y1 = np.clip(raw[:, 1], 0, H - 1)
    x2 = np.clip(raw[:, 0] + np.maximum(0, raw[:, 2] - 1), 0, W - 1)
    y2 = np.clip(raw[:, 1] + np.maximum(0, raw[:, 3] - 1), 0, H - 1)
    bboxes = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
    frame = np.tile(np.arange(F_, dtype=np.int32), P)
    gt = np.concatenate([joints_xy, joints_vis[..., None]], -1) \
        .reshape(F_ * P, 51).astype(np.float32)
    return types.SimpleNamespace(
        frames=_frames(p, kps, seed, device), frame_idx=frame,
        bboxes=bboxes, raw_bbox_xywh=raw, gt_keypoints=gt,
        joints_xy=joints_xy, joints_vis=np.minimum(1.0, joints_vis),
        is_prev=frame > 0, is_next=frame < F_ - 1, width=W, height=H,
        bbox_ann_xywh=np.stack([x1, y1, x2 - x1, y2 - y1], 1)
        .astype(np.float32),
        joint_pairs=POSETRACK_JOINT_PAIRS)
