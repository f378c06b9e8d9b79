"""Object Keypoint Similarity on tensors (counterpart of vatl4pose_tpu/
ops/oks.py: `compute_oks` and the sigma constants)."""

from __future__ import annotations

import numpy as np
import torch

# COCO sigmas (al_metric.py:38)
COCO_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], dtype=np.float64) / 10.0
COCO_VARS = (COCO_SIGMAS * 2) ** 2

# JRDB sigmas (pose_eval.py:127-130)
JRDB_SIGMAS = np.array(
    [0.079, 0.025, 0.025, 0.079, 0.026, 0.079, 0.072, 0.072, 0.107,
     0.062, 0.107, 0.107, 0.062, 0.087, 0.087, 0.089, 0.089], dtype=np.float64)
JRDB_VARS = (JRDB_SIGMAS * 2) ** 2

__all__ = ["COCO_SIGMAS", "COCO_VARS", "JRDB_SIGMAS", "JRDB_VARS",
           "compute_oks"]


def compute_oks(pred_kpts, gt_kpts, bbox_xywh, variances=None):
    """OKS between predicted and GT keypoints (batched).

    pred_kpts, gt_kpts: (..., 3K) interleaved (x, y, v); bbox_xywh: (..., 4)
    GT bbox.  al_metric.py:42-69: body_area = w*h, the mean is over visible
    GT keypoints, and the box-distance fallback applies only when no
    keypoint is visible.
    """
    if variances is None:
        variances = COCO_VARS
    d = pred_kpts
    var = torch.as_tensor(variances, dtype=d.dtype, device=d.device)
    g = gt_kpts.to(d.dtype)
    xd, yd = d[..., 0::3], d[..., 1::3]
    xg, yg, vg = g[..., 0::3], g[..., 1::3], g[..., 2::3]
    visible = vg > 0
    k1 = visible.sum(dim=-1)

    bb = bbox_xywh.to(d.dtype)
    x0 = bb[..., 0:1] - bb[..., 2:3]
    x1 = bb[..., 0:1] + bb[..., 2:3] * 2
    y0 = bb[..., 1:2] - bb[..., 3:4]
    y1 = bb[..., 1:2] + bb[..., 3:4] * 2
    area = bb[..., 2] * bb[..., 3]

    dx_vis = xd - xg
    dy_vis = yd - yg
    dx_inv = (x0 - xd).clamp(min=0) + (xd - x1).clamp(min=0)
    dy_inv = (y0 - yd).clamp(min=0) + (yd - y1).clamp(min=0)
    use_vis = (k1 > 0)[..., None]
    dx = torch.where(use_vis, dx_vis, dx_inv)
    dy = torch.where(use_vis, dy_vis, dy_inv)

    e = (dx ** 2 + dy ** 2) / var / (area[..., None] + np.spacing(1)) * 0.5
    exp_e = torch.exp(-e)
    num_vis = torch.where(visible, exp_e, 0.0).sum(dim=-1)
    oks_vis = num_vis / k1.clamp(min=1)
    oks_all = exp_e.mean(dim=-1)
    return torch.where(k1 > 0, oks_vis, oks_all)
