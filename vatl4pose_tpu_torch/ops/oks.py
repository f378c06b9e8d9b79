"""Object Keypoint Similarity (counterpart of vatl4pose_tpu/ops/oks.py):
`compute_oks` on tensors, `oks_matrix` in numpy on the host for OSPA,
`oks_kpts_matrix` for the occlusion-level OSPA2 of the tracking evaluation,
and the sigma constants."""

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
           "compute_oks", "oks_matrix", "oks_kpts_matrix"]


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


def oks_matrix(gt_kpts, gt_bbox_xywh, gt_area, pred_kpts, variances=None,
               force_visible: bool = False):
    """G x P OKS matrix in float64 numpy (pose_eval.py:177-221 /
    pycocotools computeOks).

    gt_kpts: (G, 3K); pred_kpts: (P, 3K); gt_bbox_xywh: (G, 4); gt_area:
    (G,), the annotation 'area' where present (the reference falls back to
    w*h).  force_visible mirrors get_per_kp_oks_matrix's vg=ones.
    """
    if variances is None:
        variances = JRDB_VARS
    var = np.asarray(variances, np.float64)
    g = np.asarray(gt_kpts, np.float64)
    d = np.asarray(pred_kpts, np.float64)
    G, P = g.shape[0], d.shape[0]
    xg, yg, vg = g[:, 0::3], g[:, 1::3], g[:, 2::3]
    if force_visible:
        vg = np.ones_like(vg)
    xd, yd = d[:, 0::3], d[:, 1::3]
    bb = np.asarray(gt_bbox_xywh, np.float64)
    area = np.asarray(gt_area, np.float64)
    out = np.zeros((G, P), np.float64)
    for j in range(G):
        k1 = np.count_nonzero(vg[j] > 0)
        if k1 > 0:
            dx = xd - xg[j]
            dy = yd - yg[j]
        else:
            x0 = bb[j, 0] - bb[j, 2]
            x1 = bb[j, 0] + bb[j, 2] * 2
            y0 = bb[j, 1] - bb[j, 3]
            y1 = bb[j, 1] + bb[j, 3] * 2
            dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
            dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
        e = (dx ** 2 + dy ** 2) / var / (area[j] + np.spacing(1)) / 2
        if k1 > 0:
            e = e[:, vg[j] > 0]
        out[j] = np.sum(np.exp(-e), axis=1) / e.shape[1]
    return out


def oks_kpts_matrix(gt_kpts, gt_area, pred_kpts, variances=None):
    """(G, P, K) per-keypoint OKS terms over ALL joints in float64 numpy
    (JRDB_toolkit/posetrack/datasets/jrdbpose.py:611-619: e = d²/vars/body/2,
    exp(-e), no visibility gating: 'JRDB assumption: all joints valid')."""
    if variances is None:
        variances = JRDB_VARS
    var = np.asarray(variances, np.float64)
    g = np.asarray(gt_kpts, np.float64)
    d = np.asarray(pred_kpts, np.float64)
    xg, yg = g[:, 0::3], g[:, 1::3]
    xd, yd = d[:, 0::3], d[:, 1::3]
    area = np.asarray(gt_area, np.float64)
    dx = xd[None, :, :] - xg[:, None, :]
    dy = yd[None, :, :] - yg[:, None, :]
    e = (dx ** 2 + dy ** 2) / var[None, None, :] \
        / (area[:, None, None] * 2.0)
    return np.exp(-e)
