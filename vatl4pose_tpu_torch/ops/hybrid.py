"""Whole-body hybrid pose feature (counterpart of vatl4pose_tpu/ops/
hybrid.py: `compute_hybrid`).

drop_ears=True gives the 38-d PoseTrack21 feature (15 centered x, 15
centered y, 8 joint-triangle angles) that the pretrained WholeBodyAE
expects; False gives the 42-d JRDB variant.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_hybrid", "ANGLE_TRIANGLES_17"]

# joint triangles (left, center, right) in 17-keypoint COCO indexing
# (hybrid_feature.py:44)
ANGLE_TRIANGLES_17 = np.array(
    [[8, 6, 12], [6, 8, 10], [5, 7, 9], [7, 5, 11],
     [11, 12, 14], [12, 11, 13], [12, 14, 16], [11, 13, 15]], dtype=np.int64)

_EPS = 1e-6
_NO_EARS = [0, 1, 2] + list(range(5, 17))


def _angles(xk, yk, triangles):
    """Absolute joint-triangle angles via arctan of slopes
    (hybrid_feature.py:6-12).  xk, yk: (..., K)."""
    t = torch.as_tensor(triangles, device=xk.device)
    x0, y0 = xk[..., t[:, 0]], yk[..., t[:, 0]]
    x1, y1 = xk[..., t[:, 1]], yk[..., t[:, 1]]
    x2, y2 = xk[..., t[:, 2]], yk[..., t[:, 2]]
    m1 = (y1 - y0) / (x1 - x0 + _EPS)
    m2 = (y2 - y1) / (x2 - x1 + _EPS)
    tan_abs = ((m1 - m2) / (1 + m1 * m2 + _EPS)).abs()
    return torch.arctan(tan_abs)


def compute_hybrid(bbox_xywh, keypoints, drop_ears: bool = True):
    """bbox_xywh: (..., 4); keypoints: (..., 51) interleaved (x, y, score).
    Feature = [(x - cg_x)/bbox_h, (y - cg_y)/bbox_h, 8 angles]; the center
    of gravity is the score-weighted mean (hybrid_feature.py:35-39)."""
    kp = keypoints.to(torch.float32)
    height = bbox_xywh.to(torch.float32)[..., 3]
    xk, yk, sk = kp[..., 0::3], kp[..., 1::3], kp[..., 2::3]
    if drop_ears:
        xs, ys, ss = xk[..., _NO_EARS], yk[..., _NO_EARS], sk[..., _NO_EARS]
    else:
        xs, ys, ss = xk, yk, sk
    wsum = ss.sum(dim=-1)
    cg_x = (xs * ss).sum(dim=-1) / wsum
    cg_y = (ys * ss).sum(dim=-1) / wsum
    nx = (xs - cg_x[..., None]) / height[..., None]
    ny = (ys - cg_y[..., None]) / height[..., None]
    ang = _angles(xk, yk, ANGLE_TRIANGLES_17)
    return torch.cat([nx, ny, ang], dim=-1)
