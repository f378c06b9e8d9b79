"""Losses (counterpart of vatl4pose_tpu/models/criterion.py).

Parity: alphapose/models/criterion.py (MSELoss is the shipped configs'
loss; L1JointRegression the integral, soft-argmax, regression loss) and
the MSELoss call sites (ActiveLearning.py:669, posetrack_train.py:52):
0.5 * MSE(out*mask, label*mask), the mean over every element of the batch.
"""

from __future__ import annotations

import torch

from ..ops.heatmap import integral_coords

__all__ = ["mse_loss", "masked_heatmap_loss", "weighted_l1_loss",
           "l1_joint_regression_loss", "LOSS_REGISTRY"]


def mse_loss(pred, target):
    """torch.nn.MSELoss(reduction='mean')."""
    return (pred - target).square().mean()


def masked_heatmap_loss(pred, target, target_weight, valid=None,
                        n_valid=None):
    """0.5 * MSE(pred*mask, target*mask), the mean taken over every element
    of the valid samples.

    pred/target: (N, K, H, W) or (N, H, W, K), elementwise; target_weight:
    a broadcastable joint mask; valid: optional (N,) bool for padded
    batches: padded rows add 0 to the sum and are left out of the
    denominator, which is the reference's mean over the real batch.
    n_valid: the valid count the mean divides by, valid.sum() by default
    (a data-parallel rank passes the global batch's: parallel/steps.py).
    """
    sq = ((pred - target) * target_weight).square()
    if valid is None:
        return 0.5 * sq.mean()
    valid = valid.to(sq.dtype)
    per_elem = sq.reshape(sq.shape[0], -1)
    total = (per_elem.sum(dim=1) * valid).sum()
    if n_valid is None:
        n_valid = valid.sum()
    denom = n_valid.clamp(min=1.0) * per_elem.shape[1]
    return 0.5 * total / denom


def weighted_l1_loss(pred, target, weight, size_average: bool = True):
    """|pred - target| * weight summed, divided by the count of positive
    weights (at least 1) when size_average (criterion.py:85-94)."""
    total = ((pred - target).abs() * weight).sum()
    if size_average:
        return total / (weight > 0).sum().clamp(min=1)
    return total


def l1_joint_regression_loss(hms, target_uv, target_uv_weight,
                             norm_type: str = "softmax",
                             size_average: bool = True):
    """L1JointRegression (criterion.py:46-76): the integral decode of the
    heatmaps, weighted L1 against (u, v) targets in [-0.5, 0.5) space.
    hms: (N, K, H, W); target_uv and its weight: (N, 2K)."""
    coords, _ = integral_coords(hms, norm_type)
    return weighted_l1_loss(coords.reshape(coords.shape[0], -1), target_uv,
                            target_uv_weight, size_average)


LOSS_REGISTRY = {
    "MSELoss": masked_heatmap_loss,
    "L1JointRegression": l1_joint_regression_loss,
}
