"""Heatmap losses (counterpart of vatl4pose_tpu/models/criterion.py:
`mse_loss`, `masked_heatmap_loss`).

Parity: the reference's MSELoss call sites (ActiveLearning.py:669,
posetrack_train.py:52): 0.5 * MSE(out*mask, label*mask), the mean over
every element of the batch.
"""

from __future__ import annotations

import torch

__all__ = ["mse_loss", "masked_heatmap_loss"]


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
