"""Training metrics: running averages and PCK-style heatmap accuracy
(counterpart of vatl4pose_tpu/utils/metrics.py: `DataLogger`, `_acc_impl`,
`calc_accuracy`).

Parity: alphapose/utils/metrics.py:14-32 (DataLogger) and :118-147,
221-245 (calc_accuracy / calc_dist / dist_acc): heatmap-argmax accuracy
with norm = heatmap size / 10 and threshold 0.5, a joint counted only
where the label's argmax is at x > 1 and y > 1.  The argmax is the port's
`get_max_pred` (first max wins).
"""

from __future__ import annotations

import torch

from ..ops.heatmap import get_max_pred

__all__ = ["DataLogger", "acc_counts", "acc_from_counts", "acc_tensor",
           "calc_accuracy"]


class DataLogger:
    """Running average of a metric: `update(value, n)` weighs a batch's
    value by its n samples."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.value, self.sum, self.cnt, self.avg = 0, 0, 0, 0

    def update(self, value, n=1):
        self.value = value
        self.sum += value * n
        self.cnt += n
        self._cal_avg()

    def _cal_avg(self):
        self.avg = self.sum / self.cnt


def acc_counts(preds, labels, thr: float = 0.5):
    """preds/labels: (N, K, H, W).  Per joint, the labels counted (the
    visible ones) and the predictions within `thr` of them: two (K,)
    tensors on their device, which add up over the shards of a batch."""
    p, _ = get_max_pred(preds)
    lab, _ = get_max_pred(labels)
    H, W = preds.shape[-2], preds.shape[-1]
    norm = torch.tensor([W, H], dtype=torch.float32,
                        device=preds.device) / 10.0
    visible = (lab[..., 0] > 1) & (lab[..., 1] > 1)           # (N, K)
    dist = torch.linalg.norm((p - lab) / norm, dim=-1)
    # -1 marks an invisible joint: an exact hit has dist 0 and counts
    dist = torch.where(visible, dist, -1.0)
    dist_cal = dist != -1.0
    num = dist_cal.sum(dim=0)                                 # (K,)
    hit = (dist_cal & (dist < thr)).sum(dim=0)
    return num, hit


def acc_from_counts(num, hit):
    """The accuracy of `acc_counts`' counts as a 0-d float32 tensor: the
    mean hit rate over the joints with a counted label, 0 without one."""
    acc = torch.where(num > 0, hit / num.clamp(min=1), -1.0)
    valid = acc >= 0
    mean = torch.where(valid, acc, 0.0).sum() / valid.sum().clamp(min=1)
    return torch.where(valid.any(), mean, 0.0).to(torch.float32)


def acc_tensor(preds, labels, thr: float = 0.5):
    """preds/labels: (N, K, H, W).  The accuracy as a 0-d float32 tensor on
    their device (no host sync)."""
    return acc_from_counts(*acc_counts(preds, labels, thr))


def calc_accuracy(preds, labels, thr: float = 0.5) -> float:
    """preds/labels: (N, K, H, W); see metrics.py:118-147."""
    return float(acc_tensor(torch.as_tensor(preds), torch.as_tensor(labels),
                            thr))
