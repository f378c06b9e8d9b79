"""Temporal Heatmap Continuity (counterpart of vatl4pose_tpu/ops/
temporal.py: `thc_scores`, `temporal_neighbor_weights`).

Every heatmap is computed once; a sample's neighbours are the rows ±1 of
the track-sorted sample axis.  The roll wraps the axis, and the
`is_prev`/`is_next` flags gate the wrapped rows to weight 0.
"""

from __future__ import annotations

import torch

__all__ = ["thc_scores", "temporal_neighbor_weights"]


def temporal_neighbor_weights(is_prev, is_next):
    """(w_prev, w_next) with the reference's doubling rule
    (ActiveLearning.py:345-370): both → (1, 1); prev only → (2, 0);
    next only → (0, 2); none → (0, 0)."""
    both = is_prev & is_next
    one, two, zero = 1.0, 2.0, 0.0
    w_prev = torch.where(both, one, torch.where(is_prev, two, zero))
    w_next = torch.where(both, one, torch.where(is_next, two, zero))
    return w_prev, w_next


def thc_scores(hms, is_prev, is_next, norm_type: str = "L1"):
    """hms: (N, K, H, W) in dataset order; is_prev/is_next: (N,) bool.
    Returns (N,) f32: sum|H - H_adj|/K (L1) or sum((H - H_adj)^2)/K (L2)
    with the single-neighbour doubling rule (ActiveLearning.py:747-760)."""
    hms = hms.to(torch.float32)
    K = hms.shape[1]
    prev_hms = torch.roll(hms, 1, dims=0)
    next_hms = torch.roll(hms, -1, dims=0)
    if norm_type == "L1":
        d_prev = (hms - prev_hms).abs().sum(dim=(1, 2, 3)) / K
        d_next = (hms - next_hms).abs().sum(dim=(1, 2, 3)) / K
    elif norm_type == "L2":
        d_prev = (hms - prev_hms).square().sum(dim=(1, 2, 3)) / K
        d_next = (hms - next_hms).square().sum(dim=(1, 2, 3)) / K
    else:
        raise ValueError(norm_type)
    w_prev, w_next = temporal_neighbor_weights(is_prev, is_next)
    return w_prev * d_prev + w_next * d_next
