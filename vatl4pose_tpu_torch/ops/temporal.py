"""Temporal continuity scorers THC and TPC (counterpart of vatl4pose_tpu/
ops/temporal.py: `thc_scores`, `tpc_scores`, `temporal_neighbor_weights`).

Every heatmap is computed once; a sample's neighbours are the rows ±1 of
the track-sorted sample axis.  The roll wraps the axis, and the
`is_prev`/`is_next` flags gate the wrapped rows to weight 0.
"""

from __future__ import annotations

import torch

from .heatmap import crop_to_image

__all__ = ["thc_scores", "tpc_scores", "temporal_neighbor_weights"]


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


def tpc_scores(hm_coords, coords, bbox_crop_xyxy, is_prev, is_next, hm_wh):
    """Temporal Pose Continuity (ActiveLearning.py:333-344, 736-745).

    hm_coords: (N, K, 2) heatmap-space decodes of the pass (argmax and the
    ±0.25 shift, which depend on the map alone); coords: (N, K, 2) the same
    in image space; bbox_crop_xyxy: (N, 4); hm_wh: (W, H).  The reference
    decodes the neighbour's map with the *current* sample's crop box, so
    the neighbour's pose is its heatmap-space decode rolled by ±1 and
    mapped through this sample's box: no second decode and no rolled copy
    of the maps.  Per neighbour: the count of joints that move more than
    0.01·sqrt(crop area); the doubling rule applies.  Returns (N,) f32."""
    bb = bbox_crop_xyxy.to(torch.float32)
    thresh = 0.01 * torch.sqrt((bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1]))
    prev_c = crop_to_image(torch.roll(hm_coords, 1, dims=0), bb, hm_wh)
    next_c = crop_to_image(torch.roll(hm_coords, -1, dims=0), bb, hm_wh)
    d_prev = torch.linalg.vector_norm(coords - prev_c, dim=-1)   # (N, K)
    d_next = torch.linalg.vector_norm(coords - next_c, dim=-1)
    c_prev = (d_prev > thresh[:, None]).sum(dim=-1).to(torch.float32)
    c_next = (d_next > thresh[:, None]).sum(dim=-1).to(torch.float32)
    w_prev, w_next = temporal_neighbor_weights(is_prev, is_next)
    return w_prev * c_prev + w_next * c_next
