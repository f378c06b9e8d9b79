"""VL4Pose skeleton-likelihood scoring (counterpart of vatl4pose_tpu/ops/
vl4pose.py; active_learning/VL4Pose/Keypoint.py:53-128 and
ActiveLearning.py:1108-1163).

  * per joint: the top-k local peaks (ops/peaks.peak_local_max_topk, all
    N·K maps at once), a log-softmax over their values;
  * bottom-up over the fixed 16-link COCO tree: the value a child adds to
    a parent candidate p is
        sum_c [ log softmax-peak(c) + log N(||p - c||; mu, sigma^2)
                + children(c) ]
    as (N, P, P) tensors (the reference sums over the child's candidate
    locations, Keypoint.py:116);
  * sample score = the sum over the root's candidates; uncertainty is its
    negative.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch

from ..models.auxnet import COCO_LINKS
from .peaks import peak_local_max_topk

__all__ = ["COCO_LINKS", "vl4pose_scores", "pairwise_link_distances",
           "auxnet_nll_loss"]

_LOG2PI = math.log(2 * math.pi)


@lru_cache(maxsize=None)
def _tree(links, num_joints):
    """Children lists [(child, link index)] per joint and the bottom-up
    order (leaves first) of a depth-first walk from the root 0."""
    children = {j: [] for j in range(num_joints)}
    for li, (u, v) in enumerate(links):
        children[u].append((v, li))
    order, stack = [], [0]
    while stack:
        j = stack.pop()
        order.append(j)
        stack.extend(c for c, _ in children[j])
    return children, order[::-1]


def _links_key(links):
    return tuple((int(u), int(v)) for u, v in links)


def vl4pose_scores(hms, params, links=COCO_LINKS, min_distance: int = 5,
                   num_peaks: int = 5):
    """Negative tree log-likelihood per sample.  hms: (N, K, H, W);
    params: (N, L, 2) per-link (mu, log sigma^2) from the AuxNet.  Returns
    (N,) f32."""
    N, K = hms.shape[:2]
    vals, valid, ys, xs = peak_local_max_topk(hms, min_distance, num_peaks)
    locs = torch.stack([ys, xs], dim=-1).to(torch.float32)   # (N, K, P, 2)
    logp = torch.log_softmax(torch.where(valid, vals, float("-inf")), dim=-1)
    logp = torch.where(valid, logp, 0.0)
    params = params.to(torch.float32)
    children, order = _tree(_links_key(links), K)
    value = {j: logp[:, j] for j in range(K)}
    for j in order:
        for c, li in children[j]:
            d = torch.linalg.vector_norm(
                locs[:, j, :, None, :] - locs[:, c, None, :, :], dim=-1)
            mu = params[:, li, 0][:, None, None]
            logvar = params[:, li, 1][:, None, None]
            log_n = -0.5 * (_LOG2PI + logvar
                            + (mu - d) ** 2 * torch.exp(-logvar))
            contrib = value[c][:, None, :] + log_n            # (N, P, P)
            contrib = torch.where(valid[:, c, None, :], contrib, 0.0)
            value[j] = value[j] + contrib.sum(dim=-1)
    root = torch.where(valid[:, 0], value[0], 0.0)
    return -root.sum(dim=-1)


def pairwise_link_distances(coords, links=COCO_LINKS):
    """coords (N, K, 2) -> per-link joint distances (N, L)."""
    li = torch.as_tensor(links, dtype=torch.long, device=coords.device)
    return torch.linalg.vector_norm(coords[:, li[:, 0]] - coords[:, li[:, 1]],
                                    dim=-1)


def auxnet_nll_loss(params, link_dists, link_exist):
    """Gaussian NLL of observed link distances (ActiveLearning.py:1155-1160):
    the mean over links of [0.5 (mu - d)^2 e^{-log sigma^2}
    + 0.5 log sigma^2] · exist."""
    mu, logvar = params[..., 0], params[..., 1]
    resid = 0.5 * (mu - link_dists) ** 2 * torch.exp(-logvar)
    return ((resid + 0.5 * logvar) * link_exist).mean()
