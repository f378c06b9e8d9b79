"""Query selection: influence, candidate ranking, filters, coreset
(counterpart of vatl4pose_tpu/al/selection.py).

Reference ActiveLearning.py:
  - influence (:467-484): cosine-distance row sums over the unlabeled
    embeddings (KNeighborsTransformer with n_neighbors=N-1 is the full row
    sum, the self-distance being 0), min-max normalized;
  - score combination (:486-519): min-max normalized uncertainty, THC+WPU
    fusion with const/increase/decrease scheduling, combine-weight mix;
  - candidate ranking (:529-541): stable descending sort of (idx, score);
  - filters (:553-619): weighted K-Means and K-Means (al/kmeans.py, a
    numpy copy of sklearn's KMeans, which the JAX package calls),
    Diversity, Random and Coreset (k-center greedy with an
    uncertainty-biased argmax, :798-850).

Ranking and bookkeeping run on the host in float64 numpy.  The O(N²)
embedding work runs on the device: the cosine matrix product, and the f32
coreset greedy as a torch loop whose state never leaves the device.
Functions that use the device take device=None, which means CUDA.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .kmeans import kmeans

__all__ = [
    "cosine_distance_rowsums", "influence_scores", "minmax", "fuse_thc_wpu",
    "total_scores", "rank_candidates", "kmeans_filter", "diversity_filter",
    "random_filter", "coreset_selection", "euclidean_distances",
]


def minmax(x: np.ndarray) -> np.ndarray:
    """(x - min) / (max - min), the reference's normalization; NaN/inf on
    constant input is inherited behavior (callers guard N<=1)."""
    return (x - np.min(x)) / (np.max(x) - np.min(x))


def cosine_distance_rowsums(embeddings: np.ndarray, device=None) -> np.ndarray:
    """Row sums of 1 - cos similarity with a zero diagonal: the product on
    the device in f32, the sums on the host."""
    x = torch.as_tensor(np.asarray(embeddings, np.float32),
                        device=resolve_device(device))
    xn = x / x.norm(dim=1, keepdim=True).clamp(min=1e-12)
    d = (1.0 - xn @ xn.T).cpu().numpy()
    np.fill_diagonal(d, 0.0)
    return d.sum(axis=1)


def influence_scores(embeddings_unlabeled: np.ndarray,
                     device=None) -> np.ndarray:
    """ActiveLearning.py:470-478."""
    return minmax(cosine_distance_rowsums(embeddings_unlabeled, device))


def fuse_thc_wpu(thc: np.ndarray, wpu: np.ndarray, labeled_ratio: float,
                 mode: str = "const") -> np.ndarray:
    """THC+WPU fusion (:494-510): per-criterion min-max, scheduled mix,
    re-normalized."""
    t = minmax(np.asarray(thc, np.float64))
    w = minmax(np.asarray(wpu, np.float64))
    if mode == "const":
        u = t + w
    elif mode == "increase":
        u = labeled_ratio * t + (1 - labeled_ratio) * w
    elif mode == "decrease":
        u = (1 - labeled_ratio) * t + labeled_ratio * w
    else:
        raise ValueError(mode)
    return minmax(u)


def total_scores(uncertainty: Optional[np.ndarray],
                 influence: Optional[np.ndarray],
                 combine_weight: float) -> np.ndarray:
    """Combine normalized uncertainty and influence (:486-519).
    `uncertainty` is already min-max normalized (or fused)."""
    if uncertainty is None and influence is None:
        raise ValueError("no scores")
    if uncertainty is None:
        return np.asarray(influence, np.float64)
    if influence is None:
        return np.asarray(uncertainty, np.float64)
    return combine_weight * uncertainty + (1 - combine_weight) * influence


def rank_candidates(unlabeled_ids: Sequence[int], scores: np.ndarray,
                    top_k: Optional[int] = None) -> List[int]:
    """Stable descending sort by score, then ascending-id sort of the kept
    slice (:529-541: sorted(...)[:k] then sorted(keys))."""
    ids = list(unlabeled_ids)
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    ranked = [ids[i] for i in order]
    if top_k is not None:
        ranked = ranked[:top_k]
    return sorted(ranked)


def kmeans_filter(embeddings: np.ndarray, candidate_list: List[int],
                  query_size: int, weight: Optional[np.ndarray] = None,
                  dedupe: bool = False, random_state: int = 318) -> List[int]:
    """K-Means / weighted K-Means filters (:553-580, :593-611): cluster the
    candidates (k-means++, seed 318), pick the member of each cluster
    closest to its centroid.  With `weight` the samples are weighted; the
    weighted filter also drops repeated embeddings first (np.unique, which
    keeps each one's first index in sorted order)."""
    emb = embeddings[candidate_list]
    w = weight
    if dedupe:
        _, keep = np.unique(emb, axis=0, return_index=True)
        emb = emb[keep]
        if w is not None:
            w = w[keep]
    else:
        keep = np.arange(len(emb))
    k = min(query_size, len(emb))
    cluster_idx, centroids = kmeans(emb, k, sample_weight=w,
                                    random_state=random_state)
    dis = ((emb - centroids[cluster_idx]) ** 2).sum(axis=1)
    picked = []
    for c in range(len(np.unique(cluster_idx))):
        members = np.arange(emb.shape[0])[cluster_idx == c]
        picked.append(members[dis[cluster_idx == c].argmin()])
    if dedupe:
        picked = [int(keep[p]) for p in picked]
    return [int(candidate_list[p]) for p in picked]


def diversity_filter(embeddings: np.ndarray, candidate_list: List[int],
                     query_size: int, device=None) -> List[int]:
    """Diversity filter (:583-592): ascending cosine row-sum pick."""
    div = cosine_distance_rowsums(embeddings[candidate_list], device)
    pairs = sorted(zip(candidate_list, div), key=lambda x: x[1])
    return [int(i) for i, _ in pairs[:query_size]]


def random_filter(candidate_list: List[int], query_size: int,
                  rng: np.random.RandomState) -> List[int]:
    """random_query (:727-734): draws without replacement through an
    np.random.choice loop on the RandomState handed in."""
    cands = list(candidate_list)
    out = []
    while len(out) < query_size and cands:
        q = int(rng.choice(cands))
        out.append(q)
        cands.remove(q)
    return out


def euclidean_distances(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(len(x), len(y)) float64 distances in sklearn's `pairwise_distances`
    (metric="euclidean") order of operations for float64 inputs:
    -2·x@yᵀ, then +‖x‖², then +‖y‖² (row norms as einsum), clip at 0,
    sqrt.  The a²+b²−2ab expansion cancels for near points; the coreset
    greedy's reference arithmetic depends on it bit for bit."""
    d = -2 * (x @ y.T)
    d += np.einsum("ij,ij->i", x, x)[:, None]
    d += np.einsum("ij,ij->i", y, y)[None, :]
    np.maximum(d, 0, out=d)
    return np.sqrt(d, out=d)


def _coreset_host_f64(embeddings, uncertainty, labeled_idx, query_size,
                      unc_lambda, moks_queried, mode, rng) -> List[int]:
    """Reference-exact f64 greedy (ActiveLearning.py:798-850) on the host.

    The reference holds `fvecs_matrix = np.zeros((N, 2048))` (float64,
    :270) and the uncertainty `np.zeros(N)` (:610), takes distances through
    sklearn `pairwise_distances` (:809; `euclidean_distances` above) and a
    plain `np.argmax`, with no taken-mask: a picked item relies on
    min_dist=0 and unc=0 never to win again (:846 comment), so callers
    clamp query_size to the pickable pool (the AL loop does)."""
    enc = np.asarray(embeddings, np.float64)
    unc = np.asarray(uncertainty, np.float64).copy()
    min_d = None
    if len(labeled_idx) > 0:
        d = euclidean_distances(enc, enc[np.asarray(labeled_idx, np.int64)])
        min_d = np.min(d, axis=1).reshape(-1, 1)
    picks: List[int] = []
    for _ in range(int(query_size)):
        if min_d is None:  # no labeled centers yet: first-pick rule
            if mode == "plain":
                r = rng or np.random.RandomState()
                ind = int(r.choice(np.arange(enc.shape[0])))
            else:
                ind = int(np.argmax(unc))
        else:
            md = min_d.reshape(-1)
            if mode == "dynamic":
                ind = int(np.argmax((1.0 - moks_queried) * md
                                    + unc_lambda * moks_queried * unc))
            elif mode == "fixed":
                ind = int(np.argmax(md + unc_lambda * unc))
            else:
                ind = int(np.argmax(md))
        d = euclidean_distances(enc, enc[[ind]])
        min_d = d if min_d is None else np.minimum(min_d, d)
        unc[ind] = 0.0
        picks.append(ind)
    return picks


@torch.no_grad()
def _coreset_device_f32(embeddings, uncertainty, labeled_idx, query_size,
                        unc_lambda, moks_queried, mode, first_idx,
                        device) -> List[int]:
    """The JAX package's `_coreset_run` (selection.py:280-339) as a torch
    loop on the device, in its f32 arithmetic and operation order, with
    its taken-mask: a picked or labeled sample is never picked (again),
    so degenerate ties (embeddings collapsed to equal values) cannot
    re-pick one index.  The picks stay on the device until one fetch."""
    f32 = torch.float32
    emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    unc = torch.as_tensor(np.asarray(uncertainty, np.float32), device=device)
    n = emb.shape[0]
    moks = torch.tensor(moks_queried, dtype=f32, device=device)
    lam = torch.tensor(unc_lambda, dtype=f32, device=device)
    taken = torch.zeros(n, dtype=torch.bool, device=device)
    if len(labeled_idx) > 0:
        li = torch.as_tensor(np.asarray(labeled_idx, np.int64), device=device)
        sq = (emb * emb).sum(dim=1)
        d2 = sq[:, None] + sq[li][None, :] - 2.0 * (emb @ emb[li].T)
        min_d = d2.clamp(min=0.0).sqrt().amin(dim=1)
        taken[li] = True
    else:
        min_d = torch.full((n,), float("inf"), device=device)
    neg_inf = torch.tensor(float("-inf"), device=device)
    picks = []
    for i in range(int(query_size)):
        if i == 0 and len(labeled_idx) == 0:
            # no centers yet: the preselected random index ('plain') or
            # argmax(unc)
            ind = torch.tensor([first_idx], device=device) \
                if mode == "plain" \
                else torch.where(taken, neg_inf, unc).argmax().view(1)
        else:
            if mode == "dynamic":
                sc = (1.0 - moks) * min_d + lam * moks * unc
            elif mode == "fixed":
                sc = min_d + lam * unc
            else:
                sc = min_d
            ind = torch.where(taken, neg_inf, sc).argmax().view(1)
        # exact distances to the new center (no a²+b²−2ab cancellation)
        dn = (emb - emb.index_select(0, ind)).square().sum(dim=1).sqrt()
        min_d = torch.minimum(min_d, dn)
        unc.index_fill_(0, ind, 0.0)
        taken.index_fill_(0, ind, True)
        picks.append(ind)
    if not picks:
        return []
    return [int(p) for p in torch.cat(picks).cpu()]


def coreset_selection(embeddings: np.ndarray, uncertainty: np.ndarray,
                      labeled_idx: Sequence[int], query_size: int,
                      unc_lambda: float, moks_queried: float,
                      mode: str = "dynamic",
                      rng: Optional[np.random.RandomState] = None,
                      precision: str = "f32", device=None) -> List[int]:
    """k-center greedy with an uncertainty-biased argmax (:798-850).

    mode: 'dynamic'  → argmax((1-mOKS)·min_dist + λ·mOKS·unc)
          'fixed'    → argmax(min_dist + λ·unc)
          'plain'    → argmax(min_dist)  (uncertainty None or λ == 0)
    First pick (no labeled data): argmax(unc) (dynamic/fixed) or a uniform
    draw from the N samples of the pool by `rng` (plain).  Picked items get
    their uncertainty zeroed (:846).

    precision: 'f32' runs the greedy on the device (device=None means
    CUDA) and returns at most as many picks as the pool has unlabeled
    samples; near-tie picks whose score gap lies below f32 resolution may
    swap against the reference's float64.  'f64' is the reference-exact
    host path, for bitwise greedy-order parity (cfg VAL.CORESET_F64).

    The JAX package's f32 path draws the plain first pick from its padded
    bucket, np.arange(bucket_size(N)) (selection.py:248-252), and so can
    return an index past the pool; here both paths draw from np.arange(N),
    as the reference and the JAX f64 path do.
    """
    if precision == "f64":
        return _coreset_host_f64(embeddings, uncertainty, labeled_idx,
                                 query_size, unc_lambda, moks_queried, mode,
                                 rng)
    if precision != "f32":
        raise ValueError(f"precision {precision}")
    n = int(np.asarray(embeddings).shape[0])
    first_idx = 0
    if mode == "plain" and len(labeled_idx) == 0:
        first_idx = int((rng or np.random.RandomState()).choice(np.arange(n)))
    pickable = n - len(set(int(i) for i in labeled_idx))
    return _coreset_device_f32(embeddings, uncertainty, labeled_idx,
                               min(int(query_size), pickable), unc_lambda,
                               moks_queried, mode, first_idx,
                               resolve_device(device))
