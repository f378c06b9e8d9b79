"""K-Means for the K-Means and weighted filters, in numpy (the JAX package
calls sklearn, which the card's machine lacks).

`kmeans(X, k, sample_weight, random_state)` reproduces sklearn 1.9.0's
`KMeans(n_clusters=k, random_state=random_state).fit(X, sample_weight)`
for dense float32 or float64 X, step for step:
  * X copied and centred on its column mean; the tolerance
    tol · mean(var(X, axis=0)) from the uncentred X, tol = 1e-4;
  * k-means++ with sample weights (`_kmeans_plusplus`): the first centre
    drawn by RandomState.choice(p = w / Σw), then per centre 2 + int(ln k)
    candidates drawn as uniform · current potential and placed by
    searchsorted on the cumulative sum of w · d², the candidate with the
    least potential kept; distances of float32 data in float64 chunks,
    stored as float32 (`_euclidean_distances_upcast`);
  * one initialisation (n_init "auto" with k-means++);
  * Lloyd, at most 300 iterations: the E-step as ||c||² - 2 x·c in X's
    dtype on chunks of 256 rows, first minimum wins; the M-step's weighted
    sums, empty clusters relocated to the samples farthest from their old
    centres (unless every sample sits on its centre), each centre scaled
    by the reciprocal of its weight and a still empty one put on the
    heaviest; stop on
    equal labels (strict) or a squared centre shift within the tolerance,
    and after a stop of the second kind one more E-step;
  * the centres moved back by the mean.
The float sums run in other orders than sklearn's Cython and BLAS, so a
label can differ only where two centres are within rounding of a tie.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["kmeans"]

_CHUNK = 256        # sklearn's CHUNK_SIZE for the Lloyd E-step
_MAX_ITER = 300     # KMeans' defaults
_TOL = 1e-4


def _row_norms_sq(x):
    return np.einsum("ij,ij->i", x, x)


def _dist_sq_upcast(x, y):
    """sklearn's `_euclidean_distances(x, y, squared=True)` for float32
    data: chunks of both upcast to float64, -2·x·yᵀ + ||x||² + ||y||²,
    stored as float32, clipped at 0.  float64 data in one product."""
    if x.dtype != np.float32:
        d = -2 * (x @ y.T)
        d += _row_norms_sq(x)[:, None]
        d += _row_norms_sq(y)[None, :]
        return np.maximum(d, 0, out=d)
    nx, ny, nf = x.shape[0], y.shape[0], x.shape[1]
    maxmem = max(((nx + ny) * nf + nx * ny) / 10, 10 * 2 ** 17)
    tmp = 2 * nf
    batch = max(int((-tmp + math.sqrt(tmp ** 2 + 4 * maxmem)) / 2), 1)
    out = np.empty((nx, ny), np.float32)
    for i in range(0, nx, batch):
        xc = x[i:i + batch].astype(np.float64)
        xx = _row_norms_sq(xc)[:, None]
        for j in range(0, ny, batch):
            yc = y[j:j + batch].astype(np.float64)
            d = -2 * (xc @ yc.T)
            d += xx
            d += _row_norms_sq(yc)[None, :]
            out[i:i + batch, j:j + batch] = d.astype(np.float32)
    return np.maximum(out, 0, out=out)


def _kmeans_plusplus(x, k, w, rng):
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), x.dtype)
    n_trials = 2 + int(np.log(k))
    center_id = rng.choice(n, p=w / w.sum())
    centers[0] = x[center_id]
    closest = _dist_sq_upcast(x[center_id][None], x)
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rng.uniform(size=n_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _dist_sq_upcast(x[cand], x)
        np.minimum(closest, d, out=d)
        cand_pot = d @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = d[best]
        centers[c] = x[cand[best]]
    return centers


def _assign(x, centers):
    """E-step: labels by the first least ||c||² - 2 x·c, chunks of 256."""
    c_sq = _row_norms_sq(centers)
    labels = np.empty(x.shape[0], np.int32)
    for s in range(0, x.shape[0], _CHUNK):
        pd = c_sq[None, :] + (-2 * (x[s:s + _CHUNK] @ centers.T))
        labels[s:s + _CHUNK] = np.argmin(pd, axis=1)
    return labels


def _lloyd_step(x, w, centers):
    """One E- and M-step: (labels, new centres)."""
    k = centers.shape[0]
    labels = _assign(x, centers)
    # weighted sums in X's dtype, sample by sample within a chunk of 256,
    # the chunks' sums added in order
    sums = np.zeros_like(centers)
    wic = np.zeros(k, x.dtype)
    for s in range(0, x.shape[0], _CHUNK):
        lab, ws = labels[s:s + _CHUNK], w[s:s + _CHUNK]
        chunk_sums, chunk_w = np.zeros_like(centers), np.zeros(k, x.dtype)
        np.add.at(chunk_sums, lab, x[s:s + _CHUNK] * ws[:, None])
        np.add.at(chunk_w, lab, ws)
        sums += chunk_sums
        wic += chunk_w
    empty = np.where(wic == 0)[0]
    if len(empty):
        # `_relocate_empty_clusters_dense`; pointless, and skipped, when
        # every sample sits on its centre (more clusters than distinct
        # samples)
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new, i in zip(empty, far):
                old = labels[i]
                sums[old] -= x[i] * w[i]
                sums[new] = x[i] * w[i]
                wic[new] = w[i]
                wic[old] -= w[i]
    # `_average_centers`, in its order: an empty cluster takes the
    # heaviest one's row as it stands then (scaled only if it came first)
    heaviest = np.argmax(wic)
    for j in range(k):
        if wic[j] > 0:
            sums[j] *= x.dtype.type(1.0 / float(wic[j]))
        else:
            sums[j] = sums[heaviest]
    return labels, sums


def kmeans(X, k, sample_weight=None, random_state: int = 318):
    """Returns (labels (n,) int32, centres (k, d) in X's dtype)."""
    x = np.array(X, dtype=X.dtype if X.dtype in (np.float32, np.float64)
                 else np.float64, order="C", copy=True)
    w = np.ones(x.shape[0], x.dtype) if sample_weight is None \
        else np.asarray(sample_weight, x.dtype)
    rng = np.random.RandomState(random_state)
    tol = np.mean(np.var(x, axis=0)) * _TOL
    mean = x.mean(axis=0)
    x -= mean
    centers = _kmeans_plusplus(x, k, w, rng)
    labels_old = np.full(x.shape[0], -1, np.int32)
    strict = False
    for _ in range(_MAX_ITER):
        labels, new = _lloyd_step(x, w, centers)
        shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    return labels, centers + mean
