"""Approximate nearest neighbours for large unlabeled pools (counterpart of
vatl4pose_tpu/al/ann.py; active_learning/approximate_nearest_neighbors.py:
22-135, an annoy-backed drop-in for sklearn's KNeighborsTransformer with
the angular metric, which the shipped pipeline does not use).

Random-hyperplane LSH buckets and an exact re-ranking inside the candidate
buckets, with the transformer's API (fit_transform → a sparse distance
matrix), plus the module's self-test.  numpy and scipy.  For the pools the
VATL loop sees (a few thousand samples a video) the exact path
(selection.cosine_distance_rowsums, one product on the card) is faster.
"""

from __future__ import annotations

import numpy as np


class LshTransformer:
    """mode='distance', metric='angular' (annoy's metric: sqrt(2-2cos))."""

    def __init__(self, n_neighbors: int = 5, n_planes: int = 6,
                 n_tables: int = 16, seed: int = 0):
        self.n_neighbors = n_neighbors
        self.n_planes = n_planes
        self.n_tables = n_tables
        self.seed = seed

    def fit(self, X):
        X = np.asarray(X, np.float32)
        self._X = X
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        self._Xn = X / np.maximum(norms, 1e-12)
        rng = np.random.default_rng(self.seed)
        self._planes = rng.normal(
            size=(self.n_tables, X.shape[1], self.n_planes)).astype(
                np.float32)
        # hash codes per table: (T, N)
        bits = (np.einsum("nd,tdp->tnp", self._Xn, self._planes) > 0)
        self._codes = np.packbits(
            bits, axis=-1, bitorder="little")[..., 0].astype(np.int64) \
            if self.n_planes <= 8 else \
            (bits * (1 << np.arange(self.n_planes))).sum(-1)
        self._buckets = []
        for t in range(self.n_tables):
            d = {}
            for i, c in enumerate(self._codes[t]):
                d.setdefault(int(c), []).append(i)
            self._buckets.append(d)
        return self

    def _candidates(self, i):
        cand = set()
        for t in range(self.n_tables):
            cand.update(self._buckets[t].get(int(self._codes[t][i]), ()))
        cand.discard(i)
        return np.fromiter(cand, dtype=np.int64) if cand else \
            np.zeros(0, np.int64)

    def fit_transform(self, X):
        """Returns a scipy CSR (N, N) of angular distances to (up to)
        n_neighbors approximate neighbors per row."""
        from scipy.sparse import csr_matrix
        self.fit(X)
        N = len(self._X)
        rows, cols, vals = [], [], []
        for i in range(N):
            cand = self._candidates(i)
            if len(cand) == 0:
                continue
            cos = self._Xn[cand] @ self._Xn[i]
            dist = np.sqrt(np.maximum(2.0 - 2.0 * cos, 0.0))
            order = np.argsort(dist)[: self.n_neighbors]
            rows.extend([i] * len(order))
            cols.extend(cand[order].tolist())
            vals.extend(dist[order].tolist())
        return csr_matrix((vals, (rows, cols)), shape=(N, N))


def test_transformers(n: int = 200, d: int = 32, seed: int = 0):
    """Self-test mirroring approximate_nearest_neighbors.py:83-96: recall of
    the approximate neighbors vs exact angular kNN on clustered data (the
    regime real embeddings live in)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 3
    X = (centers[rng.integers(0, 8, n)]
         + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    k = 5
    ann = LshTransformer(n_neighbors=k, seed=seed).fit_transform(X)
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    exact = np.sqrt(np.maximum(2 - 2 * (Xn @ Xn.T), 0))
    np.fill_diagonal(exact, np.inf)
    hits = total = 0
    for i in range(n):
        true_nn = set(np.argsort(exact[i])[:k].tolist())
        approx = set(ann.getrow(i).indices.tolist())
        hits += len(true_nn & approx)
        total += k
    return hits / total
