"""The port's query selection (vatl4pose_tpu_torch/al/selection.py) and AL
metrics against the JAX package's on the same seeded numpy inputs: the
same index lists, and the f64 coreset greedy exactly the JAX one."""

import numpy as np
import pytest
import torch

from vatl4pose_tpu.al import al_metric as jax_metric
from vatl4pose_tpu.al import selection as jsel
from vatl4pose_tpu_torch.al import al_metric, selection as sel
from vatl4pose_tpu_torch.al.index_sets import IndexCollection
from vatl4pose_tpu.al.index_sets import IndexCollection as JaxIndexCollection

torch.set_num_threads(1)


def pool(seed, n=48, dim=64):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 1, (n, dim)).astype(np.float32)
    unc = rng.uniform(0, 1, n)
    labeled = sorted(rng.choice(n, 6, replace=False).tolist())
    return emb, unc, labeled


def test_rank_candidates_with_ties_equals_jax():
    rng = np.random.default_rng(3)
    ids = rng.permutation(60).tolist()
    scores = np.round(rng.uniform(0, 1, 60) * 4) / 4      # many ties
    for k in (None, 1, 7, 60):
        assert sel.rank_candidates(ids, scores, top_k=k) \
            == jsel.rank_candidates(ids, scores, top_k=k)


@pytest.mark.parametrize("mode", ["const", "increase", "decrease"])
def test_fuse_thc_wpu_equals_jax(mode):
    rng = np.random.default_rng(5)
    thc, wpu = rng.uniform(0, 3, 30), rng.uniform(0, 0.1, 30)
    got = sel.fuse_thc_wpu(thc, wpu, 0.3, mode=mode)
    np.testing.assert_array_equal(got, jsel.fuse_thc_wpu(thc, wpu, 0.3,
                                                         mode=mode))
    ids = list(range(100, 130))
    assert sel.rank_candidates(ids, got, 8) == jsel.rank_candidates(
        ids, jsel.fuse_thc_wpu(thc, wpu, 0.3, mode=mode), 8)
    infl = rng.uniform(0, 1, 30)
    np.testing.assert_array_equal(sel.total_scores(got, infl, 0.4),
                                  jsel.total_scores(got, infl, 0.4))


def test_influence_scores_close_to_jax():
    """f32 cosine products in another summation order: the min-max
    normalized scores agree within 1e-5, and rank the same."""
    emb, _, _ = pool(7)
    got = sel.influence_scores(emb, device="cpu")
    want = jsel.influence_scores(emb)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(np.argsort(-got, kind="stable"),
                          np.argsort(-want, kind="stable"))


def test_diversity_and_random_filters_equal_jax():
    emb, _, _ = pool(9)
    cands = list(range(3, 40, 2))
    assert sel.diversity_filter(emb, cands, 5, device="cpu") \
        == jsel.diversity_filter(emb, cands, 5)
    assert sel.random_filter(cands, 6, np.random.RandomState(4)) \
        == jsel.random_filter(cands, 6, np.random.RandomState(4))


def test_euclidean_distances_equal_sklearn():
    from sklearn.metrics import pairwise_distances
    emb, _, labeled = pool(11)
    x = emb.astype(np.float64)
    for y in (x[labeled], x[[17]]):
        np.testing.assert_array_equal(
            sel.euclidean_distances(x, y),
            pairwise_distances(x, y, metric="euclidean"))


# (mode, with labeled samples)
CORESET_CASES = [("dynamic", True), ("dynamic", False), ("fixed", True),
                 ("fixed", False), ("plain", True)]


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("mode,with_labeled", CORESET_CASES)
def test_coreset_selection_equals_jax(mode, with_labeled, precision):
    emb, unc, labeled = pool(13 + CORESET_CASES.index((mode, with_labeled)))
    labeled = labeled if with_labeled else []
    args = (emb, unc, labeled, 12, 0.5, 0.4)
    got = sel.coreset_selection(*args, mode=mode, precision=precision,
                                rng=np.random.RandomState(0), device="cpu")
    want = jsel.coreset_selection(*args, mode=mode, precision=precision,
                                  rng=np.random.RandomState(0))
    assert got == want
    assert len(set(got)) == 12 and not set(got) & set(labeled)


def test_coreset_f32_clamps_to_pool_and_skips_taken():
    """Degenerate embeddings (all equal): the taken-mask still gives
    distinct picks outside the labeled set, at most the pool's size."""
    emb = np.ones((9, 4), np.float32)
    got = sel.coreset_selection(emb, np.zeros(9), [2, 5], 20, 0.5, 0.3,
                                device="cpu")
    assert sorted(got) == [0, 1, 3, 4, 6, 7, 8]
    assert len(sel.coreset_selection(emb, np.zeros(9), [], 20, 0.5, 0.3,
                                     device="cpu")) == 9


def test_coreset_plain_first_pick_in_range():
    """The JAX package's f32 path draws the plain first pick from its
    padded bucket (np.arange(32) for 10 samples, selection.py:248-252):
    with RandomState(0) it returns index 12 of a 10-sample pool.  The port
    draws from np.arange(10), as the JAX f64 path and the reference do."""
    rng = np.random.default_rng(17)
    emb = rng.normal(0, 1, (10, 8)).astype(np.float32)
    args = (emb, np.zeros(10), [], 3, 0.0, 0.0)
    jax_f32 = jsel.coreset_selection(*args, mode="plain",
                                     rng=np.random.RandomState(0))
    assert jax_f32[0] == 12                          # past the pool
    jax_f64 = jsel.coreset_selection(*args, mode="plain", precision="f64",
                                     rng=np.random.RandomState(0))
    for precision in ("f32", "f64"):
        got = sel.coreset_selection(*args, mode="plain", precision=precision,
                                    rng=np.random.RandomState(0),
                                    device="cpu")
        assert got == jax_f64 and max(got) < 10


def embedding_pool(seed, n, dim, repeats):
    """GAP-like embeddings (ReLU'd, f32) with `repeats` rows equal to row
    0, so that the weighted filter's dedupe has work to do."""
    rng = np.random.default_rng(seed)
    emb = np.maximum(rng.normal(0, 1, (n, dim)), 0).astype(np.float32)
    emb[1:1 + repeats] = emb[0]
    cands = sorted(rng.choice(n, n - 4, replace=False).tolist())
    total = rng.uniform(0, 1, len(cands))
    return emb, cands, total


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,n,dim,k", [
    (0, 40, 64, 5), (1, 64, 512, 9), (2, 120, 2048, 17), (3, 24, 32, 20)])
def test_kmeans_filter_matches_jax(weighted, seed, n, dim, k):
    """The port's numpy K-Means against the JAX package's sklearn one, as
    the AL loop calls each filter (the weighted one with the loop's
    weights 1 + w_unc * combine_weight * total and dedupe): the same picks
    in the same order, exactly."""
    emb, cands, total = embedding_pool(seed, n, dim, repeats=3)
    kw = dict(weight=1 + 0.01 * 0.4 * total, dedupe=True) if weighted \
        else {}
    got = sel.kmeans_filter(emb, cands, k, **kw)
    want = jsel.kmeans_filter(emb, cands, k, **kw)
    assert got == want
    assert len(set(got)) == len(got) <= k and set(got) <= set(cands)


def test_al_metrics_equal_jax():
    rng = np.random.default_rng(19)
    pct = [0.0, 5.0, 10.0, 20.0, 40.0, 100.0]
    perf = rng.uniform(0, 100, len(pct))
    assert al_metric.compute_alc(pct, perf) == jax_metric.compute_alc(pct,
                                                                      perf)
    assert al_metric.auc([3, 2, 0], [1, 2, 2]) \
        == jax_metric.compute_alc([300, 200, 0], [100, 200, 200])
    unc = {i: float(v) for i, v in enumerate(rng.uniform(0, 1, 25))}
    oks = {i: float(v) for i, v in enumerate(rng.uniform(0, 1, 25))}
    assert al_metric.compute_spearmanr(unc, oks) \
        == jax_metric.compute_spearmanr(unc, oks)
    assert al_metric.compute_corr(unc, oks) == jax_metric.compute_corr(unc,
                                                                       oks)


def test_index_collection_equals_jax():
    ops = [("update", [3, 1, 3, 7]), ("difference_update", [1]),
           ("update", [9, 1]), ("difference_update", [3, 42])]
    a, b = IndexCollection(range(4)), JaxIndexCollection(range(4))
    for op, items in ops:
        getattr(a, op)(items)
        getattr(b, op)(items)
        assert a.index == b.index and len(a) == len(b)
    assert (7 in a) == (7 in b)
