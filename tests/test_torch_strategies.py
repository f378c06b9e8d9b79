"""The port's other AL strategies (TPC, the peak-based MPE, Margin and
Entropy, VL4Pose with its AuxNet, the LSH kNN and the UNC_LAMBDA study's
samplers) against the JAX package's on the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vatl4pose_tpu.al import ann as jax_ann
from vatl4pose_tpu.al import optuna_lite as jax_optuna
from vatl4pose_tpu.models.auxnet import AuxNet as FlaxAuxNet
from vatl4pose_tpu.ops import heatmap as jax_heatmap
from vatl4pose_tpu.ops import peaks as jax_peaks
from vatl4pose_tpu.ops import temporal as jax_temporal
from vatl4pose_tpu.ops import vl4pose as jax_vl4pose
from tests.test_torch_models import random_flax_variables
from vatl4pose_tpu_torch.al import ann, optuna_lite
from vatl4pose_tpu_torch.models import COCO_LINKS, AuxNet, state_dict_from_flax
from vatl4pose_tpu_torch.ops import (compute_entropy, compute_margin,
                                     compute_mpe, get_max_pred,
                                     peak_local_max_topk, subpixel_refine,
                                     tpc_scores)
from vatl4pose_tpu_torch.ops import vl4pose

torch.set_num_threads(1)
H, W = 32, 24


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def blob_maps(rng, n, k, peaks=3):
    """(n, k, H, W) f32 maps: noise plus `peaks` Gaussian blobs of random
    height at random places, so that each map has several local maxima."""
    yy, xx = np.mgrid[:H, :W]
    hms = rng.normal(0, 0.02, (n, k, H, W))
    for _ in range(peaks):
        cy = rng.uniform(0, H, (n, k, 1, 1))
        cx = rng.uniform(0, W, (n, k, 1, 1))
        amp = rng.uniform(0.2, 1.0, (n, k, 1, 1))
        hms += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
    return hms.astype(np.float32)


def hard_maps(rng):
    """(8, 17, H, W) maps with the cases the scan must get right: noise
    maps, maps whose only local maxima are negative (a window that starts
    at 0 never takes them), constant maps (no pixel above the global min),
    maps whose peaks sit in the 5-pixel border, and maps with one peak."""
    hms = blob_maps(rng, 8, 17)
    hms[1] = -np.abs(hms[1]) - 0.5                  # all negative
    hms[2, :8] = 0.3                                # constant
    hms[2, 8:] = 0.0
    border = np.zeros((17, H, W), np.float32)
    border[:, 2, 3] = 1.0                           # in the border
    border[:, H - 2, W // 2] = 0.8
    border[:, 15, 12] = 0.5                         # one interior peak
    hms[3] = border
    one = np.zeros((17, H, W), np.float32)
    one[:, 16, 11] = 1.0                            # a single peak
    hms[4] = one
    hms[5, :, :, :] = np.round(hms[5] * 4) / 4      # many equal values
    return hms


def jax_peaks_of(hms):
    """The JAX package's per-map scan over every map: (vals, valid, ys,
    xs)."""
    flat = jnp.asarray(hms.reshape(-1, H, W))
    vals, valid, ys, xs = jax.vmap(
        lambda h: jax_vl4pose._topk_peaks_with_loc(h, 5, 5))(flat)
    shape = hms.shape[:-2] + (5,)
    return tuple(np.asarray(a).reshape(shape) for a in (vals, valid, ys, xs))


def test_peak_scan_matches_jax_exactly():
    """The batched scan (one window max, 5 rounds of argmax and Chebyshev
    suppression over all maps at once) against the JAX package's
    per-map scan: the same values, validity and places, bit for bit,
    and its own peak_local_max_topk's values and validity too."""
    hms = hard_maps(np.random.default_rng(11))
    vals, valid, ys, xs = (a.numpy() for a in peak_local_max_topk(t(hms)))
    want = jax_peaks_of(hms)
    np.testing.assert_array_equal(vals, want[0])
    np.testing.assert_array_equal(valid, want[1])
    np.testing.assert_array_equal(ys, want[2])
    np.testing.assert_array_equal(xs, want[3])
    jv, jvalid = jax.vmap(lambda h: jax_peaks.peak_local_max_topk(h))(
        jnp.asarray(hms.reshape(-1, H, W)))
    np.testing.assert_array_equal(vals.reshape(-1, 5), np.asarray(jv))
    np.testing.assert_array_equal(valid.reshape(-1, 5), np.asarray(jvalid))
    # the cases are there: no peak on the negative and constant maps, one
    # on the border map (its interior one) and on the single-peak map,
    # and several on most noise maps
    assert not valid[1].any() and not valid[2].any()
    assert valid[3, :, 0].all() and not valid[3, :, 1].any()
    assert valid[4, :, 0].all() and not valid[4, :, 1].any()
    assert (valid[0].sum(-1) >= 2).mean() > 0.5


@pytest.mark.parametrize("fn,jfn", [
    (compute_mpe, jax_peaks.compute_mpe),
    (compute_margin, jax_peaks.compute_margin),
    (compute_entropy, jax_peaks.compute_entropy)])
def test_peak_criteria_match_jax(fn, jfn):
    """MPE, Margin and Entropy per sample against the JAX package's, on
    the hard maps and on positive maps (where Entropy is finite):
    within 1e-5 (rtol; the softmax and log run in another order), -inf
    where the JAX entropy has it."""
    rng = np.random.default_rng(12)
    for hms in (hard_maps(rng), np.abs(blob_maps(rng, 6, 17)) + 1e-3):
        got = fn(t(hms)).numpy()
        want = np.asarray(jfn(jnp.asarray(hms)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all()


def test_tpc_matches_jax():
    """TPC from the pass's heatmap-space decode (the port's) against the
    JAX package's second decode of the rolled maps: equal counts.  The
    maps hold one clear blob per joint, and every joint's distance to its
    neighbours' decodes is at least 1% away from 0.01·sqrt(crop area), so
    no count rides on f32 rounding."""
    rng = np.random.default_rng(13)
    n, k = 12, 17
    yy, xx = np.mgrid[:H, :W]
    cy = rng.uniform(3, H - 3, (n, k, 1, 1))
    cx = rng.uniform(3, W - 3, (n, k, 1, 1))
    cy[1::2] = cy[::2] + rng.choice([0.0, 0.0, 4.0], (n // 2, k, 1, 1))
    cx[1::2] = cx[::2]
    hms = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 3.0).astype(np.float32)
    x0 = rng.uniform(0, 100, n)
    y0 = rng.uniform(0, 100, n)
    bb = np.stack([x0, y0, x0 + rng.uniform(30, 90, n),
                   y0 + rng.uniform(40, 120, n)], 1).astype(np.float32)
    is_prev = np.ones(n, bool)
    is_next = np.ones(n, bool)
    is_prev[[0, 5]] = False
    is_next[[4, 11]] = False
    coords, _ = jax_heatmap.heatmap_to_coord(jnp.asarray(hms),
                                             jnp.asarray(bb))
    want = np.asarray(jax_temporal.tpc_scores(
        jnp.asarray(hms), coords, jnp.asarray(bb), jnp.asarray(is_prev),
        jnp.asarray(is_next)))
    # the inputs keep every distance clear of the threshold
    thresh = 0.01 * np.sqrt((bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1]))
    for shift in (1, -1):
        nb, _ = jax_heatmap.heatmap_to_coord(
            jnp.roll(jnp.asarray(hms), shift, axis=0), jnp.asarray(bb))
        d = np.linalg.norm(np.asarray(coords) - np.asarray(nb), axis=-1)
        assert (np.abs(d - thresh[:, None]) > 0.01 * thresh[:, None]).all()
    hm_coords, _ = get_max_pred(t(hms))
    hm_coords = subpixel_refine(t(hms), hm_coords)
    got = tpc_scores(hm_coords, t(np.array(coords)), t(bb),
                     t(is_prev), t(is_next), (W, H)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() < 17 < got.max()          # some joints stay, some move


@pytest.fixture(scope="module")
def aux_vars():
    return random_flax_variables(FlaxAuxNet(), jnp.zeros((1, 8, 6, 2048)),
                                 np.random.default_rng(14))


@pytest.mark.parametrize("hw", [(8, 6), (4, 3)])
def test_auxnet_matches_flax(aux_vars, hw):
    """The AuxNet after state_dict_from_flax(..., "auxnet") against the
    Flax module on the same feature, NHWC there and NCHW here: within 1e-5
    of the output's scale.  8x6 is R50's stride-32 feature at 256x192
    (its second stage adds a 2x1 pool to a 2x2 convolution, broadcast)."""
    feat = np.random.default_rng(15).normal(0, 1, (3, *hw, 2048)) \
        .astype(np.float32)
    want = np.asarray(FlaxAuxNet().apply(jax.tree.map(jnp.asarray, aux_vars),
                                         jnp.asarray(feat)))
    net = AuxNet(device="cpu")
    net.load_state_dict(state_dict_from_flax(aux_vars, "auxnet"))
    with torch.no_grad():
        got = net(t(feat.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (3, 16, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_auxnet_default_init_is_seeded():
    a = AuxNet(in_channels=64, device="cpu")
    b = AuxNet(in_channels=64, device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.proj.weight, AuxNet(in_channels=64, seed=1,
                                                 device="cpu").proj.weight)


def test_vl4pose_functions_match_jax():
    """vl4pose_scores on the hard maps, pairwise_link_distances and
    auxnet_nll_loss against the JAX package's: within 1e-5 (rtol)."""
    rng = np.random.default_rng(16)
    hms = hard_maps(rng)
    params = np.stack([rng.uniform(2, 10, (8, 16)),
                       rng.uniform(-1, 2, (8, 16))], -1).astype(np.float32)
    got = vl4pose.vl4pose_scores(t(hms), t(params)).numpy()
    want = np.asarray(jax_vl4pose.vl4pose_scores(jnp.asarray(hms),
                                                 jnp.asarray(params)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert np.isfinite(got).all() and (got != 0).any()
    coords = rng.uniform(0, 50, (8, 17, 2)).astype(np.float32)
    d = vl4pose.pairwise_link_distances(t(coords)).numpy()
    np.testing.assert_allclose(d, np.asarray(
        jax_vl4pose.pairwise_link_distances(jnp.asarray(coords))),
        rtol=1e-6)
    exist = (rng.uniform(0, 1, (8, 16)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        vl4pose.auxnet_nll_loss(t(params), t(d), t(exist)).item(),
        float(jax_vl4pose.auxnet_nll_loss(jnp.asarray(params), jnp.asarray(d),
                                          jnp.asarray(exist))), rtol=1e-5)
    np.testing.assert_array_equal(COCO_LINKS, jax_vl4pose.COCO_LINKS)


def test_lsh_knn_matches_jax_exactly():
    rng = np.random.default_rng(17)
    x = rng.normal(0, 1, (60, 24)).astype(np.float32)
    got = ann.LshTransformer(n_neighbors=4, seed=3).fit_transform(x)
    want = jax_ann.LshTransformer(n_neighbors=4, seed=3).fit_transform(x)
    assert (got != want).nnz == 0 and got.nnz == want.nnz > 0
    assert ann.test_transformers(n=80) == jax_ann.test_transformers(n=80)


@pytest.mark.parametrize("sampler", ["grid", "tpe"])
def test_study_samplers_match_jax_exactly(sampler):
    """Grid and TPE (12 trials: 10 random, then 2 Parzen proposals) on a
    fixed objective: the same suggestions, values and best trial."""
    def objective(trial):
        x = trial.suggest_float("unc_lambda", 0.001, 100, log=True)
        return -(np.log10(x) - 0.3) ** 2

    studies = []
    for mod in (optuna_lite, jax_optuna):
        s = mod.GridSampler({"unc_lambda": [0.001, 0.1, 10.0]}) \
            if sampler == "grid" else mod.TPESampler(seed=166)
        study = mod.create_study(direction="maximize", sampler=s)
        study.optimize(objective, n_trials=12)
        studies.append(study)
    got, want = studies
    assert got.history() == want.history()
    assert got.best_params == want.best_params
    assert got.best_value == want.best_value
