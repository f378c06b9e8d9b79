"""The port's ops (vatl4pose_tpu_torch/ops) against the JAX package's on
the same numpy inputs, on the CPU."""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from vatl4pose_tpu import ops as jops
from vatl4pose_tpu_torch import ops as tops

torch.set_num_threads(1)
RNG = np.random.default_rng(1207)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def boxes(n, w, h):
    x0 = RNG.uniform(-10, w * 0.7, n)
    y0 = RNG.uniform(-10, h * 0.6, n)
    return np.stack([x0, y0, x0 + RNG.uniform(15, w * 0.5, n),
                     y0 + RNG.uniform(20, h * 0.6, n)], 1).astype(np.float32)


def test_affine_helpers():
    bb = boxes(9, 200, 150)
    x, y = bb[:, 0], bb[:, 1]
    w, h = bb[:, 2] - x, bb[:, 3] - y
    c_ref, s_ref = jops.box_to_center_scale(x, y, w, h, 0.75)
    c, s = tops.box_to_center_scale(t(x), t(y), t(w), t(h), 0.75)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    np.testing.assert_allclose(
        tops.center_scale_to_box(c, s).numpy(),
        np.asarray(jops.center_scale_to_box(c_ref, s_ref)), rtol=1e-6)
    rot = RNG.uniform(-40, 40, 9).astype(np.float32)
    for inv in (False, True):
        ref = jops.get_affine_transform(c_ref, s_ref, rot, (48, 64), inv=inv)
        got = tops.get_affine_transform(c, s, t(rot), (48, 64), inv=inv)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)
    coords = RNG.uniform(0, 48, (9, 17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tops.transform_preds(t(coords), c, s, (48, 64)).numpy(),
        np.asarray(jops.transform_preds(jnp.asarray(coords), c_ref, s_ref,
                                        (48, 64))), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tops.bbox_xyxy_to_xywh(t(bb)).numpy(),
                                  np.asarray(jops.bbox_xyxy_to_xywh(bb)))


@pytest.mark.parametrize("chunked", [False, True])
def test_crop_batch(monkeypatch, chunked):
    frames = RNG.integers(0, 256, (3, 90, 120, 3), dtype=np.uint8)
    bb = boxes(7, 120, 90)
    fidx = RNG.integers(0, 3, 7)
    if chunked:   # force the sub-chunked frames[fi] gather
        from vatl4pose_tpu_torch.ops import warp
        monkeypatch.setattr(warp, "_WARP_BUDGET_BYTES", 3 * 90 * 120 * 4 * 2)
    ref, ref_bc = jops.crop_batch(jnp.asarray(frames, jnp.float32), fidx, bb,
                                  (64, 48), normalize=False)
    got, bc = tops.crop_batch(t(frames), fidx, t(bb), (64, 48),
                              normalize=False)
    assert got.shape == (7, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_allclose(bc.numpy(), np.asarray(ref_bc), rtol=1e-6)
    refn, _ = jops.crop_batch(jnp.asarray(frames, jnp.float32), fidx, bb,
                              (64, 48))
    gotn, _ = tops.crop_batch(t(frames), fidx, t(bb), (64, 48))
    np.testing.assert_allclose(gotn.numpy(), np.asarray(refn), atol=1e-3 / 255)


@pytest.mark.parametrize("src", [np.uint8, np.float32])
def test_crop_batch_through_the_crop_kernel_matches_jax(src):
    """The scoring crop, now the crop kernel's plain (gather) form with
    rot=0 matrices, against the JAX package's separable crop_batch in f32,
    from uint8 or float32 frames, on boxes past every frame edge and one
    wholly outside: the two forms differ by f32 rounding only, max |err|
    <= 1e-3/255 on the normalized crops; bf16 crops are the f32 crops
    rounded once."""
    frames = RNG.integers(0, 256, (3, 90, 120, 3)).astype(src)
    bb = np.concatenate([boxes(6, 120, 90), np.array(
        [[-30, 10, 25, 70], [90, -25, 150, 40], [40, 60, 80, 130],
         [-80, -60, -20, -5]], np.float32)])
    fidx = RNG.integers(0, 3, len(bb))
    ref, ref_bc = jops.crop_batch(jnp.asarray(frames, jnp.float32), fidx, bb,
                                  (64, 48))
    got, bc = tops.crop_batch(t(frames), fidx, t(bb), (64, 48))
    assert got.dtype == torch.float32 and got.shape == (10, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3 / 255)
    np.testing.assert_allclose(bc.numpy(), np.asarray(ref_bc), rtol=1e-6)
    mean = torch.from_numpy(tops.RGB_MEAN)
    assert torch.equal(got[9], (-mean).expand_as(got[9]))   # wholly outside
    got16, _ = tops.crop_batch(t(frames), fidx, t(bb), (64, 48),
                               dtype=torch.bfloat16)
    assert torch.equal(got16, got.to(torch.bfloat16))


def planted_heatmaps(n=6, k=5, h=16, w=12):
    """Noise plus the cases the decode must get right: an all-negative
    map, a tied maximum, a maximum on the border, a quantized map full of
    ties, and an all-zero map."""
    hms = RNG.normal(0.1, 0.4, (n, k, h, w)).astype(np.float32)
    hms[1] = -np.abs(hms[1]) - 1e-3
    hms[2, :, 3, 4] = hms[2, :, 9, 7] = 5.0
    hms[3, :, 0, 5] = 6.0
    hms[3, 1, h - 1, w - 1] = 7.0
    hms[4] = np.round(hms[4] * 3) / 3
    hms[5, 0] = 0.0
    return hms


def test_max_pred_subpixel_and_peaks():
    hms = planted_heatmaps()
    c_ref, m_ref = jops.get_max_pred(jnp.asarray(hms))
    c, m = tops.get_max_pred(t(hms))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    assert (c.numpy()[2, :] == [4.0, 3.0]).all()       # first tie wins
    np.testing.assert_array_equal(
        tops.subpixel_refine(t(hms), c).numpy(),
        np.asarray(jops.subpixel_refine(jnp.asarray(hms), c_ref)))
    # the port's filter is scipy's (constant-0 border only); the JAX one
    # also starts every window at 0, so it reads max(0, window) where a
    # whole interior window is negative (ROADMAP C).  localpeak_mean is
    # the same either way: a kept peak is >= half the map's max.
    mf = tops.max_filter2d(t(hms), 3).numpy()
    np.testing.assert_array_equal(
        mf, scipy.ndimage.maximum_filter(hms, (1, 1, 3, 3), mode="constant",
                                         cval=0.0))
    np.testing.assert_array_equal(
        np.maximum(mf, 0.0),
        np.asarray(jops.max_filter2d(jnp.asarray(hms), 3)))
    np.testing.assert_allclose(
        tops.localpeak_mean(t(hms)).numpy(),
        np.asarray(jops.localpeak_mean(jnp.asarray(hms))), rtol=1e-5)


def test_heatmap_to_coord():
    hms = planted_heatmaps(n=8)
    bb = boxes(8, 300, 200)
    ref, ref_s = jops.heatmap_to_coord(jnp.asarray(hms), jnp.asarray(bb))
    got, s = tops.heatmap_to_coord(t(hms), t(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_compute_oks():
    n, k = 10, 17
    gt = np.zeros((n, 3 * k), np.float32)
    gt[:, 0::3] = RNG.uniform(0, 100, (n, k))
    gt[:, 1::3] = RNG.uniform(0, 100, (n, k))
    gt[:, 2::3] = RNG.uniform(0, 1, (n, k)) > 0.3
    gt[0, 2::3] = 0                                    # no visible joint
    pred = gt + RNG.normal(0, 4, gt.shape).astype(np.float32)
    bb = np.stack([RNG.uniform(0, 20, n), RNG.uniform(0, 20, n),
                   RNG.uniform(40, 90, n), RNG.uniform(60, 120, n)],
                  1).astype(np.float32)
    ref = jops.compute_oks(jnp.asarray(pred), jnp.asarray(gt),
                           jnp.asarray(bb))
    got = tops.compute_oks(t(pred), t(gt), t(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_thc_scores(norm):
    hms = RNG.normal(0, 1, (7, 4, 8, 6)).astype(np.float32)
    is_prev = np.array([0, 1, 1, 0, 1, 0, 1], bool)
    is_next = np.array([1, 1, 0, 1, 0, 0, 0], bool)
    ref = jops.thc_scores(jnp.asarray(hms), is_prev, is_next, norm_type=norm)
    got = tops.thc_scores(t(hms), t(is_prev), t(is_next), norm_type=norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    wp, wn = tops.temporal_neighbor_weights(t(is_prev), t(is_next))
    rp, rn = jops.temporal_neighbor_weights(is_prev, is_next)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(wn.numpy(), np.asarray(rn))


@pytest.mark.parametrize("drop_ears", [True, False])
def test_compute_hybrid(drop_ears):
    n = 9
    kp = np.zeros((n, 51), np.float32)
    kp[:, 0::3] = RNG.uniform(0, 100, (n, 17))
    kp[:, 1::3] = RNG.uniform(0, 200, (n, 17))
    kp[:, 2::3] = RNG.uniform(0.05, 1, (n, 17))
    bb = np.stack([RNG.uniform(0, 20, n), RNG.uniform(0, 20, n),
                   RNG.uniform(40, 90, n), RNG.uniform(60, 120, n)],
                  1).astype(np.float32)
    ref = jops.compute_hybrid(jnp.asarray(bb), jnp.asarray(kp),
                              drop_ears=drop_ears)
    got = tops.compute_hybrid(t(bb), t(kp), drop_ears=drop_ears)
    assert got.shape == (n, 38 if drop_ears else 42)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
