"""The port's kernel modules (vatl4pose_tpu_torch/kernels): the plain
PyTorch versions, which the wrappers take for CPU tensors, against the
JAX package's Pallas kernels (interpret mode) and plain references on the
same numpy inputs.  The CUDA kernels against their plain versions are in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vatl4pose_tpu import ops as jops
from vatl4pose_tpu.kernels import fused_bottleneck as jfb
from vatl4pose_tpu.kernels.pallas_postprocess import fused_postprocess \
    as pallas_postprocess
from vatl4pose_tpu_torch.kernels import (fold_bn, fused_bottleneck_chain,
                                         fused_postprocess,
                                         postprocess_reference,
                                         reset_launch_counts)
from vatl4pose_tpu_torch.kernels.fused_bottleneck import \
    bottleneck_chain_reference
from vatl4pose_tpu_torch.ops import localpeak_mean

torch.set_num_threads(1)
RNG = np.random.default_rng(4117)


def folded_weights(nb, C, P):
    """Random folded chain weights as numpy (f32): w1, s1, b1, w2, s2, b2,
    w3, s3, b3."""
    return [RNG.normal(0, 0.1, (nb, C, P)), RNG.uniform(0.5, 1.5, (nb, P)),
            RNG.normal(0, 0.2, (nb, P)), RNG.normal(0, 0.1, (nb, 3, 3, P, P)),
            RNG.uniform(0.5, 1.5, (nb, P)), RNG.normal(0, 0.2, (nb, P)),
            RNG.normal(0, 0.1, (nb, P, C)), RNG.uniform(0.5, 1.5, (nb, C)),
            RNG.normal(0, 0.2, (nb, C))]


def as_torch(ws, dtype):
    return [torch.tensor(w, dtype=dtype if i in (0, 3, 6) else torch.float32)
            for i, w in enumerate(ws)]


def as_jax(ws, dtype):
    return [jnp.asarray(w, dtype if i in (0, 3, 6) else jnp.float32)
            for i, w in enumerate(ws)]


class TestChain:
    # the shapes of tests/test_fused_bottleneck.py:66
    N, H, W, C, P, nb = 2, 6, 5, 16, 4, 3

    def test_plain_matches_jax_reference_and_pallas(self):
        x = RNG.normal(0, 1, (self.N, self.H, self.W, self.C))
        ws = folded_weights(self.nb, self.C, self.P)
        got = fused_bottleneck_chain(torch.tensor(x, dtype=torch.float32),
                                     *as_torch(ws, torch.float32))
        assert got.shape == x.shape and got.dtype == torch.float32
        xj = jnp.asarray(x, jnp.float32)
        ref = jfb.bottleneck_chain_reference(xj, *as_jax(ws, jnp.float32))
        pallas = jfb.fused_bottleneck_chain(xj, *as_jax(ws, jnp.float32),
                                            interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                                   rtol=1e-5, atol=1e-5)

    def test_plain_bf16_stream(self):
        """bf16 stream and conv weights, f32 folded BN: the casts after
        each epilogue are the JAX reference's; tolerance as in the JAX
        package's own bf16 test (one bf16 ulp flips propagate)."""
        x = RNG.normal(0, 1, (self.N, self.H, self.W, self.C))
        ws = folded_weights(self.nb, self.C, self.P)
        got = bottleneck_chain_reference(
            torch.tensor(x, dtype=torch.bfloat16),
            *as_torch(ws, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        ref = jfb.bottleneck_chain_reference(jnp.asarray(x, jnp.bfloat16),
                                             *as_jax(ws, jnp.bfloat16))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=0.05,
                                   atol=0.05)

    def test_fold_bn_matches_jax(self):
        scale, bias, mean = (RNG.normal(0.3, 0.4, 32) for _ in range(3))
        var = np.abs(RNG.normal(0.3, 0.4, 32)) + 0.25
        s, b = fold_bn(*(torch.tensor(a, dtype=torch.float32)
                         for a in (scale, bias, mean, var)))
        rs, rb = jfb.fold_bn(scale, bias, mean, var)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=2e-6,
                                   atol=2e-6)

    def test_k_major_weights_give_the_kernels_gemms(self):
        """The CUDA kernel's three products as plain GEMMs over the
        K-major weights the wrapper lays out (w2: k = tap * P + ci, the
        3x3 as an im2col with zero padding) equal the convolutions of the
        plain version."""
        import torch.nn.functional as F
        from vatl4pose_tpu_torch.kernels.fused_bottleneck import _k_major
        N, H, W, C, P = 2, 5, 3, 16, 8
        x = torch.tensor(RNG.normal(0, 1, (N, H, W, C)), dtype=torch.float64)
        w1, _, _, w2, _, _, w3, _, _ = as_torch(folded_weights(2, C, P),
                                                torch.float64)
        w1t, w2t, w3t = _k_major(w1, w2, w3)
        assert w2t.shape == (2, P, 9, P) and w2t.is_contiguous()
        nchw = x.permute(0, 3, 1, 2)
        y = x[..., :P]
        pad = F.pad(y, (0, 0, 1, 1, 1, 1))       # zero rows and columns
        im2col = torch.cat([pad[:, dy:dy + H, dx:dx + W]
                            for dy in range(3) for dx in range(3)], -1)
        for i in range(2):
            got1 = x.reshape(-1, C) @ w1t[i].t()
            ref1 = F.conv2d(nchw, w1[i].t()[:, :, None, None])
            torch.testing.assert_close(
                got1, ref1.permute(0, 2, 3, 1).reshape(-1, P))
            got2 = im2col.reshape(-1, 9 * P) @ w2t[i].reshape(P, -1).t()
            ref2 = F.conv2d(y.permute(0, 3, 1, 2),
                            w2[i].permute(3, 2, 0, 1), padding=1)
            torch.testing.assert_close(
                got2, ref2.permute(0, 2, 3, 1).reshape(-1, P))
            got3 = y.reshape(-1, P) @ w3t[i].t()
            ref3 = F.conv2d(y.permute(0, 3, 1, 2),
                            w3[i].t()[:, :, None, None])
            torch.testing.assert_close(
                got3, ref3.permute(0, 2, 3, 1).reshape(-1, C))

    def test_cpu_takes_plain_version_and_counts_nothing(self):
        reset_launch_counts()
        x = torch.randn(1, 4, 4, 8)
        ws = as_torch(folded_weights(1, 8, 2), torch.float32)
        out = fused_bottleneck_chain(x, *ws)
        torch.testing.assert_close(out, bottleneck_chain_reference(x, *ws))
        assert fused_bottleneck_chain.launches == 0
        with pytest.raises(ValueError):
            fused_bottleneck_chain(x.to("meta"), *ws)


def planted_heatmaps(n=8, k=5, h=16, w=12):
    """Noise plus an all-negative sample, planted ties of the max, maxima
    on the border and in corners, a quantized sample full of ties, an
    all-zero map, and a tie of two border maxima."""
    hms = RNG.normal(0.1, 0.4, (n, k, h, w)).astype(np.float32)
    hms[1] = -np.abs(hms[1]) - 1e-3
    hms[2, :, 3, 4] = hms[2, :, 9, 7] = 5.0
    hms[3, :, 0, 5] = 6.0
    hms[3, 1, h - 1, w - 1] = 7.0
    hms[3, 2, 7, 0] = 7.0
    hms[4] = np.round(hms[4] * 3) / 3
    hms[5, 0] = 0.0
    hms[6, :, 0, 0] = hms[6, :, h - 1, 0] = 9.0
    hms[7, :, 1, 1] = 8.0                    # on the subpixel window edge
    return hms


class TestPostprocess:
    def test_plain_matches_pallas_and_jax_ops(self):
        hms = planted_heatmaps()
        coords, maxvals, gc = fused_postprocess(torch.from_numpy(hms))
        p_coords, p_maxvals, p_gc = pallas_postprocess(jnp.asarray(hms),
                                                       interpret=True)
        r_coords, r_maxvals = jops.get_max_pred(jnp.asarray(hms))
        r_coords = jops.subpixel_refine(jnp.asarray(hms), r_coords)
        r_gc = jops.localpeak_mean(jnp.asarray(hms))
        for ref_c, ref_m, ref_g in ((p_coords, p_maxvals, p_gc),
                                    (r_coords, r_maxvals, r_gc)):
            np.testing.assert_array_equal(coords.numpy(), np.asarray(ref_c))
            np.testing.assert_array_equal(maxvals.numpy(), np.asarray(ref_m))
            np.testing.assert_allclose(gc.numpy(), np.asarray(ref_g),
                                       rtol=1e-6)
        c = coords.numpy()
        assert (c[1] == 0).all()                       # maxval <= 0
        # the first of two tied maxima wins, then the ±0.25 shift applies
        assert (np.abs(c[2] - [4.0, 3.0]) <= 0.25).all()
        assert (c[6, :, 0] == 0).all() and (c[6, :, 1] == 0).all()

    def test_glue_matches_plain_on_packed_rows(self):
        """The decode the CUDA kernel's epilogue applies to a map's argmax,
        max and clamped neighbours (coords zeroed where max <= 0, the
        strict window test on the rounded coords, the ±0.25 sign shift),
        written out here per joint, reproduces the plain version."""
        hms = torch.from_numpy(planted_heatmaps())
        N, K, H, W = hms.shape
        flat = hms.reshape(N, K, -1)
        maxv = flat.amax(-1)
        idx = torch.where(flat == maxv[..., None], torch.arange(H * W),
                          H * W).amin(-1)
        r_coords, r_maxvals, _ = postprocess_reference(hms)
        torch.testing.assert_close(maxv, r_maxvals, rtol=0, atol=0)
        for n in range(N):
            for k in range(K):
                i = int(idx[n, k])
                py, px = divmod(i, W)
                pxc, pyc = min(max(px, 1), W - 2), min(max(py, 1), H - 2)
                m = hms[n, k]
                pos = bool(maxv[n, k] > 0)
                mx, my = (float(px), float(py)) if pos else (0.0, 0.0)
                ok = 1 < round(mx) < W - 1 and 1 < round(my) < H - 1
                sx = np.sign(float(m[pyc, pxc + 1] - m[pyc, pxc - 1]))
                sy = np.sign(float(m[pyc + 1, pxc] - m[pyc - 1, pxc]))
                want = [mx + 0.25 * sx, my + 0.25 * sy] if ok else [mx, my]
                assert r_coords[n, k].tolist() == want, (n, k)

    @pytest.mark.parametrize("shape", [(8, 5, 16, 12), (8, 3, 13, 9),
                                       (8, 6, 11, 10), (8, 4, 10, 8)])
    def test_plain_matches_pallas_at_ragged_maps(self, shape):
        """Maps whose width is no multiple of 4 (the kernel's 16-byte loads
        start off a map's first float), with the planted ties, all-negative
        sample and border peaks: the plain version, which the wrapper
        takes on the CPU, against the Pallas kernel in interpret mode and
        the JAX ops."""
        hms = planted_heatmaps(*shape)
        coords, maxvals, gc = fused_postprocess(torch.from_numpy(hms))
        p_coords, p_maxvals, p_gc = pallas_postprocess(jnp.asarray(hms),
                                                       interpret=True)
        r_coords, r_maxvals = jops.get_max_pred(jnp.asarray(hms))
        r_coords = jops.subpixel_refine(jnp.asarray(hms), r_coords)
        r_gc = jops.localpeak_mean(jnp.asarray(hms))
        for ref_c, ref_m, ref_g in ((p_coords, p_maxvals, p_gc),
                                    (r_coords, r_maxvals, r_gc)):
            np.testing.assert_array_equal(coords.numpy(), np.asarray(ref_c))
            np.testing.assert_array_equal(maxvals.numpy(), np.asarray(ref_m))
            np.testing.assert_allclose(gc.numpy(), np.asarray(ref_g),
                                       rtol=1e-6)

    @pytest.mark.parametrize("hw", [(16, 12), (64, 48), (47, 63), (5, 3),
                                    (3, 3), (13, 9), (9, 8)])
    def test_kernel_band_walk_counts_the_plain_peaks(self, hw):
        """The CUDA kernel's 3x3 peak test, mirrored step for step in
        Python: the host's choice of bands for units of 4 columns (rows
        16-byte aligned, W a multiple of 4) and of 1 column, then each
        lane's walk down its band and unit with the 3-wide row maxima
        above, at and below (constant-0 border), visits every pixel once
        and keeps the same peaks as localpeak_mean."""
        H, W = hw
        hms = RNG.normal(0.1, 0.4, (3, 2, H, W)).astype(np.float32)
        hms[1] = -np.abs(hms[1]) - 1e-3
        hms[2, 0] = np.round(hms[2, 0] * 2) / 2

        def pick_bands(units):                 # the host's band choice
            best = None
            for r in range(1, min(16, H) + 1):
                cost = -(-units * r // 32) * (-(-H // r) + 2)
                if best is None or cost < best[0]:
                    best = (cost, r)
            return best[1]

        def row_max3(m, y, x):
            return max(m[y, x - 1] if x > 0 else 0.0, m[y, x],
                       m[y, x + 1] if x < W - 1 else 0.0)

        for width in (4, 1) if W % 4 == 0 else (1,):
            units = W // width
            bands = pick_bands(units)
            band_rows = -(-H // bands)
            for n in range(hms.shape[0]):
                s, c = 0.0, 0
                for m in hms[n]:
                    thresh = np.float32(m.max() * np.float32(0.5))
                    visits = np.zeros((H, W), int)
                    for u in range(bands * units):
                        band, unit = divmod(u, units)
                        y0 = band * band_rows
                        for y in range(y0, min(H, y0 + band_rows)):
                            for x in range(width * unit, width * unit + width):
                                visits[y, x] += 1
                                mf = max(
                                    row_max3(m, y - 1, x) if y > 0 else 0.0,
                                    row_max3(m, y, x),
                                    row_max3(m, y + 1, x) if y + 1 < H
                                    else 0.0)
                                if m[y, x] == mf and m[y, x] >= thresh:
                                    s += float(m[y, x])
                                    c += 1
                    assert (visits == 1).all(), (width, n)
                want = localpeak_mean(torch.from_numpy(hms[n])).item()
                assert np.isclose(s / max(c, 1), want, rtol=1e-6, atol=0)
