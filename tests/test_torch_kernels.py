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
        """The host glue applied to what the kernel emits (argmax, max,
        clamped neighbours) reproduces the plain version."""
        from vatl4pose_tpu_torch.kernels.postprocess import _glue
        hms = torch.from_numpy(planted_heatmaps())
        N, K, H, W = hms.shape
        flat = hms.reshape(N, K, -1)
        maxv = flat.amax(-1)
        idx = torch.where(flat == maxv[..., None], torch.arange(H * W),
                          H * W).amin(-1)
        px, py = idx % W, idx // W
        pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)

        def at(yy, xx):
            return torch.gather(flat, -1, (yy * W + xx)[..., None])[..., 0]

        joint = torch.stack([px.float(), py.float(), maxv,
                             at(pyc, pxc - 1), at(pyc, pxc + 1),
                             at(pyc - 1, pxc), at(pyc + 1, pxc)], dim=1)
        coords, maxvals = _glue(joint, W, H)
        r_coords, r_maxvals, _ = postprocess_reference(hms)
        torch.testing.assert_close(coords, r_coords, rtol=0, atol=0)
        torch.testing.assert_close(maxvals, r_maxvals, rtol=0, atol=0)
