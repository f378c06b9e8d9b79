"""The JAX package's plain (non-Pallas) kernels against the port's eager
PyTorch versions (vatl4pose_tpu_torch/kernels/deform_conv.py,
roi_align.py, deform_pool.py) on the same numpy inputs, NHWC on the JAX
side and NCHW on the port's.  Offsets of a few pixels on small maps put
taps past every edge.  Values agree within 1e-5 of the reference's max
magnitude (f32 sums in another order), the deformable convolution's
gradients (autograd against jax.grad) within 1e-4."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_models import rel_err
from vatl4pose_tpu.kernels.deform_conv import \
    deform_conv2d as jax_deform_conv2d
from vatl4pose_tpu.kernels.deform_pool import \
    deform_roi_pool as jax_deform_roi_pool
from vatl4pose_tpu.kernels.roi_align import roi_align as jax_roi_align
from vatl4pose_tpu_torch.kernels import (DeformConv2d, deform_conv2d,
                                         deform_roi_pool, roi_align)
from vatl4pose_tpu_torch.kernels.fused_bottleneck import (_k_major,
                                                          k_major_split,
                                                          tf32_split)

torch.set_num_threads(1)
RNG = np.random.default_rng(7213)


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def deform_inputs(N, H, W, cin, cout, K, stride, G, modulated):
    Ho = (H + 2 - K) // stride + 1
    Wo = (W + 2 - K) // stride + 1
    x = RNG.normal(0, 1, (N, H, W, cin)).astype(np.float32)
    off = RNG.uniform(-3.0, 3.0, (N, Ho, Wo, 2 * G * K * K)).astype(np.float32)
    kernel = RNG.normal(0, 0.3, (K, K, cin, cout)).astype(np.float32)
    mask = RNG.uniform(0.05, 0.95, (N, Ho, Wo, G * K * K)).astype(np.float32) \
        if modulated else None
    g = RNG.normal(0, 1, (N, Ho, Wo, cout)).astype(np.float32)
    return x, off, kernel, mask, g


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv2d_and_gradients_match_jax(modulated, groups, stride):
    x, off, kernel, mask, g = deform_inputs(2, 7, 6, 4, 5, 3, stride,
                                            groups, modulated)
    H, W = x.shape[1:3]
    Ho = off.shape[1]
    # the taps' base positions plus the offsets reach past every edge
    ys = (np.arange(Ho) * stride - 1)[None, :, None, None] + off[..., 0::2]
    assert ys.min() < -1 and ys.max() > H and off[..., 1::2].min() < -2

    def jax_loss(x, off, kernel, mask):
        out = jax_deform_conv2d(x, off, kernel, stride, 1, mask, groups)
        return jnp.sum(out * g), out

    args = [jnp.asarray(a) for a in (x, off, kernel)]
    args.append(None if mask is None else jnp.asarray(mask))
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    grads, ref = jax.grad(jax_loss, argnums=argnums, has_aux=True)(*args)

    tx, toff = to_nchw(x).requires_grad_(), to_nchw(off).requires_grad_()
    tk = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    tk.requires_grad_()
    tm = to_nchw(mask).requires_grad_() if modulated else None
    out = deform_conv2d(tx, toff, tk, stride, 1, tm, groups)
    (out * to_nchw(g)).sum().backward()
    assert rel_err(to_nhwc(out), ref) <= 1e-5
    assert rel_err(to_nhwc(tx.grad), grads[0]) <= 1e-4
    assert rel_err(to_nhwc(toff.grad), grads[1]) <= 1e-4
    assert rel_err(tk.grad.permute(2, 3, 1, 0).numpy(), grads[2]) <= 1e-4
    if modulated:
        assert rel_err(to_nhwc(tm.grad), grads[3]) <= 1e-4


def test_deform_conv_module_splits_offsets_and_masks():
    """DeformConv2d(modulated) reads the first 2*G*K*K channels as offsets
    and sigmoids the rest, as the JAX module does; zero offsets give the
    plain convolution."""
    x, off, kernel, mask, _ = deform_inputs(1, 5, 4, 4, 3, 3, 1, 2, True)
    mod = DeformConv2d(4, 3, 3, 1, 1, deform_groups=2, modulated=True)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        logits = np.log(mask / (1 - mask))
        got = mod(to_nchw(x), to_nchw(np.concatenate([off, logits], -1)))
        plain = DeformConv2d(4, 3, 3, 1, 1)
        plain.weight.copy_(mod.weight)
        zero = plain(to_nchw(x), torch.zeros(1, 18, 5, 4))
        conv = torch.nn.functional.conv2d(to_nchw(x), mod.weight, padding=1)
    ref = jax_deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                            jnp.asarray(kernel), 1, 1, jnp.asarray(mask), 2)
    assert rel_err(to_nhwc(got), ref) <= 1e-5
    assert rel_err(zero, conv) <= 1e-6


# (batch index, x1, y1, x2, y2): inside, across every edge, smaller than
# a pixel, wholly outside
ROIS = np.array([[0, 1.2, 0.7, 9.5, 7.3], [1, -3.0, -2.5, 4.0, 3.0],
                 [1, 6.0, 5.0, 14.0, 12.5], [0, 4.2, 3.1, 4.6, 3.3],
                 [1, 20.0, 15.0, 24.0, 19.0]], np.float32)


@pytest.mark.parametrize("scale,sample_num", [(1.0, 2), (0.5, 3)])
def test_roi_align_matches_jax(scale, sample_num):
    feat = RNG.normal(0, 1, (2, 9, 11, 6)).astype(np.float32)
    ref = jax_roi_align(jnp.asarray(feat), jnp.asarray(ROIS), (4, 3),
                        scale, sample_num)
    got = roi_align(to_nchw(feat), torch.from_numpy(ROIS), (4, 3), scale,
                    sample_num)
    assert got.shape == (5, 6, 4, 3)
    assert rel_err(to_nhwc(got), ref) <= 1e-5


@pytest.mark.parametrize("no_trans", [True, False], ids=["plain", "trans"])
@pytest.mark.parametrize("group_size", [1, 2])
def test_deform_roi_pool_matches_jax(no_trans, group_size):
    P, oc = 3, 2
    data = RNG.normal(0, 1, (2, 10, 12, oc * group_size ** 2)) \
        .astype(np.float32)
    offset = RNG.normal(0, 1, (len(ROIS), P, P, 2)).astype(np.float32)
    kw = dict(spatial_scale=0.8, out_size=P, out_channels=oc,
              no_trans=no_trans, group_size=group_size, sample_per_part=2,
              trans_std=0.2)
    ref = jax_deform_roi_pool(jnp.asarray(data), jnp.asarray(ROIS),
                              jnp.asarray(offset), **kw)
    got = deform_roi_pool(to_nchw(data), torch.from_numpy(ROIS),
                          torch.from_numpy(offset.transpose(0, 3, 1, 2)),
                          **kw)
    assert got.shape == (len(ROIS), oc, P, P)
    assert rel_err(to_nhwc(got), ref) <= 1e-5
    if not no_trans:       # the offsets moved the samples
        plain = deform_roi_pool(to_nchw(data), torch.from_numpy(ROIS),
                                **dict(kw, no_trans=True))
        assert rel_err(got, plain) > 1e-2


# K1's f32 weight split (kernels/fused_bottleneck.tf32_split, the plain
# version of the kernel's cvt.rna.tf32.f32 split), against a rounding
# written from the definition in float64: TF32 keeps 10 of f32's 23 stored
# mantissa bits, so its values are spaced 2^(e - 10) in [2^e, 2^(e + 1))
# and 2^-136 among the subnormals; ties round away from zero.

def _bits(values):
    return torch.from_numpy(
        np.array(values, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _tf32_rna(v):
    if not np.isfinite(v) or v == 0:
        return v
    e = max(math.frexp(abs(v))[1] - 1, -126)
    ulp = 2.0 ** (e - 10)
    return math.copysign(math.floor(abs(v) / ulp + 0.5) * ulp, v)


def _split_ref(x):
    with np.errstate(over="ignore"):     # past the largest TF32 value
        hi = np.float32(_tf32_rna(float(x)))
        return hi, np.float32(_tf32_rna(float(np.float32(x - hi))))


def _assert_split(x):
    hi, lo = tf32_split(x)
    for v, h, l in zip(x.numpy(), hi.numpy(), lo.numpy()):
        rh, rl = _split_ref(v)
        assert (h.view(np.int32), l.view(np.int32)) \
            == (rh.view(np.int32), rl.view(np.int32)), (v, h, l, rh, rl)
    return hi, lo


@pytest.mark.parametrize("sign", [1, -1], ids=["positive", "negative"])
def test_tf32_split_rounds_a_tie_away_from_zero(sign):
    # 1 + 2^-11, 3 * 2^-13 * (1 + 2^-11), 2^100 * (1 + 2^-11): halfway
    # between two TF32 values
    x = sign * _bits([0x3F801000, 0x3A401000, 0x71801000])
    hi, lo = _assert_split(x)
    assert (hi.abs() > x.abs()).all()
    assert torch.equal(hi + lo, x)


def test_tf32_split_keeps_a_tf32_value_whole():
    x = _bits([0x3F800000, 0xC0402000, 0x3DCCC000, 0x00800000, 0x7F7FE000,
               0x80002000, 0x00000000])
    hi, lo = _assert_split(x)
    assert torch.equal(hi.view(torch.int32), x.view(torch.int32))
    assert (lo == 0).all()


def test_tf32_split_rounds_subnormals():
    # the smallest subnormal, a subnormal tie, the largest subnormal, and
    # negatives: rounded on the same 13 bits, with no flush to zero
    x = _bits([0x00000001, 0x00001000, 0x00001FFF, 0x007FFFFF, 0x00123456,
               0x80001000, 0x807FFFFF])
    hi, _ = _assert_split(x)
    assert hi[3].item() == 2.0 ** -126     # carried into the exponent
    assert hi[1].item() == 2.0 ** -136 and hi[5].item() == -2.0 ** -136


def test_tf32_split_rounds_the_largest_finite_value_to_infinity():
    x = _bits([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FEFFF])
    hi, lo = _assert_split(x)
    assert hi[0].item() == math.inf and lo[0].item() == -math.inf
    assert hi[1].item() == -math.inf and lo[1].item() == math.inf
    assert math.isfinite(hi[2].item())      # below the tie: stays finite


def test_tf32_split_halves_sum_to_the_input():
    x = torch.from_numpy(
        (RNG.standard_normal(100_000) * 10.0 ** RNG.uniform(-20, 20, 100_000))
        .astype(np.float32))
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22, rel
    _assert_split(x[:200])


def test_k_major_split_lays_out_as_k_major():
    """k_major_split's plain version: _k_major's layouts, split."""
    nb, C, P = 2, 24, 16
    ws = [torch.from_numpy(RNG.normal(0, 1, s).astype(np.float32))
          for s in ((nb, C, P), (nb, 3, 3, P, P), (nb, P, C))]
    halves = k_major_split(*ws)
    for t, (hi, lo) in zip(_k_major(*ws), zip(halves[::2], halves[1::2])):
        assert hi.shape == lo.shape == t.shape and hi.is_contiguous()
        torch.testing.assert_close(hi.double() + lo.double(), t.double(),
                                   rtol=2.0 ** -22, atol=0)
    exact = [tf32_split(w)[0] for w in ws]     # TF32 values: lo is 0
    halves = k_major_split(*exact)
    for t, hi, lo in zip(_k_major(*exact), halves[::2], halves[1::2]):
        assert torch.equal(hi, t) and not lo.any()
