"""The port's training crop (kernels/rot_warp.py and its plain version,
ops/warp.warp_affine_bilinear_batch) against the JAX package's warps on
the CPU, where the wrapper takes the plain version."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_rot_warp import _case
from vatl4pose_tpu.data.pipeline import np_affine_transform
from vatl4pose_tpu.kernels.rot_warp import warp_rotated_batch
from vatl4pose_tpu.ops.warp import RGB_MEAN as JAX_RGB_MEAN
from vatl4pose_tpu.ops.warp import warp_affine_bilinear as jax_warp
from vatl4pose_tpu_torch.kernels import (reset_launch_counts, rot_warp_crop,
                                         rot_warp_crop_reference)
from vatl4pose_tpu_torch.ops import (warp_affine_bilinear,
                                     warp_affine_bilinear_batch)

torch.set_num_threads(1)
RNG = np.random.default_rng(9090)
OUT = (64, 48)


def smooth_frame():
    """tests/test_rot_warp.py's band-limited frame (the same seed and
    draws), where three shear interpolations stand in for one."""
    rng = np.random.default_rng(7)
    H, W = 240, 320
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.zeros((H, W, 3), np.float32)
    for _ in range(25):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        s, a = rng.uniform(3, 15), rng.uniform(20, 200)
        img[..., rng.integers(0, 3)] += a * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img


def train_cases(W):
    """8 crops of (64, 48) from 3 frames of width W: 6 rotated, 2 flipped,
    one box reaching past the top-left corner."""
    rots = [0.0, 17.0, -33.0, 61.0, 0.0, -78.0, 125.0, -170.0]
    flips = [False, True, False, False, False, True, False, False]
    centers = [(80, 60), (90, 70), (60, 50), (100, 64), (5, 4), (70, 80),
               (85, 55), (75, 65)]
    mats = []
    for rot, flip, c in zip(rots, flips, centers):
        m = np_affine_transform(np.array(c, np.float32),
                                np.array([45.0, 60.0]), rot, OUT[::-1],
                                inv=True)
        if flip:
            m[0, :] = -m[0, 0], -m[0, 1], W - 1 - m[0, 2]
        mats.append(m)
    return np.stack(mats), np.array([0, 1, 2, 0, 1, 2, 0, 1])


@pytest.fixture(scope="module")
def noise_frames():
    """Uint8 frames of noise plus bright squares: sharp edges, where a
    coordinate rounded another way would show."""
    frames = RNG.integers(0, 60, (3, 120, 160, 3)).astype(np.uint8)
    frames[:, 40:70, 50:90] = 250
    return frames


def test_plain_warp_matches_jax_gather(noise_frames):
    """Against jax.vmap(warp_affine_bilinear), run op by op (under jit XLA
    contracts the coordinate arithmetic into FMAs): max |err| <= 1e-3 on
    [0, 255].  The wrapper on the CPU returns the same, normalized."""
    mats, fi = train_cases(noise_frames.shape[2])
    got = warp_affine_bilinear_batch(torch.from_numpy(noise_frames),
                                     torch.from_numpy(fi),
                                     torch.from_numpy(mats), OUT)
    frames_f = jnp.asarray(noise_frames.astype(np.float32))
    ref = np.asarray(jax.vmap(functools.partial(jax_warp, out_size=OUT))(
        frames_f[fi], jnp.asarray(mats)))
    assert got.shape == ref.shape == (8,) + OUT + (3,)
    assert np.abs(got.numpy() - ref).max() <= 1e-3
    assert (ref[4] == 0).any() and (ref[4] > 0).any()   # partly outside
    reset_launch_counts()
    crops = rot_warp_crop(torch.from_numpy(noise_frames),
                          torch.from_numpy(fi), torch.from_numpy(mats), OUT)
    assert rot_warp_crop.launches == 0                  # the plain version
    np.testing.assert_allclose(crops.numpy(), ref / 255.0 - JAX_RGB_MEAN,
                               rtol=0, atol=1e-3 / 255)


def test_plain_warp_matches_pallas_shear_path():
    """Against the JAX package's shear-kernel path (Pallas interpret mode)
    on tests/test_rot_warp.py's smooth frame and cases, with that test's
    bounds: rot 0 within 1e-3; rotated max < 4.0 and mean < 0.05 (three
    interpolations against one)."""
    frame = smooth_frame()
    cases = [(0.0, False), (0.0, True), (-25.0, False), (70.0, True)]
    mats = np.stack([_case(r, f) for r, f in cases])
    fi = np.zeros(len(cases), np.int64)
    got = warp_affine_bilinear_batch(torch.from_numpy(frame[None]),
                                     torch.from_numpy(fi),
                                     torch.from_numpy(mats),
                                     (256, 192)).numpy()
    ref = np.asarray(warp_rotated_batch(jnp.asarray(frame[None]), fi, mats,
                                        (256, 192), interpret=True))
    for i, (rot, flip) in enumerate(cases):
        d = np.abs(got[i] - ref[i])
        if rot == 0.0:
            assert d.max() < 1e-3, (rot, flip, d.max())
        else:
            assert d.max() < 4.0, (rot, flip, d.max())
            assert d.mean() < 0.05, (rot, flip, d.mean())


def test_single_image_warp_is_the_batch_row(noise_frames):
    mats, fi = train_cases(noise_frames.shape[2])
    batch = warp_affine_bilinear_batch(torch.from_numpy(noise_frames),
                                       torch.from_numpy(fi),
                                       torch.from_numpy(mats), OUT)
    one = warp_affine_bilinear(torch.from_numpy(noise_frames[fi[3]]),
                               torch.from_numpy(mats[3]), OUT)
    assert torch.equal(one, batch[3])


def test_reference_normalizes_the_plain_warp(noise_frames):
    mats, fi = train_cases(noise_frames.shape[2])
    args = (torch.from_numpy(noise_frames), torch.from_numpy(fi),
            torch.from_numpy(mats), OUT)
    want = warp_affine_bilinear_batch(*args) / 255.0 \
        - torch.from_numpy(JAX_RGB_MEAN)
    assert torch.equal(rot_warp_crop_reference(*args), want)


def test_wrapper_raises_on_other_devices(noise_frames):
    mats, fi = train_cases(noise_frames.shape[2])
    with pytest.raises(ValueError, match="no kernel"):
        rot_warp_crop(torch.empty((3, 120, 160, 3), dtype=torch.uint8,
                                  device="meta"),
                      torch.from_numpy(fi), torch.from_numpy(mats), OUT)


def test_bf16_reference_is_the_f32_crop_rounded_once(noise_frames):
    """The plain version in bf16, which the kernel's bf16 instances match
    bit for bit on the card, is its f32 crop rounded once; the wrapper on
    the CPU returns it."""
    mats, fi = train_cases(noise_frames.shape[2])
    args = (torch.from_numpy(noise_frames), torch.from_numpy(fi),
            torch.from_numpy(mats), OUT)
    f32 = rot_warp_crop_reference(*args)
    bf16 = rot_warp_crop_reference(*args, dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert torch.equal(rot_warp_crop(*args, dtype=torch.bfloat16), bf16)


@pytest.mark.parametrize("values", ["integers", "fractions"])
def test_plain_warp_of_float_frames_matches_jax_gather(noise_frames, values):
    """float32 frames (the scoring engine's "uint8 or float" contract),
    holding the uint8 frames' values or fractional ones, against the JAX
    gather: max |err| <= 1e-3 on [0, 255]; with integer values the plain
    version equals its result from the uint8 frames."""
    mats, fi = train_cases(noise_frames.shape[2])
    frames = noise_frames.astype(np.float32)
    if values == "fractions":
        frames += RNG.uniform(0, 1, frames.shape).astype(np.float32)
    args = (torch.from_numpy(fi), torch.from_numpy(mats), OUT)
    got = warp_affine_bilinear_batch(torch.from_numpy(frames), *args)
    ref = np.asarray(jax.vmap(functools.partial(jax_warp, out_size=OUT))(
        jnp.asarray(frames)[fi], jnp.asarray(mats)))
    assert np.abs(got.numpy() - ref).max() <= 1e-3
    crops = rot_warp_crop(torch.from_numpy(frames), *args)
    np.testing.assert_allclose(crops.numpy(), ref / 255.0 - JAX_RGB_MEAN,
                               rtol=0, atol=1e-3 / 255)
    if values == "integers":
        assert torch.equal(crops, rot_warp_crop(
            torch.from_numpy(noise_frames), *args))
