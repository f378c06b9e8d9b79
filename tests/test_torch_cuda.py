"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from vatl4pose_tpu_torch.kernels import (bottleneck_chain_reference,
                                         fused_bottleneck_chain,
                                         fused_postprocess,
                                         k_major_split,
                                         postprocess_reference,
                                         reset_launch_counts, rot_warp_crop,
                                         rot_warp_crop_reference)
from vatl4pose_tpu_torch.ops import RGB_MEAN

RNG = np.random.default_rng(8111)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # parity mode: the plain versions' cuDNN convolutions in full f32
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def chain_operands(nb, C, P, dtype, device):
    """Folded chain weights: w1, s1, b1, w2, s2, b2, w3, s3, b3."""
    ws = [RNG.normal(0, 0.1, (nb, C, P)), RNG.uniform(0.5, 1.5, (nb, P)),
          RNG.normal(0, 0.2, (nb, P)), RNG.normal(0, 0.1, (nb, 3, 3, P, P)),
          RNG.uniform(0.5, 1.5, (nb, P)), RNG.normal(0, 0.2, (nb, P)),
          RNG.normal(0, 0.1, (nb, P, C)), RNG.uniform(0.5, 1.5, (nb, C)),
          RNG.normal(0, 0.2, (nb, C))]
    return [torch.tensor(w, dtype=dtype if i in (0, 3, 6) else torch.float32,
                         device=device) for i, w in enumerate(ws)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_matches_plain_on_card(cuda, dtype):
    # ragged sizes: pixel rows and channels that fill no whole tile
    x = torch.tensor(RNG.normal(0, 1, (3, 13, 11, 96)), dtype=dtype,
                     device=cuda).relu()
    ws = chain_operands(3, 96, 24, dtype, cuda)
    reset_launch_counts()
    got = fused_bottleneck_chain(x, *ws)
    assert fused_bottleneck_chain.launches == 1
    ref = bottleneck_chain_reference(x, *ws)
    # f32: summation order only; bf16: a one-ulp flip of an epilogue's
    # rounding propagates down the chain
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def he_chain_operands(nb, C, P, dtype, device):
    """He-scaled folded chain weights, which keep the stream O(1) over the
    blocks, with small bn3 gains as in a trained ResNet."""
    ws = [RNG.normal(0, (2 / C) ** 0.5, (nb, C, P)),
          RNG.uniform(0.5, 1.5, (nb, P)), RNG.normal(0, 0.1, (nb, P)),
          RNG.normal(0, (2 / (9 * P)) ** 0.5, (nb, 3, 3, P, P)),
          RNG.uniform(0.5, 1.5, (nb, P)), RNG.normal(0, 0.1, (nb, P)),
          RNG.normal(0, (2 / P) ** 0.5, (nb, P, C)),
          RNG.uniform(0.1, 0.3, (nb, C)), RNG.normal(0, 0.1, (nb, C))]
    return [torch.tensor(w, dtype=dtype if i in (0, 3, 6) else torch.float32,
                         device=device) for i, w in enumerate(ws)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    # (N, H, W, C, P, nb): the four SimplePose-R50 stage shapes at N = 2
    # (stage 4: P = 512, the 3x3's K = 4608)
    (2, 64, 48, 256, 64, 2), (2, 32, 24, 512, 128, 3),
    (2, 16, 12, 1024, 256, 5), (2, 8, 6, 2048, 512, 2),
    # H = 1 and W = 1: every 3x3 neighbour but the centre is padding
    (3, 1, 37, 64, 16, 2), (3, 29, 1, 64, 16, 2),
    # M = 30 rows, below one 128-row tile
    (1, 5, 6, 32, 8, 2)])
def test_chain_kernel_at_stage_and_edge_shapes(cuda, dtype, shape):
    N, H, W, C, P, nb = shape
    x = torch.tensor(RNG.normal(0, 1, (N, H, W, C)), dtype=dtype,
                     device=cuda).relu()
    ws = he_chain_operands(nb, C, P, dtype, cuda)
    reset_launch_counts()
    got = fused_bottleneck_chain(x, *ws)
    assert fused_bottleneck_chain.launches == 1
    ref = bottleneck_chain_reference(x, *ws)
    err = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    # f32 (3xTF32 against cuDNN in full f32): of the order of f32 rounding;
    # bf16: one-ulp flips of the epilogues' rounding propagate
    if dtype == torch.float32:
        assert err.max().item() <= 1e-4 * scale
    else:
        assert err.max().item() <= 5e-2 * scale
        assert err.mean().item() <= 5e-3 * scale


@pytest.mark.cuda
def test_k_major_split_kernel_equals_tf32_split(cuda):
    """k_major_split_kernel against its plain version bit for bit: ragged
    tiles (C = 48, P = 40) and R50's last stage, with ties, TF32 values,
    subnormals and the largest finite values planted among the weights."""
    special = np.array([0x3F801000, 0xBF801000, 0x3F800000, 0x00000001,
                        0x00001000, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF],
                       dtype=np.uint32).view(np.float32)
    for nb, C, P in ((2, 48, 40), (2, 2048, 512)):
        ws = [RNG.normal(0, 0.1, s).astype(np.float32)
              for s in ((nb, C, P), (nb, 3, 3, P, P), (nb, P, C))]
        for w in ws:
            w.reshape(-1)[RNG.choice(w.size, 64)] = np.resize(special, 64)
        cpu = [torch.from_numpy(w) for w in ws]
        reset_launch_counts()
        got = k_major_split(*(w.to(cuda) for w in cpu))
        assert fused_bottleneck_chain.split_launches == 1
        for g, r in zip(got, k_major_split(*cpu)):
            assert torch.equal(g.cpu().view(torch.int32),
                               r.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_splits_weights_once_an_f32_call(cuda, dtype):
    x = torch.tensor(RNG.normal(0, 1, (2, 9, 7, 64)), dtype=dtype,
                     device=cuda).relu()
    ws = he_chain_operands(2, 64, 16, dtype, cuda)
    reset_launch_counts()
    for calls in (1, 2):
        fused_bottleneck_chain(x, *ws)
        assert fused_bottleneck_chain.launches == calls
        assert fused_bottleneck_chain.split_launches == \
            (calls if dtype == torch.float32 else 0)


@pytest.mark.cuda
def test_chain_kernel_f32_repeats_bit_for_bit(cuda):
    """Two f32 runs on the same operands give the same bits: R50's third
    stage (the 3x3's K = 2304: 288 k-steps a tile) and a ragged edge."""
    for N, H, W, C, P, nb in ((8, 16, 12, 1024, 256, 3), (3, 5, 7, 48, 24,
                                                          2)):
        x = torch.tensor(RNG.normal(0, 1, (N, H, W, C)),
                         dtype=torch.float32, device=cuda).relu()
        ws = he_chain_operands(nb, C, P, torch.float32, cuda)
        first = fused_bottleneck_chain(x, *ws)
        second = fused_bottleneck_chain(x, *ws)
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_chain_wrapper_refuses_channels_the_kernel_cannot_take(cuda):
    # P = 12: the kernel's TMA rows need multiples of 8 channels
    ws = chain_operands(2, 48, 12, torch.float32, cuda)
    x = torch.tensor(RNG.normal(0, 1, (1, 3, 4, 48)), dtype=torch.float32,
                     device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_bottleneck_chain(x, *ws)
    assert fused_bottleneck_chain.launches == 0
    cpu = [w.cpu() for w in ws]
    torch.testing.assert_close(fused_bottleneck_chain(x.cpu(), *cpu),
                               bottleneck_chain_reference(x.cpu(), *cpu))


def planted_heatmaps(n, k, h, w):
    """Noise plus an all-negative sample, tied maxima, maxima on the
    border and in corners, a quantized sample full of ties and an all-zero
    map."""
    hms = RNG.normal(0.1, 0.4, (n, k, h, w)).astype(np.float32)
    hms[1] = -np.abs(hms[1]) - 1e-3
    hms[2, :, 3, 4] = hms[2, :, 9, 7] = 5.0
    hms[3, :, 0, 5] = 6.0
    hms[3, 1, h - 1, w - 1] = 7.0
    hms[4] = np.round(hms[4] * 3) / 3
    hms[5, 0] = 0.0
    hms[6, :, 0, 0] = hms[6, :, h - 1, 0] = 9.0
    hms[7, :, 1, 1] = 8.0
    return hms


@pytest.mark.cuda
def test_postprocess_kernel_matches_plain_on_card(cuda):
    hms = torch.from_numpy(planted_heatmaps(16, 17, 64, 48)).to(cuda)
    reset_launch_counts()
    coords, maxvals, gc = fused_postprocess(hms)
    assert fused_postprocess.launches == 1
    r_coords, r_maxvals, r_gc = postprocess_reference(hms)
    assert torch.equal(coords, r_coords) and torch.equal(maxvals, r_maxvals)
    # gc: the same float sums in another order
    torch.testing.assert_close(gc, r_gc, rtol=1e-5, atol=0)


def planted_crop_mats(W, H):
    """dst->src affines: integer source positions (every weight 0 or 1),
    taps on the last row and column, a crop wholly outside the frame, a
    flip, a flipped rotation and two rotations with scale."""
    mats = [[[1, 0, 5], [0, 1, 3]],
            [[1, 0, W - 12.5], [0, 1, H - 10.5]],
            [[1, 0, -200], [0, 1, H + 50]],
            [[-1, 0, W - 1], [0, 1, 0]]]
    for rot, s, flip in ((0.7, 1.3, True), (-1.2, 0.6, False),
                         (2.9, 2.1, False)):
        c, n = s * np.cos(rot), s * np.sin(rot)
        m = [[c, -n, W / 2], [n, c, H / 2]]
        if flip:
            m[0] = [-m[0][0], -m[0][1], W - 1 - m[0][2]]
        mats.append(m)
    return np.asarray(mats, np.float32)


@pytest.mark.cuda
def test_rot_warp_kernel_matches_plain_on_card(cuda):
    # ragged sizes: a crop that fills no whole block of threads
    H, W, out = 37, 53, (19, 23)
    frames = torch.from_numpy(RNG.integers(0, 256, (3, H, W, 3),
                                           dtype=np.uint8)).to(cuda)
    mats = torch.from_numpy(planted_crop_mats(W, H)).to(cuda)
    fi = torch.tensor([0, 1, 2, 0, 1, 2, 0], dtype=torch.int64, device=cuda)
    reset_launch_counts()
    got = rot_warp_crop(frames, fi, mats, out)
    assert rot_warp_crop.launches == 1
    ref = rot_warp_crop_reference(frames, fi, mats, out)
    # the coordinates, taps and weights round as in the plain version; its
    # /255 is a multiply by the reciprocal
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 / 255)
    mean = torch.as_tensor(RGB_MEAN, device=cuda)
    want = frames[0, 3:3 + out[0], 5:5 + out[1]].float() / 255 - mean
    torch.testing.assert_close(got[0], want, rtol=0, atol=1e-3 / 255)
    assert torch.equal(got[2], (-mean).expand_as(got[2]))
    # taps past the last row and column read 0: the crop's pixel (10, 12)
    # reads the frame at (H - 0.5, W - 0.5), whose one tap inside is the
    # last pixel, at weight 1/4; from (11, 13) on every tap is outside
    corner = frames[1, H - 1, W - 1].float() * 0.25 / 255 - mean
    torch.testing.assert_close(got[1, 10, 12], corner, rtol=0,
                               atol=1e-3 / 255)
    assert (got[1, 11:, 13:] == -mean).all()


@pytest.mark.cuda
def test_rot_warp_wrapper_refuses_bad_operands(cuda):
    frames = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=cuda)
    fi = torch.zeros(1, dtype=torch.int64, device=cuda)
    mats = torch.zeros((1, 2, 3), dtype=torch.float32, device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="uint8 or float32"):
        rot_warp_crop(frames.double(), fi, mats, (4, 4))
    with pytest.raises(ValueError, match="uint8 or float32"):
        rot_warp_crop(frames.permute(0, 2, 1, 3), fi, mats, (4, 4))
    with pytest.raises(ValueError, match="int64"):
        rot_warp_crop(frames, fi.int(), mats, (4, 4))
    with pytest.raises(ValueError, match="bfloat16"):
        rot_warp_crop(frames, fi, mats, (4, 4), dtype=torch.float16)
    assert rot_warp_crop.launches == 0


def scoring_like_mats(n, W, H, oh, ow):
    """rot=0 dst->src affines of person boxes scaled up and down, every
    third one flipped, some past a frame edge, one wholly outside."""
    s = RNG.uniform(0.3, 2.5, n)
    cx = RNG.uniform(-0.2 * W, 1.2 * W, n)
    cy = RNG.uniform(-0.2 * H, 1.2 * H, n)
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = s
    mats[:, 1, 1] = s
    mats[:, 0, 2] = cx - s * ow / 2
    mats[:, 1, 2] = cy - s * oh / 2
    mats[::3, 0, 0] *= -1
    mats[::3, 0, 2] = cx[::3] + s[::3] * ow / 2
    mats[1] = [[1, 0, -10 * W], [0, 1, 3 * H]]
    return mats


@pytest.mark.cuda
@pytest.mark.parametrize("src", [torch.uint8, torch.float32])
@pytest.mark.parametrize("out", [(64, 192), (37, 190), (5, 7)])
def test_rot_warp_kernel_dtypes_and_ragged_widths(cuda, src, out):
    """Every instance: uint8 or float32 frames to f32 or bf16 crops, at
    widths 192, 190 and 7 (the span of one warp ends mid-row, and the
    output's end mid-span), rotated and flipped crops and rot=0 ones, one
    wholly outside the frame.  f32 within 1e-3/255 of the plain version
    (the same operations, rounded alike: in practice equal); bf16 equal
    bit for bit to the plain version's f32 crop rounded to bf16."""
    H, W = 45, 71
    frames = RNG.uniform(0, 255, (3, H, W, 3))
    frames = torch.tensor(frames.round() if src == torch.uint8 else frames,
                          dtype=src, device=cuda)
    mats = np.concatenate([planted_crop_mats(W, H),
                           scoring_like_mats(10, W, H, *out)])
    mats = torch.from_numpy(mats).to(cuda)
    fi = torch.tensor(RNG.integers(0, 3, len(mats)), dtype=torch.int64,
                      device=cuda)
    ref = rot_warp_crop_reference(frames, fi, mats, out)
    reset_launch_counts()
    got = rot_warp_crop(frames, fi, mats, out)
    got_bf16 = rot_warp_crop(frames, fi, mats, out, dtype=torch.bfloat16)
    assert rot_warp_crop.launches == 2
    assert got.dtype == torch.float32 and got_bf16.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 / 255)
    assert torch.equal(got_bf16, rot_warp_crop_reference(
        frames, fi, mats, out, dtype=torch.bfloat16))
    mean = torch.as_tensor(RGB_MEAN, device=cuda)
    for i in (2, 8):                                     # wholly outside
        assert torch.equal(got[i], (-mean).expand_as(got[i]))


@pytest.mark.cuda
def test_rot_warp_kernel_takes_more_than_65535_samples(cuda):
    """70,000 crops of 2x3 pixels: past the simple form's grid.y limit,
    with the output's end mid-span."""
    frames = torch.from_numpy(RNG.integers(0, 256, (5, 9, 11, 3),
                                           dtype=np.uint8)).to(cuda)
    n = 70000
    mats = np.zeros((n, 2, 3), np.float32)
    mats[:, 0, 0] = mats[:, 1, 1] = RNG.uniform(0.5, 2.0, n)
    mats[:, 0, 2] = RNG.uniform(-3, 10, n)
    mats[:, 1, 2] = RNG.uniform(-3, 8, n)
    mats = torch.from_numpy(mats).to(cuda)
    fi = torch.tensor(RNG.integers(0, 5, n), dtype=torch.int64, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = rot_warp_crop(frames, fi, mats, (2, 3), dtype=dtype)
        ref = rot_warp_crop_reference(frames, fi, mats, (2, 3), dtype=dtype)
        assert got.shape == (n, 2, 3, 3)
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=1e-3 / 255)
        if dtype == torch.bfloat16:
            assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 17, 64, 48), (9, 5, 47, 63),
                                   (8, 19, 13, 9), (6, 3, 3, 3)])
def test_postprocess_kernel_at_scoring_and_ragged_shapes(cuda, shape):
    """The scoring pass's (512, 17, 64, 48), maps of 47x63 and 13x9 (whose
    16-byte loads start off a map's first float) and the smallest maps,
    with planted ties,
    all-negative samples and border peaks: coords and maxvals bit-exact,
    gc within rtol 1e-5 (the same sums in another order)."""
    N, K, H, W = shape
    if H >= 10 and W >= 8:
        hms = planted_heatmaps(N, K, H, W)
    else:      # noise, an all-negative sample, ties, an all-zero sample
        hms = RNG.normal(0.1, 0.4, shape).astype(np.float32)
        hms[1] = -np.abs(hms[1]) - 1e-3
        hms[2] = np.round(hms[2] * 2) / 2
        hms[3] = 0.0
    hms = torch.from_numpy(hms).to(cuda)
    reset_launch_counts()
    coords, maxvals, gc = fused_postprocess(hms)
    assert fused_postprocess.launches == 1
    r_coords, r_maxvals, r_gc = postprocess_reference(hms)
    assert torch.equal(coords, r_coords) and torch.equal(maxvals, r_maxvals)
    torch.testing.assert_close(gc, r_gc, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("src", [torch.uint8, torch.float32])
def test_rot_warp_kernel_on_frames_that_start_off_alignment(cuda, src):
    """Frames that begin 1 element into their allocation (a contiguous
    view), with taps on the first and the last pixels of the buffer: the
    kernel's 8-byte tap loads and the loads it masks stay readable and the
    crops equal the plain version's (f32 within 1e-3/255, bf16 bit for
    bit)."""
    F, H, W = 2, 9, 13
    flat = RNG.uniform(0, 255, F * H * W * 3 + 1)
    flat = torch.tensor(flat.round() if src == torch.uint8 else flat,
                        dtype=src, device=cuda)
    frames = flat[1:].view(F, H, W, 3)
    mats = np.concatenate([planted_crop_mats(W, H), np.asarray(
        [[[1, 0, -0.5], [0, 1, -0.5]],                  # the first pixel
         [[1, 0, W - 2.5], [0, 1, H - 2.5]]],            # the last pixel
        np.float32)])
    mats = torch.from_numpy(mats).to(cuda)
    fi = torch.tensor(RNG.integers(0, F, len(mats)), dtype=torch.int64,
                      device=cuda)
    fi[-2], fi[-1] = 0, F - 1
    for dtype in (torch.float32, torch.bfloat16):
        got = rot_warp_crop(frames, fi, mats, (5, 7), dtype=dtype)
        ref = rot_warp_crop_reference(frames, fi, mats, (5, 7), dtype=dtype)
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=1e-3 / 255)
        if dtype == torch.bfloat16:
            assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 48), (16, 12)])
def test_postprocess_kernel_on_maps_that_start_off_alignment(cuda, hw):
    """Maps whose width is a multiple of 4 but whose rows start off a
    16-byte boundary (a contiguous view 1 float into its allocation): the
    kernel walks them by single columns; coords and maxvals bit-exact, gc
    within rtol 1e-5."""
    hms = planted_heatmaps(8, 5, *hw)
    flat = torch.zeros(hms.size + 1, dtype=torch.float32, device=cuda)
    flat[1:] = torch.from_numpy(hms.ravel()).to(cuda)
    maps = flat[1:].view(hms.shape)
    coords, maxvals, gc = fused_postprocess(maps)
    r_coords, r_maxvals, r_gc = postprocess_reference(maps)
    assert torch.equal(coords, r_coords) and torch.equal(maxvals, r_maxvals)
    torch.testing.assert_close(gc, r_gc, rtol=1e-5, atol=0)


def _chain_f64(x, ws):
    """The folded chain in float64 (F.conv2d on the card), NHWC."""
    import torch.nn.functional as F
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = (w.double() for w in ws)
    cur = x.double().permute(0, 3, 1, 2)
    for i in range(w1.shape[0]):
        h = torch.relu(F.conv2d(cur, w1[i].t()[:, :, None, None])
                       * s1[i][:, None, None] + b1[i][:, None, None])
        h = torch.relu(F.conv2d(h, w2[i].permute(3, 2, 0, 1), padding=1)
                       * s2[i][:, None, None] + b2[i][:, None, None])
        cur = torch.relu(F.conv2d(h, w3[i].t()[:, :, None, None])
                         * s3[i][:, None, None] + b3[i][:, None, None] + cur)
    return cur.permute(0, 2, 3, 1)


def cancelling_chain_operands(device, rng):
    """R50's last stage (N=4, 8x6, C=2048, P=512, nb=2: the 3x3 sums
    K = 9 * 512 = 4608 products) on operands whose sums cancel as a
    trained ResNet's do: positive activations of mean 1, weights of mean
    0.02, so every running sum grows with K, and BN biases that subtract
    each channel's mean pre-activation (from an f64 pass), so an output
    is a few percent of its sum.  Returns (x, ws) in f32."""
    import torch.nn.functional as F
    N, H, W, C, P, nb = 4, 8, 6, 2048, 512, 2
    x = torch.tensor(rng.uniform(0.5, 1.5, (N, H, W, C)), dtype=torch.float32,
                     device=device)
    ws = [0.02 + rng.normal(0, 0.02, (nb, C, P)), np.ones((nb, P)), None,
          0.02 + rng.normal(0, 0.02, (nb, 3, 3, P, P)), np.ones((nb, P)),
          None, 0.02 + rng.normal(0, 0.02, (nb, P, C)), np.full((nb, C), 0.2),
          None]
    ws = [None if w is None else torch.tensor(w, dtype=torch.float32,
                                              device=device) for w in ws]
    cur = x.double().permute(0, 3, 1, 2)
    b1, b2, b3 = (torch.zeros((nb, n), dtype=torch.float64, device=device)
                  for n in (P, P, C))
    for i in range(nb):
        h = F.conv2d(cur, ws[0][i].double().t()[:, :, None, None])
        b1[i] = -h.mean(dim=(0, 2, 3))
        h = torch.relu(h + b1[i][:, None, None])
        h = F.conv2d(h, ws[3][i].double().permute(3, 2, 0, 1), padding=1)
        b2[i] = -h.mean(dim=(0, 2, 3))
        h = torch.relu(h + b2[i][:, None, None])
        h = F.conv2d(h, ws[6][i].double().t()[:, :, None, None]) * 0.2
        b3[i] = -h.mean(dim=(0, 2, 3))
        cur = torch.relu(h + b3[i][:, None, None] + cur)
    ws[2], ws[5], ws[8] = (b.float() for b in (b1, b2, b3))
    return x, ws


@pytest.mark.cuda
def test_chain_kernel_f32_precision_on_cancelling_operands(cuda):
    """K1's f32 path against the chain in f64 on cancelling_chain_operands.
    3xTF32 summed into one accumulator over all of K lost the correction
    terms' low bits to the tensor core's truncating adds (fault C1); K1's
    max|err| / max from f64 must be at most twice that of cuDNN's f32
    chain (K1's plain version, TF32 off)."""
    x, ws = cancelling_chain_operands(cuda, RNG)
    exact = _chain_f64(x, ws)
    scale = exact.abs().max().item()
    got = fused_bottleneck_chain(x, *ws)
    plain = bottleneck_chain_reference(x, *ws)
    e_k1 = (got.double() - exact).abs().max().item() / scale
    e_plain = (plain.double() - exact).abs().max().item() / scale
    print(f"max|err|/max from f64: K1 {e_k1:.3e}, cuDNN f32 {e_plain:.3e}")
    assert e_k1 <= 2 * e_plain, (e_k1, e_plain)


def he_scaled_(model, gen):
    """Seeded He-scaled conv weights, small gains on each residual
    branch's last BN and random BN statistics, so that a random R50's
    activations stay O(1) through its 50 layers (with torch's default init
    and eval-mode BN they fade, and every heatmap is a near tie).  In
    place."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                if isinstance(m, torch.nn.ConvTranspose2d):
                    fan_in = m.weight.shape[0] * 4
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                lo, hi = (0.1, 0.3) if name.endswith(("bn3", "downsample.1")) \
                    else (0.5, 1.0)
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model


@pytest.mark.cuda
def test_streamed_scoring_matches_resident_on_card(cuda, tmp_path):
    """ScoringEngine.score_streaming on the card (host-warp crops, K1 and
    K2 a chunk, K3 never) against `score` with the frames on the card (K3's
    crops), on a SimplePose-R50 at 64x48 with seeded He-scaled weights
    (he_scaled_), random ones as in the JAX package's test: the streamed
    path at chunk 3 and 10 equal within 1e-5 (the halo hides the chunk
    edges).  Against the resident path (the host crop is the device crop
    rounded to uint8), the JAX package's bounds (tests/test_stream.py):
    OKS, THC, det_score and gc within rtol = atol = 2e-2, more than 99% of
    kpts within (2e-2, 1.0)."""
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.data import build_dataset, make_synthetic_video
    from vatl4pose_tpu_torch.models import SimplePose
    root, ann = make_synthetic_video(str(tmp_path), num_frames=5,
                                     num_persons=2, width=160, height=128)
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
    d = ds.data
    args = (d.frame_idx, d.bboxes, d.gt_keypoints,
            np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                      d.bboxes[:, 2] - d.bboxes[:, 0],
                      d.bboxes[:, 3] - d.bboxes[:, 1]], 1),
            d.is_prev, d.is_next)
    model = he_scaled_(SimplePose(
        num_joints=17, num_layers=50, deconv_dim=(32, 32, 32),
        fused_eval=True, device="cpu"), torch.Generator().manual_seed(5))
    model = model.to(cuda)
    cfg = ScoringConfig(uncertainty="THC_L1", input_size=(64, 48))
    outs = []
    for chunk in (3, 10):
        reset_launch_counts()
        outs.append(ScoringEngine(model, cfg, chunk=chunk).score_streaming(
            ds.frame_store(), *args))
        n_chunks = -(-len(d) // chunk)
        assert fused_bottleneck_chain.launches == 4 * n_chunks
        assert fused_postprocess.launches == n_chunks
        assert rot_warp_crop.launches == 0
    for k in ("oks", "unc", "det_score", "gc", "kpts", "embeddings"):
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    res = ScoringEngine(model, cfg, chunk=4).score(
        torch.from_numpy(ds.load_frames()).to(cuda), *args)
    for k in ("oks", "unc", "det_score", "gc"):
        np.testing.assert_allclose(outs[0][k], res[k], rtol=2e-2, atol=2e-2,
                                   err_msg=k)
    close = np.isclose(outs[0]["kpts"], res["kpts"], rtol=2e-2, atol=1.0)
    assert close.mean() > 0.99, close.mean()


def strategy_maps(gen, n, device):
    """(n, 17, 64, 48) f32 maps: noise with three blobs a map, every 4th
    sample all negative, every 4th + 1 constant, every 4th + 2 with its
    blobs pushed into the 5-pixel border."""
    yy = torch.arange(64, dtype=torch.float32)[:, None]
    xx = torch.arange(48, dtype=torch.float32)[None, :]
    hms = torch.randn(n, 17, 64, 48, generator=gen) * 0.02
    for _ in range(3):
        cy = torch.rand(n, 17, 1, 1, generator=gen) * 64
        cx = torch.rand(n, 17, 1, 1, generator=gen) * 48
        amp = torch.rand(n, 17, 1, 1, generator=gen) * 0.8 + 0.2
        hms += amp * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
    hms[0::4] = -hms[0::4].abs() - 0.5
    hms[1::4] = 0.25
    hms[2::4, :, 5:-5, 5:-5] = 0.0
    return hms.to(device)


@pytest.mark.cuda
def test_peak_scan_and_criteria_on_card_match_cpu(cuda):
    """The batched peak scan and MPE, Margin and Entropy on the card
    against the same functions on the CPU, at the scoring shape (64 of
    512 samples x 17 joints of 64x48 maps): the scan's values, validity
    and places exactly (a max, compares and a first-index argmax, no
    sums), the criteria within 1e-5 (rtol; softmax and log on the card's
    math library), -inf entropies where the CPU has them, and finite
    entropies of positive maps within 1e-5 too."""
    from vatl4pose_tpu_torch.ops import (compute_entropy, compute_margin,
                                         compute_mpe, peak_local_max_topk)
    hms = strategy_maps(torch.Generator().manual_seed(41), 64, cuda)
    got = peak_local_max_topk(hms)
    want = peak_local_max_topk(hms.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want[1][3::4].sum(-1).ge(2).float().mean() > 0.5
    assert not want[1][0::4].any() and not want[1][1::4].any()
    for fn in (compute_mpe, compute_margin, compute_entropy):
        g, w = fn(hms).cpu().numpy(), fn(hms.cpu()).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=fn.__name__)
    # every map above holds a negative or a constant value, so its entropy
    # is -inf or log(3072)·17; positive maps with blobs give real values
    pos = hms[3::4].abs() + 1e-3
    g = compute_entropy(pos).cpu().numpy()
    w = compute_entropy(pos.cpu()).numpy()
    assert np.isfinite(w).all() and len(np.unique(w)) == len(w)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_vl4pose_pass_runs_one_backbone_through_k1(cuda, tmp_path):
    """A VL4Pose scoring pass on the card: the split pass (backbone once,
    then the head, the AuxNet and the embedding) launches K1 four times a
    chunk, K2 once a chunk and K3 once a chunk, and its heatmaps and
    embeddings are those of an unsplit pass, within 1e-5 of their scale
    (cuDNN's convolutions are not bit-reproducible from run to run
    unless held to deterministic algorithms: 1-ulp differences)."""
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.data import build_dataset, make_synthetic_video
    from vatl4pose_tpu_torch.models import AuxNet, SimplePose
    root, ann = make_synthetic_video(str(tmp_path), num_frames=5,
                                     num_persons=2, width=160, height=128)
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
    d = ds.data
    args = (d.frame_idx, d.bboxes, d.gt_keypoints,
            np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                      d.bboxes[:, 2] - d.bboxes[:, 0],
                      d.bboxes[:, 3] - d.bboxes[:, 1]], 1),
            d.is_prev, d.is_next)
    model = he_scaled_(SimplePose(
        num_joints=17, num_layers=50, deconv_dim=(32, 32, 32),
        fused_eval=True, device="cpu"), torch.Generator().manual_seed(6))
    model = model.to(cuda)
    frames = torch.from_numpy(ds.load_frames()).to(cuda)
    cfg = ScoringConfig(uncertainty="VL4Pose", input_size=(128, 96))
    engine = ScoringEngine(model, cfg, aux_model=AuxNet(device=cuda), chunk=4)
    reset_launch_counts()
    res = engine.score(frames, *args)
    n_chunks = -(-len(d) // 4)
    assert fused_bottleneck_chain.launches == 4 * n_chunks
    assert fused_postprocess.launches == 1
    assert rot_warp_crop.launches == n_chunks
    assert np.isfinite(res["unc"]).all() and res["unc"].any()
    plain = ScoringEngine(model, ScoringConfig(uncertainty="None",
                                               input_size=(128, 96)),
                          chunk=4).score(frames, *args)
    for key in ("heatmaps", "embeddings"):
        got, want = (torch.as_tensor(r[key]).float().cpu()
                     for r in (res, plain))
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), key


@pytest.mark.cuda
def test_eval_forward_under_autograd_gives_the_tails_their_gradients(cuda):
    """An eval-mode forward of a fused_eval SimplePose-R50 that asks for a
    gradient takes the module graph (kernels/serving.py's rule), not K1,
    whose output carries no autograd graph: every parameter of the four
    stage tails gets the gradient that the same model built without
    fused_eval gets, within 1e-5 of its scale (cuDNN's backward is not
    bit-reproducible from run to run)."""
    from vatl4pose_tpu_torch.models import SimplePose
    gen = torch.Generator().manual_seed(7)
    fused, plain = (SimplePose(num_joints=17, num_layers=50,
                               deconv_dim=(32, 32, 32), fused_eval=f,
                               device="cpu") for f in (True, False))
    plain.load_state_dict(he_scaled_(fused, gen).state_dict())
    x = torch.randn((2, 3, 64, 64), generator=gen).to(cuda)
    grads = []
    for model in (fused, plain):
        model = model.to(cuda).eval()
        reset_launch_counts()
        model(x).square().sum().backward()
        torch.cuda.synchronize()
        assert fused_bottleneck_chain.launches == 0
        grads.append(dict(model.named_parameters()))
    tails = [n for n in grads[1]
             if n.startswith("preact.layer") and n.split(".")[2] != "0"]
    # 12 tail blocks of 3 convs and 3 BNs (weight and bias)
    assert len(tails) == 12 * 9
    for n in tails:
        got, want = grads[0][n].grad, grads[1][n].grad
        assert got is not None, n
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), n


def _pretrain_cfg(root, ann, epochs):
    """posetrack_train's config at a small width: SimplePose-R50 (its
    bottleneck tails reach K1) with 32-wide deconvolutions at 64x64."""
    from vatl4pose_tpu_torch.config import Cfg
    split = {"TYPE": "Posetrack21", "ROOT": root, "ANN": ann}
    return Cfg({
        "DATASET": {"TRAIN": dict(split, AUG={
            "FLIP": True, "ROT_FACTOR": 40, "SCALE_FACTOR": 0.3,
            "NUM_JOINTS_HALF_BODY": 8, "PROB_HALF_BODY": -1}),
            "TEST": dict(split)},
        "DATA_PRESET": {"TYPE": "simple", "SIGMA": 2, "NUM_JOINTS": 17,
                        "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16]},
        "MODEL": {"TYPE": "SimplePose", "PRETRAINED": "",
                  "NUM_DECONV_FILTERS": [32, 32, 32], "NUM_LAYERS": 50},
        "TRAIN": {"BATCH_SIZE": 8, "BEGIN_EPOCH": 0, "END_EPOCH": epochs,
                  "OPTIMIZER": "adam", "LR": 1e-3, "LR_FACTOR": 0.1,
                  "LR_STEP": [1]}})


@pytest.mark.cuda
def test_pretrain_resident_step_launches_k3_once(cuda, tmp_path):
    """One epoch of posetrack_train.train on the card, frames resident: 8
    samples at batch 8 make one optimizer step, whose crop is one K3
    launch; the epoch's validate_gt pass launches K3 1, K1 4 and K2 1.
    The loss is finite and model_0.pth is written."""
    import argparse
    from vatl4pose_tpu_torch.cli import posetrack_train
    from vatl4pose_tpu_torch.data import make_synthetic_video
    from vatl4pose_tpu_torch.train import retrain
    root, ann = make_synthetic_video(str(tmp_path), num_frames=4,
                                     num_persons=2, width=160, height=128)
    opt = argparse.Namespace(seed=3, snapshot=1, epochs_override=None,
                             work_dir=str(tmp_path / "w"), stream=False,
                             launcher="none", device=None)
    steps = []
    step = retrain.Retrainer.train_step

    def counted(self, *a, **kw):
        steps.append(rot_warp_crop.launches)
        return step(self, *a, **kw)
    retrain.Retrainer.train_step = counted
    try:
        reset_launch_counts()
        _, history = posetrack_train.train(_pretrain_cfg(root, ann, 1), opt)
    finally:
        retrain.Retrainer.train_step = step
    torch.cuda.synchronize()
    assert len(steps) == 1 and steps == [0]
    assert rot_warp_crop.launches == 2        # the step's crop, the pass's
    assert fused_bottleneck_chain.launches == 4
    assert fused_postprocess.launches == 1
    assert np.isfinite(history[0]["loss"]) and "ap" in history[0]
    assert (tmp_path / "w" / "model_0.pth").exists()


@pytest.mark.cuda
def test_validate_through_kernels_matches_plain_versions(cuda, tmp_path):
    """poseestimator_eval.validate on the card through K3, K1 and K2
    against the same call with the three kernels' plain versions
    (patched in where the pass calls them), on seeded He-scaled weights:
    the heatmaps within 1e-3 of their max (phase 3's card-vs-CPU bound),
    kpts and OKS within rtol 1e-4 / atol 1e-3, and the AP equal."""
    import vatl4pose_tpu_torch.al.scoring as scoring_mod
    import vatl4pose_tpu_torch.kernels.rot_warp as rot_warp_mod
    import vatl4pose_tpu_torch.models.resnet as resnet_mod
    from vatl4pose_tpu_torch.cli import poseestimator_eval
    from vatl4pose_tpu_torch.data import make_synthetic_video
    root, ann = make_synthetic_video(str(tmp_path), num_frames=5,
                                     num_persons=3, width=160, height=128)
    cfg = _pretrain_cfg(root, ann, 1)
    model = poseestimator_eval.load_model(cfg, device="cpu")
    model = he_scaled_(model, torch.Generator().manual_seed(9)).to(cuda)
    kept = []
    score = scoring_mod.ScoringEngine.score

    def keeping(self, *a, **kw):
        kw["keep_heatmaps"] = True
        res = score(self, *a, **kw)
        kept.append(res["heatmaps"].float().cpu())
        return res
    plain = ((resnet_mod, "fused_bottleneck_chain",
              bottleneck_chain_reference),
             (scoring_mod, "fused_postprocess", postprocess_reference),
             (rot_warp_mod, "rot_warp_crop", rot_warp_crop_reference))
    kernels = [getattr(m, name) for m, name, _ in plain]
    scoring_mod.ScoringEngine.score = keeping
    try:
        reset_launch_counts()
        got = poseestimator_eval.validate(cfg, model, "TEST")
        launches = (fused_bottleneck_chain.launches,
                    fused_postprocess.launches, rot_warp_crop.launches)
        for m, name, ref in plain:
            setattr(m, name, ref)
        want = poseestimator_eval.validate(cfg, model, "TEST")
    finally:
        scoring_mod.ScoringEngine.score = score
        for (m, name, _), k in zip(plain, kernels):
            setattr(m, name, k)
    assert launches == (4, 1, 1)
    hm, hm_plain = kept
    assert (hm - hm_plain).abs().max() <= 1e-3 * hm_plain.abs().max()
    for key in ("keypoints", "OKS"):
        np.testing.assert_allclose(np.array([e[key] for e in got[1]]),
                                   np.array([e[key] for e in want[1]]),
                                   rtol=1e-4, atol=1e-3, err_msg=key)
    assert got[0]["AP"] == want[0]["AP"]


def _dp_step_rank(rank, store, out):
    """One rank of test_dp_step_on_one_card_keeps_ranks_identical."""
    import torch.distributed as dist
    from vatl4pose_tpu_torch.parallel import (
        Sharding, build_sharded_train_step, make_mesh)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    mesh = make_mesh(2)
    model, opt, batch = _dp_step_operands(mesh.device)
    loss = build_sharded_train_step(model, opt, mesh)(
        *(Sharding(mesh, ("data",)).local(a) for a in batch))[0]
    torch.save({"loss": float(loss),
                "state": {k: v.cpu() for k, v in model.state_dict().items()}},
               f"{out}_{rank}.pt")
    dist.destroy_process_group()


def _dp_step_operands(device):
    """A seeded R18 in train mode, its AdamW, and a batch of 16 whose last
    5 rows are padding: (x, target, mask, valid)."""
    from vatl4pose_tpu_torch.models import SimplePose
    from vatl4pose_tpu_torch.train import build_optimizer, set_lr
    torch.manual_seed(0)
    model = SimplePose(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64),
                       device="cpu").to(device).train()
    opt = build_optimizer(model, {"OPTIMIZER": "AdamW", "LR": 2.5e-4,
                                  "WEIGHT_DECAY": 0.7}, "SimplePose")
    set_lr(opt, 2.5e-4)
    rng = np.random.default_rng(5)
    batch = (rng.normal(0, 1, (16, 3, 64, 64)),
             rng.uniform(0, 1, (16, 17, 16, 16)),
             rng.uniform(size=(16, 17, 1, 1)) > 0.2)
    x, target, mask = (torch.tensor(a, dtype=torch.float32, device=device)
                       for a in batch)
    return model, opt, (x, target, mask,
                        torch.arange(16, device=device) < 11)


@pytest.mark.cuda
def test_dp_step_on_one_card_keeps_ranks_identical(cuda, tmp_path):
    """Two gloo ranks on cuda:0, one data-parallel train step (8 rows a
    rank, 3 of rank 1's valid): every parameter and BN statistic
    bit-identical across the ranks afterwards, and the loss within rel
    1e-5 of the one-process step on the card."""
    import torch.multiprocessing as mp
    from vatl4pose_tpu_torch.models.criterion import masked_heatmap_loss
    out = str(tmp_path / "rank")
    mp.start_processes(_dp_step_rank, args=(str(tmp_path / "store"), out),
                       nprocs=2, start_method="spawn")
    r0, r1 = (torch.load(f"{out}_{r}.pt") for r in range(2))
    assert r0["loss"] == r1["loss"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    model, opt, (x, target, mask, valid) = _dp_step_operands(cuda)
    loss = masked_heatmap_loss(model(x), target, mask, valid=valid).item()
    assert r0["loss"] == pytest.approx(loss, rel=1e-5)
