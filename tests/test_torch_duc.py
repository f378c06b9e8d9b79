"""The DUC convolution of FastPose's head: K5 (kernels/duc_conv.py,
csrc/fused_bottleneck.cu's shuffle_conv3x3_kernel) and its plain
version, against the eager `DUC` (3x3 conv, eval BN, ReLU,
PixelShuffle(2)).

CPU: the plain version (the weights in K5's column order, the folded BN,
the shuffled store) against the eager module at both DUC shapes of
AlphaPose's FastPose, with random BN statistics and a ragged batch; the
split's layout; the wrapper's refusals; K5's bound by hand.

Card (marker `cuda`, skipped without one): K5 against a float64 forward
within twice cuDNN f32's distance (the eager route, TF32 off) at both
shapes for N = 512 and 37 and on cancelling operands; at ragged shapes
against the eager module; the split kernel bit for bit its plain
version.  The file
imports neither JAX nor the JAX package, so on a machine with only
PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_duc.py -m cuda
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import duc_bounds
from vatl4pose_tpu_torch.kernels import (fold_bn, reset_launch_counts,
                                         shuffle_conv3x3,
                                         shuffle_conv3x3_reference,
                                         shuffle_split, tf32_split)
from vatl4pose_tpu_torch.kernels.duc_conv import (_check_operands,
                                                  _unshuffle, shuffle_order)
from vatl4pose_tpu_torch.models.layers import DUC

CFG = json.loads((Path(__file__).resolve().parent.parent / "benchmark"
                  / "configs" / "fastpose_dcn_r50.json").read_text())
# (Cin, Cout, H, W) of FastPose's two DUCs at 256x192
SHAPES = [(512, 1024, 16, 12), (256, 512, 32, 24)]
IDS = ["duc1", "duc2"]


def duc(cin, cout, seed, device="cpu"):
    """An eval DUC with He-scaled weights and random BN statistics."""
    g = torch.Generator().manual_seed(seed)
    m = DUC(cin, cout, fused_eval=True)
    with torch.no_grad():
        m.conv.weight.copy_(torch.randn(m.conv.weight.shape, generator=g)
                            * (2.0 / (9 * cin)) ** 0.5)
        m.bn.weight.copy_(torch.rand(cout, generator=g) + 0.5)
        m.bn.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        m.bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.1)
        m.bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
    return m.to(device).eval()


def folded(m):
    return fold_bn(m.bn.weight, m.bn.bias, m.bn.running_mean,
                   m.bn.running_var, m.bn.eps)


def stream(n, cin, h, w, seed, device="cpu"):
    """A post-ReLU NCHW stream, channels-last as the backbone leaves it."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cin, h, w), generator=g).relu().to(device) \
        .contiguous(memory_format=torch.channels_last)


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_version_equals_the_eager_duc(few_threads, shape):
    """The plain version with the permuted weights and the shuffled store
    against conv -> BN -> ReLU -> PixelShuffle at a ragged batch of 3:
    f32 rounding apart (oneDNN sums each conv in another order for the
    permuted rows, and the BN runs folded), 1e-5 of the largest value;
    seen 1.2e-6 and 1.9e-6.  The fused module returns the same NCHW
    values, channels-last."""
    cin, cout, h, w = shape
    m = duc(cin, cout, seed=cin)
    x = stream(3, cin, h, w, seed=1)
    s, b = folded(m)
    with torch.no_grad():
        want = m.pixel_shuffle(m.relu(m.bn(m.conv(x))))
        got = shuffle_conv3x3_reference(x.permute(0, 2, 3, 1).contiguous(),
                                        m.conv.weight, s, b)
        fused = m(x)
    assert got.shape == (3, 2 * h, 2 * w, cout // 4)
    scale = want.abs().max()
    assert (got.permute(0, 3, 1, 2) - want).abs().max() <= 1e-5 * scale
    assert fused.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(fused, got.permute(0, 3, 1, 2))


def test_shuffle_order_is_pixel_shuffle():
    """Column q * C4 + c holds channel 4c + q: the columns put back in
    channel order and shuffled by torch are the plain version's store."""
    N, cout, H, W = 2, 32, 3, 5
    order = shuffle_order(cout)
    assert sorted(order.tolist()) == list(range(cout))
    y = torch.arange(N * cout * H * W, dtype=torch.float32) \
        .reshape(N, cout, H, W)
    cols = y[:, order]
    want = torch.nn.functional.pixel_shuffle(y, 2).permute(0, 2, 3, 1)
    assert torch.equal(_unshuffle(cols, H, W), want)


def test_split_lays_out_k_major_rows_in_column_order():
    """shuffle_split's plain version: row n of (Cout, 9, Cin) holds
    channel order[n]'s weights at k = (3 ky + kx) * Cin + ci, hi + lo its
    TF32 split; s and b follow the rows."""
    g = torch.Generator().manual_seed(4)
    cout, cin = 32, 12
    w = torch.randn((cout, cin, 3, 3), generator=g)
    s, b = torch.rand(cout, generator=g), torch.randn(cout, generator=g)
    hi, lo, sp, bp = shuffle_split(w, s, b)
    order = shuffle_order(cout)
    assert hi.shape == lo.shape == (cout, 9, cin)
    for n, ky, kx, ci in ((0, 0, 0, 0), (9, 1, 2, 5), (31, 2, 1, 11)):
        want = w[order[n], ci, ky, kx]
        h, lw = tf32_split(want.reshape(1))
        k = 3 * ky + kx
        assert hi[n, k, ci] == h[0] and lo[n, k, ci] == lw[0]
    assert torch.equal(sp, s[order]) and torch.equal(bp, b[order])


@pytest.mark.parametrize("case", [
    # (x shape, Cout, what is wrong)
    ((2, 4, 4, 6), 32, "Cin not a multiple of 4"),
    ((2, 4, 4, 8), 24, "Cout not a multiple of 16"),
    ((2, 4, 40000, 8), 32, "W past the packed column"),
], ids=["cin6", "cout24", "wide"])
def test_wrapper_refuses_what_k5_cannot_take(case):
    shape, cout, _ = case
    x = torch.zeros(shape)
    w = torch.zeros((cout, shape[-1], 3, 3))
    with pytest.raises(ValueError):
        _check_operands(x, w, torch.zeros(cout), torch.zeros(cout))


def test_wrapper_refuses_operands_of_another_layout():
    x = torch.zeros((2, 4, 4, 8))
    w = torch.zeros((32, 8, 3, 3))
    s = torch.zeros(32)
    with pytest.raises(ValueError):
        _check_operands(x.permute(0, 2, 1, 3), w, s, s)
    with pytest.raises(ValueError):
        _check_operands(x, w.double(), s, s)
    with pytest.raises(ValueError):
        _check_operands(x, w, torch.zeros(16), s)


def test_k5_bound_by_hand():
    """benchmark/duc_bounds.py at the configuration, by hand: each DUC
    is 2 * 512 * 9 * 1024 * 192 = 1.81 GFLOP a sample, 0.928 TFLOP at a
    chunk of 512, bound by three TF32 products (5.62 ms each) and not by
    bytes (its input read and its output written once, 0.18 ms)."""
    convs = duc_bounds.duc_convs(CFG)
    assert convs == SHAPES
    flops = 2.0 * 512 * 512 * 9 * 1024 * 192
    assert flops == 2.0 * 512 * 256 * 9 * 512 * 768
    t_ops = 3 * flops / 495e12
    nbytes = 4 * (512 * 192 * (512 + 1024) + 1024 * 512 * 9 + 2 * 1024)
    assert nbytes / 3.35e12 < t_ops
    assert duc_bounds.k5_bound_s(512, convs[:1]) == pytest.approx(t_ops)
    assert duc_bounds.k5_bound_s(512, convs) * 1e3 == pytest.approx(
        11.245, abs=1e-3)
    hrnet = json.loads((Path(__file__).resolve().parent.parent / "benchmark"
                        / "configs" / "hrnet_w32.json").read_text())
    assert duc_bounds.duc_convs(hrnet) == []


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 has no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def eager_f64(m, x):
    """The eager DUC in float64 (on the card: the same sums exactly
    enough, and a CPU float64 pass of a chunk takes minutes), NHWC."""
    with torch.no_grad():
        y = torch.nn.functional.conv2d(x.double(), m.conv.weight.double(),
                                       padding=1)
        bn = m.bn
        s = bn.weight.double() * torch.rsqrt(bn.running_var.double()
                                             + bn.eps)
        b = bn.bias.double() - bn.running_mean.double() * s
        y = torch.relu(y * s[:, None, None] + b[:, None, None])
        return torch.nn.functional.pixel_shuffle(y, 2).permute(0, 2, 3, 1)


def distances(m, x):
    """max|err| / max from the float64 DUC of K5 and of the eager route
    (the DUC module on cuDNN in f32)."""
    exact = eager_f64(m, x)
    scale = exact.abs().max().item()
    with torch.no_grad():
        s, b = folded(m)
        reset_launch_counts()
        got = {"K5": shuffle_conv3x3(x.permute(0, 2, 3, 1).contiguous(),
                                     m.conv.weight, s, b)}
        assert shuffle_conv3x3.launches == 1
        assert shuffle_conv3x3.split_launches == 1
        m.fused_eval = False
        got["eager route"] = m(x).permute(0, 2, 3, 1)
        m.fused_eval = True
    torch.cuda.synchronize()
    d = {k: (v.double() - exact).abs().max().item() / scale
         for k, v in got.items()}
    print("max|err|/max from f64: " + ", ".join(f"{k} {v:.3e}"
                                                for k, v in d.items()))
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 37])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_k5_within_twice_cudnn_f32_from_f64(cuda, shape, n):
    """K5's distance from the float64 DUC at most twice that of the eager
    route in f32.  cuDNN's route is an implicit GEMM at duc1 and an FFT at
    duc2, whose error is no f32 sum over K = 9 Cin: 2.5e-7 to 3.0e-7,
    where one running sum of K5's promoted k-steps read 7.3e-7 to 7.6e-7;
    K5 sums each tap apart (TAP_SUMS) to stay within twice it."""
    cin, cout, h, w = shape
    m = duc(cin, cout, seed=cin + n, device=cuda)
    d = distances(m, stream(n, cin, h, w, seed=n, device=cuda))
    assert d["K5"] <= 2 * d["eager route"], d


@pytest.mark.cuda
def test_k5_f32_precision_on_cancelling_operands(cuda):
    """duc1's shape (K = 9 * 512 = 4608) on operands whose sums cancel as
    a trained network's do: positive activations of mean 1, weights of
    mean 0.02, and BN biases that subtract each channel's mean
    pre-activation (from a float64 pass), so an output is a few percent
    of its sum.  The rule of K1's cancelling test: K5 at most twice
    cuDNN f32's distance from float64."""
    rng = np.random.default_rng(21)
    cin, cout, h, w = SHAPES[0]
    m = DUC(cin, cout, fused_eval=True).to(cuda).eval()
    x = torch.tensor(rng.uniform(0.5, 1.5, (8, cin, h, w)),
                     dtype=torch.float32, device=cuda) \
        .contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        m.conv.weight.copy_(torch.tensor(
            0.02 + rng.normal(0, 0.02, (cout, cin, 3, 3)),
            dtype=torch.float32))
        pre = torch.nn.functional.conv2d(x.double(), m.conv.weight.double(),
                                         padding=1)
        m.bn.running_mean.copy_(pre.mean(dim=(0, 2, 3)).float())
        m.bn.running_var.fill_(1.0)
        m.bn.weight.fill_(1.0)
        m.bn.bias.zero_()
    d = distances(m, x)
    assert d["K5"] <= 2 * d["eager route"], d


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (N, H, W, Cin, Cout)
    (3, 13, 11, 36, 48),     # a tile straddles sub-pixels (C4 = 12)
    (2, 1, 37, 64, 128),     # H = 1: rows above and below are padding
    (2, 29, 1, 64, 64),      # W = 1
    (1, 5, 6, 4, 16),        # M = 30 rows, one K step of 4 channels
    (2, 8, 6, 520, 272),     # ragged K steps and column tiles
], ids=["c4_12", "h1", "w1", "m30", "ragged"])
def test_k5_at_edge_shapes(cuda, case):
    n, h, w, cin, cout = case
    m = duc(cin, cout, seed=cin + cout, device=cuda)
    x = stream(n, cin, h, w, seed=h + w, device=cuda)
    with torch.no_grad():
        got = m(x)
        m.fused_eval = False
        want = m(x)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 48), (512, 1024), (256, 512)])
def test_shuffle_split_kernel_equals_its_plain_version(cuda, shape):
    cin, cout = shape
    g = torch.Generator().manual_seed(cin)
    w = torch.randn((cout, cin, 3, 3), generator=g)
    # ties of the TF32 rounding and values already TF32
    w.view(-1)[:64] = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 0.5,
                                    -1 - 2 ** -11] * 16)
    s, b = torch.rand(cout, generator=g), torch.randn(cout, generator=g)
    want = shuffle_split(w, s, b)
    got = shuffle_split(w.to(cuda), s.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert torch.equal(a.cpu(), e)


@pytest.mark.cuda
def test_k5_refuses_a_misaligned_stream(cuda):
    flat = torch.zeros(2 * 4 * 4 * 8 + 1, device=cuda)
    x = flat[1:].view(2, 4, 4, 8)
    w = torch.zeros((32, 8, 3, 3), device=cuda)
    s = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):
        shuffle_conv3x3(x, w, s, s)
