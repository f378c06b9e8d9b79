"""The benchmark's own arithmetic, by hand: FLOPs, kernel bounds, the
idle share's interval union."""

import math

import pytest
import torch

from benchmark import bounds, trace
from benchmark.flops import count_flops
from benchmark.reference.models.PoseHighResolutionNet import \
    HighResolutionModule
from benchmark.reference.models.resnet import Bottleneck
from benchmark.reference.layers import ConvTranspose2d


def meta(*shape):
    return torch.empty(shape, device="meta")


def test_flops_of_one_bottleneck():
    with torch.device("meta"):
        blk = Bottleneck(256, 64)
    H, W = 16, 12
    macs = H * W * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert count_flops(blk, meta(1, 256, H, W)) == 2 * macs


def test_flops_of_one_deconvolution():
    with torch.device("meta"):
        de = ConvTranspose2d(2048, 256, 4, stride=2, padding=1, bias=False)
    # every input value meets 256 x 4 x 4 weights
    macs = 8 * 6 * 2048 * 256 * 16
    assert count_flops(de, meta(1, 2048, 8, 6)) == 2 * macs


def test_flops_of_one_hrnet_fuse_layer():
    with torch.device("meta"):
        mod = HighResolutionModule(2, "BASIC", [1, 1], [32, 64], [32, 64])
    H, W = 16, 12
    up = mod.fuse_layers[0][1]          # 1x1 64 -> 32 at H/2 x W/2
    down = mod.fuse_layers[1][0]        # 3x3 stride 2, 32 -> 64
    assert count_flops(up, meta(1, 64, H // 2, W // 2)) \
        == 2 * (H // 2) * (W // 2) * 64 * 32
    assert count_flops(down, meta(1, 32, H, W)) \
        == 2 * (H // 2) * (W // 2) * 32 * 9 * 64


def test_kernel_bounds_equal_the_recorded_ones():
    """PERF.md's K1, K2 and K3 bounds at the 512-sample shapes of
    SimplePose-R50 at 256x192: K1 15.93 ms f32 (3 TF32 products) and
    2.70 ms bf16, K2 0.0320 ms, K3 0.1011 ms from 36.73 MB of source."""
    tails = bounds.resnet_tails(50, (256, 192))
    assert tails == [(64, 48, 256, 64, 2), (32, 24, 512, 128, 3),
                     (16, 12, 1024, 256, 5), (8, 6, 2048, 512, 2)]
    assert bounds.k1_bound_s(512, tails) * 1e3 == pytest.approx(15.93,
                                                                abs=5e-3)
    assert bounds.k1_bound_s(512, tails, 2) * 1e3 == pytest.approx(
        2.70, abs=5e-3)
    assert bounds.k2_bound_s(512, 17, 64, 48) * 1e3 == pytest.approx(
        0.0320, abs=5e-5)
    assert bounds.k3_bound_s(512, (256, 192), 36.73e6) * 1e3 == \
        pytest.approx(0.1011, abs=5e-5)


def test_k3_source_bytes_counts_each_pixel_once():
    frames = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    # two identical integer-aligned 4x4 crops of frame 0: 16 pixels
    mats = torch.tensor([[[1.0, 0, 2], [0, 1.0, 2]]] * 2)
    fi = torch.tensor([0, 0])
    assert bounds.k3_source_bytes(frames, fi, mats, (4, 4)) == 16 * 3


def test_union_counts_overlaps_once():
    # three kernels on two streams overlap; their sum exceeds the window
    ivs = [(0, 60), (40, 100), (90, 120), (150, 160)]
    assert sum(e - s for s, e in ivs) == 160
    assert trace.union_ns(ivs) == 130
    assert trace.gaps(ivs, 0, 200) == [(120, 150), (160, 200)]


def test_summary_idle_share_from_the_union():
    ev = [("bench.window", False, 0, 100), ("bench.window", True, 0, 100),
          ("bench.unit", False, 0, 100), ("bench.unit", True, 1, 99),
          ("k1", True, 0, 70), ("k2", True, 30, 90),
          ("aten::copy_", False, 92, 99)]
    s = trace.summarize(ev)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx(90e-9)      # not 130e-9
    assert 1 - s.busy_s / s.window_s == pytest.approx(0.1)
    assert s.breakdown["device_ops"][0] == ["k1", 70e-9]
    assert s.breakdown["idle_gaps"] == [["aten::copy_", 10e-9]]
    assert [n for n, _, _ in s.kernels] == ["k1", "k2"]
    assert not math.isnan(s.busy_s)
