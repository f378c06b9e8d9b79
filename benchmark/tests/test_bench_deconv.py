"""K6's bound (benchmark/deconv_bounds.py) and its reader
(benchmark/metrics/k6_roofline.score.py): the stages each configuration
has, their FLOPs against benchmark/flops.py's count of the head, and the
kernel names each roofline reader counts."""

import json
import types
from pathlib import Path

import pytest
import torch
from torch import nn

from benchmark import core, deconv_bounds
from benchmark.flops import layer_macs
from benchmark.reference.models import build_estimator

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
# device kernel names as the profiler gives them, one a roofline reader
K1 = ("void (anonymous namespace)::conv_gemm_kernel<float, 128, true, "
      "false>(CUtensorMap, CUtensorMap, CUtensorMap, float const*, float "
      "const*, float const*, float const*, float*, int, int, int, int, "
      "int, int)")
K5 = ("(anonymous namespace)::shuffle_conv3x3_kernel(CUtensorMap, "
      "CUtensorMap, float const*, float const*, float const*, float*, int, "
      "int, int, int, int)")
K6 = ("(anonymous namespace)::subpixel_deconv4x4_kernel(CUtensorMap_st, "
      "CUtensorMap_st, float const*, float const*, float const*, float*, "
      "int, int, int, int, int)")
SPLIT = ("(anonymous namespace)::deconv4x4_split_kernel(float const*, "
         "float const*, float const*, float*, float*, float*, float*, int, "
         "int)")


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_stages_of_each_configuration():
    assert deconv_bounds.deconv_layers(config("simplepose_r50")) == [
        (2048, 256, 8, 6), (256, 256, 16, 12), (256, 256, 32, 24)]
    assert deconv_bounds.deconv_layers(config("hrnet_w32")) == []
    assert deconv_bounds.deconv_layers(config("fastpose_dcn_r50")) == []
    r18 = config("simplepose_r50")
    r18["MODEL"] = dict(r18["MODEL"], NUM_LAYERS=18)
    assert deconv_bounds.deconv_layers(r18)[0] == (512, 256, 8, 6)


def test_flops_equal_flops_py_count_of_the_head():
    """2 N H W Cin Cout 16 a stage is what benchmark/flops.py counts for
    the reference model's three ConvTranspose2d, 2.82 GFLOP a sample."""
    cfg = config("simplepose_r50")
    with torch.device("meta"):
        model = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"]).eval()
    macs = []

    def hook(m, inp, out):
        macs.append(layer_macs(m, inp[0], out))
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.empty((1, 3, 256, 192), device="meta"))
    layers = deconv_bounds.deconv_layers(cfg)
    assert [2 * m for m in macs] == [2.0 * h * w * cin * cout * 16
                                     for cin, cout, h, w in layers]
    assert sum(2 * m for m in macs) / 1e9 == pytest.approx(2.82, abs=5e-3)


def ctx(kernels, cfg="simplepose_r50"):
    """A traced run of two passes of two chunks of 512 whose device
    kernels are `kernels`: (name, start ns, end ns)."""
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(kernels=kernels), cfg=config(cfg),
        chunks=[512, 512], traced_units=2)


def test_each_roofline_reader_counts_its_own_kernel():
    """K6's launches (40 ms) and its split are read by k6_roofline.score
    alone: the K1 and K5 readers find nothing of theirs in them, and K6's
    finds nothing in K1's and K5's."""
    k1, k5, k6 = (core.reader(f"k{i}_roofline.score") for i in (1, 5, 6))
    only_k6 = [(K6, 0, 40_000_000), (SPLIT, 40_000_000, 40_100_000)]
    assert k1(ctx(only_k6)) is None and k5(ctx(only_k6)) is None
    bound = 4 * deconv_bounds.k6_bound_s(
        512, deconv_bounds.deconv_layers(config("simplepose_r50")))
    assert k6(ctx(only_k6)) == pytest.approx(100 * bound / 0.04)
    others = [(K1, 0, 10), (K5, 10, 20)]
    assert k6(ctx(others)) is None
    assert k1(ctx(others)) is not None
    assert k5(ctx(others, "fastpose_dcn_r50")) is not None
