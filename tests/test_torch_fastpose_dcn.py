"""FastPose-R50 with deformable convolutions (AlphaPose's Fast Pose (DCN),
the benchmark's `fastpose_dcn_r50`) against the benchmark's plain
reference, and the deformable im2col kernel K4 against the eager route.

CPU: at the configuration's widths and depth on a 96x64 input, the
port's model (built by `build_sppe` as the AL loop builds it) against
benchmark/reference/models/FastPose.py on seeded weights from
benchmark/weights.py, in eval (the fused eval route) and train mode, for
DCNv1 with one deform group (the configuration) and DCNv2 with two groups
on one stage; and which route each kind of forward takes.

Card (marker `cuda`, skipped without one): K4's columns equal the eager
route's bit for bit, at the six shapes of the configuration's 13
deformable 3x3s at a chunk of 512 and at edge shapes; a fused eval pass of
a chunk launches K4 13 times and never the eager route, and K5 twice and
never the eager DUC; a train-mode forward takes the eager routes.  The file imports neither JAX nor the JAX
package, so on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fastpose_dcn.py -m cuda
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.models import build_estimator
from benchmark.weights import estimator_weights
from vatl4pose_tpu_torch.kernels import (deform_columns, deform_conv,
                                         deform_im2col, reset_launch_counts,
                                         shuffle_conv3x3,
                                         shuffle_conv3x3_reference)
from vatl4pose_tpu_torch.kernels.deform_conv import DeformConv2d
from vatl4pose_tpu_torch.models import build_sppe, layers, resnet

CFG = json.loads((Path(__file__).resolve().parent.parent / "benchmark"
                  / "configs" / "fastpose_dcn_r50.json").read_text())
SEED = 2 ** 31 + 2020
# the configuration's deformable 3x3s at 256x192: (C, H, W, stride,
# number of such convolutions); 4 + 6 + 3 = 13
CHUNK_SHAPES = [(128, 64, 48, 2, 1), (128, 32, 24, 1, 3),
                (256, 32, 24, 2, 1), (256, 16, 12, 1, 5),
                (512, 16, 12, 2, 1), (512, 8, 6, 1, 2)]


def config(small=True, v2=False):
    cfg = copy.deepcopy(CFG)
    if small:
        cfg["DATA_PRESET"]["IMAGE_SIZE"] = [96, 64]
        cfg["DATA_PRESET"]["HEATMAP_SIZE"] = [24, 16]
    if v2:
        cfg["MODEL"]["DCN"] = {"MODULATED": True, "DEFORM_GROUP": 2,
                               "FALLBACK_ON_STRIDE": False}
        cfg["MODEL"]["STAGE_WITH_DCN"] = [False, False, True, False]
    return cfg


def models(cfg, device, fused_eval=True):
    """(port, reference) holding the same seeded weights."""
    w = estimator_weights(cfg, SEED, device)
    port = build_sppe(cfg["MODEL"], cfg["DATA_PRESET"],
                      fused_eval=fused_eval, device=device)
    port.load_state_dict(w)
    ref = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"]).to(device)
    ref.load_state_dict(w)
    return port, ref


def crops(n, cfg, device, seed=0):
    h, w = cfg["DATA_PRESET"]["IMAGE_SIZE"]
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3, h, w), generator=g) - 0.45).to(device)


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("v2", [False, True], ids=["v1_g1", "v2_g2"])
def test_eval_matches_reference(few_threads, v2):
    """Eval heatmaps and embedding.  1e-5 of the largest value: both sum
    in f32, in another order (oneDNN's convolutions and the port's gather
    route against torch's plain convolutions and grid_sample, whose
    normalised coordinates move a sample by ~1e-6 px); the widest gap seen
    is 3e-7, TF32 rounding (the benchmark's control) reads ~1e-4."""
    cfg = config(v2=v2)
    port, ref = models(cfg, "cpu")
    x = crops(3, cfg, "cpu")
    with torch.no_grad():
        hp, ep = port.eval()(x, return_embedding=True)
        hr, er = ref.eval()(x, return_embedding=True)
    assert hp.shape == hr.shape == (3, 17, 24, 16)
    assert ep.shape == er.shape == (3, 2048)
    assert rel(hp, hr) < 1e-5
    assert rel(ep, er) < 1e-5


@pytest.mark.parametrize("v2", [False, True], ids=["v1_g1", "v2_g2"])
def test_train_forward_matches_reference(few_threads, v2):
    """Train mode (batch statistics).  At this size a channel's batch
    statistics come from as few as 24 values and every offset moves with
    the activations it is computed from, so f32 rounding is amplified
    through the depth: the plain f32 reference itself sits 7e-4 to 7e-3
    from the same reference in float64.  So both are held to the float64
    reference: the port within twice the f32 reference's own distance
    (seen: 0.97-1.16 times).  The running statistics differ by design
    (the port updates the variance with the biased batch variance, as
    Flax does), the forward does not."""
    cfg = config(v2=v2)
    port, ref = models(cfg, "cpu")
    exact = copy.deepcopy(ref).double().train()
    x = crops(4, cfg, "cpu", seed=1)
    hp, ep = port.train()(x, return_embedding=True)
    hr, er = ref.train()(x, return_embedding=True)
    with torch.no_grad():
        h64, e64 = exact(x.double(), return_embedding=True)
    for got, f32, f64 in ((hp, hr, h64), (ep, er, e64)):
        assert rel(got.detach().double(), f64) \
            <= 2 * rel(f32.detach().double(), f64) + 1e-7


def test_offsets_move_the_samples(few_threads):
    """The seeded offsets are not zero: zeroing them changes the maps, so
    the deformable sampling is exercised (a zero offset is a plain 3x3)."""
    cfg = config()
    port, _ = models(cfg, "cpu")
    x = crops(2, cfg, "cpu")
    with torch.no_grad():
        h1 = port.eval()(x)
        for m in port.modules():
            if hasattr(m, "conv2_offset"):
                m.conv2_offset.weight.zero_()
                m.conv2_offset.bias.zero_()
        h0 = port(x)
    assert rel(h0, h1) > 1e-2


@pytest.fixture(scope="module")
def route_port():
    cfg = config()
    port = build_sppe(cfg["MODEL"], cfg["DATA_PRESET"], fused_eval=True,
                      device="cpu")
    port.load_state_dict(estimator_weights(cfg, SEED, "cpu"))
    return port


# case: (mode, dtype, autograd, fused_eval)
ROUTE_CASES = {
    "train": ("train", torch.float32, True, True),
    "eval_autograd": ("eval", torch.float32, True, True),
    "eval_f32_no_grad": ("eval", torch.float32, False, True),
    "eval_bf16": ("eval", torch.bfloat16, False, True),
    "eval_f64": ("eval", torch.float64, False, True),
    "fused_eval_off": ("eval", torch.float32, False, False),
}
# kernel: (served cases, (kernel, eager) calls a served forward makes,
# (kernel, eager) calls any other forward makes): K1 on stage 1's tail
# (16 bottleneck forwards less its 2), K4 on the 13 deformable 3x3s, K5
# on the two DUCs
ROUTES = {
    "k1": ({"eval_f32_no_grad", "eval_bf16"}, (1, 14), (0, 16)),
    "k4": ({"eval_f32_no_grad"}, (13, 0), (0, 13)),
    "k5": ({"eval_f32_no_grad"}, (2, 0), (0, 2)),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
@pytest.mark.parametrize("kernel", list(ROUTES))
def test_routes(few_threads, monkeypatch, route_port, kernel, case):
    """kernels/serving.py's rule through the benchmark configuration's
    model: each kind of forward runs the kernel's function (its plain
    version here) or the module graph, and which ran is counted.  Only an
    eval forward that asks for no gradient, with fused_eval, in a dtype
    the kernel takes is served: f32 for all three, bf16 for K1 alone."""
    mode, dtype, autograd, fused_eval = ROUTE_CASES[case]
    port = copy.deepcopy(route_port).to(dtype).train(mode == "train")
    for m in port.modules():
        if hasattr(m, "fused_eval"):
            m.fused_eval = fused_eval
    calls = {"kernel": 0, "eager": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    if kernel == "k1":
        monkeypatch.setattr(resnet, "fused_bottleneck_chain", counted(
            "kernel", resnet.fused_bottleneck_chain))
        monkeypatch.setattr(resnet.Bottleneck, "forward", counted(
            "eager", resnet.Bottleneck.forward))
    elif kernel == "k4":
        # the CPU wrapper hands CPU tensors to deform_columns itself
        monkeypatch.setattr(deform_conv, "deform_im2col", counted(
            "kernel", deform_columns))
        monkeypatch.setattr(deform_conv, "deform_columns", counted(
            "eager", deform_columns))
    else:
        monkeypatch.setattr(layers, "shuffle_conv3x3", counted(
            "kernel", shuffle_conv3x3_reference))
        for duc in (port.duc1, port.duc2):
            monkeypatch.setattr(duc.pixel_shuffle, "forward", counted(
                "eager", duc.pixel_shuffle.forward))
    x = crops(1, config(), "cpu").to(dtype)
    with torch.set_grad_enabled(autograd):
        hm = port(x)
    assert hm.dtype == dtype and torch.isfinite(hm).all()
    served, on, off = ROUTES[kernel]
    assert (calls["kernel"], calls["eager"]) == (on if case in served
                                                 else off)


def test_cpu_columns_are_the_eager_route():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 7, 6), generator=g)
    off = torch.randn((2, 36, 4, 3), generator=g) * 2
    mask = torch.rand((2, 18, 4, 3), generator=g)
    got = deform_im2col(x, off, 3, 2, 1, mask, 2)
    assert torch.equal(got, deform_columns(x, off, 3, 2, 1, mask, 2))


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def operands(n, C, H, W, stride, G, modulated, device, scale=1.5, seed=0,
             channels_last=True):
    """A post-ReLU stream, offsets ~N(0, scale) px (taps fall across cells
    and past the border) and, for DCNv2, sigmoided masks."""
    rng = np.random.default_rng(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.tensor(rng.normal(0, 1, (n, C, H, W)), dtype=torch.float32,
                     device=device).relu()
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    off = torch.tensor(rng.normal(0, scale, (n, 18 * G, Ho, Wo)),
                       dtype=torch.float32, device=device)
    mask = torch.tensor(rng.uniform(0, 1, (n, 9 * G, Ho, Wo)),
                        dtype=torch.float32, device=device) \
        if modulated else None
    return x, off, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHUNK_SHAPES,
                         ids=[f"C{c}_{h}x{w}_s{s}" for c, h, w, s, _
                              in CHUNK_SHAPES])
def test_k4_columns_bit_for_bit_at_chunk_shapes(cuda, shape):
    C, H, W, stride, _ = shape
    x, off, _ = operands(512, C, H, W, stride, 1, False, cuda)
    # offsets as the model makes them: a channels-last convolution's output
    off = off.contiguous(memory_format=torch.channels_last)
    reset_launch_counts()
    got = deform_im2col(x, off, 3, stride, 1)
    assert deform_im2col.launches == 1
    want = deform_columns(x, off, 3, stride, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (n, C, H, W, stride, G, modulated, offset scale, channels-last)
    (3, 64, 13, 11, 1, 2, True, 1.5, True),       # v2, two groups
    (3, 24, 13, 11, 2, 1, False, 1.5, True),      # stride 2, C/G 24
    (2, 6, 5, 7, 2, 3, True, 1.5, False),         # NCHW, C/G 2, ragged
    (2, 32, 9, 7, 1, 1, False, 6.0, True),        # taps far past the edge
    (1, 33, 1, 1, 1, 1, True, 0.8, True),         # one pixel, C odd
    (2, 128, 8, 6, 2, 4, True, 1.5, True),        # v2, four groups
], ids=["v2_g2", "s2_c24", "nchw_g3", "far_offsets", "one_pixel",
        "v2_g4_s2"])
def test_k4_columns_bit_for_bit_at_edge_shapes(cuda, case):
    n, C, H, W, stride, G, mod, scale, cl = case
    x, off, mask = operands(n, C, H, W, stride, G, mod, cuda, scale,
                            seed=C + H, channels_last=cl)
    got = deform_im2col(x, off, 3, stride, 1, mask, G)
    assert torch.equal(got, deform_columns(x, off, 3, stride, 1, mask, G))


@pytest.mark.cuda
def test_k4_columns_at_integral_and_border_positions(cuda):
    """Offsets that land taps on whole pixels, on the last row and column,
    at -1 and at H and W exactly: each corner's own in-bounds test."""
    x, _, _ = operands(2, 32, 6, 5, 1, 1, False, cuda)
    vals = torch.tensor([0.0, 1.0, -1.0, 2.0, -2.0, 5.0, -6.0, 0.5, -0.5,
                         4.0 - 2 ** -20, 1e-7], device=cuda)
    idx = torch.randint(0, len(vals), (2, 18, 6, 5),
                        generator=torch.Generator().manual_seed(5))
    off = vals[idx.to(cuda)]
    got = deform_im2col(x, off, 3, 1, 1)
    assert torch.equal(got, deform_columns(x, off, 3, 1, 1))


def chunk_model(cuda):
    port, _ = models(config(small=False), cuda)
    return port.eval()


@pytest.mark.cuda
def test_fused_eval_chunk_launches_k4_and_never_the_eager_route(
        cuda, monkeypatch):
    port = chunk_model(cuda)
    x = crops(512, config(small=False), cuda)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, DeformConv2d):
                m.fused_eval = False
        eager = port(x)
        for m in port.modules():
            if isinstance(m, DeformConv2d):
                m.fused_eval = True

        def refuse(*a, **kw):
            raise AssertionError("the fused eval pass took the eager route")

        monkeypatch.setattr(deform_conv, "bilinear_taps", refuse)
        reset_launch_counts()
        got = port(x)
        torch.cuda.synchronize()
    assert deform_im2col.launches == 13
    # the columns are the eager route's bit for bit, the rest the same
    assert torch.equal(got, eager)


@pytest.mark.cuda
def test_fused_eval_chunk_launches_k5_twice_and_never_the_eager_duc(
        cuda, monkeypatch):
    """A fused eval pass of a chunk of 512 runs each DUC as one K5 launch
    (and one launch of its weights' split): no DUC's conv, BN or shuffle
    module runs."""
    port = chunk_model(cuda)
    x = crops(512, config(small=False), cuda)

    def refuse(*a, **kw):
        raise AssertionError("the fused eval pass took the eager DUC")

    for duc in (port.duc1, port.duc2):
        for m in (duc.conv, duc.bn, duc.relu, duc.pixel_shuffle):
            monkeypatch.setattr(m, "forward", refuse)
    reset_launch_counts()
    with torch.no_grad():
        hm = port(x)
        torch.cuda.synchronize()
    assert shuffle_conv3x3.launches == 2
    assert shuffle_conv3x3.split_launches == 2
    assert hm.shape == (512, 17, 64, 48) and torch.isfinite(hm).all()


@pytest.mark.cuda
def test_train_forward_takes_the_eager_route(cuda):
    port = chunk_model(cuda).train()
    x = crops(8, config(small=False), cuda)
    reset_launch_counts()
    port(x).sum().backward()
    torch.cuda.synchronize()
    assert deform_im2col.launches == 0
    assert shuffle_conv3x3.launches == 0
    assert port.preact.layer2[0].conv2.weight.grad is not None
