"""SimplePose's deconvolution head: K6 (kernels/deconv.py,
csrc/fused_bottleneck.cu's subpixel_deconv4x4_kernel) and its plain
version, against ConvTranspose2d(4, 2, 1) + eval BatchNorm + ReLU.

CPU: the plain version against the module stage in float64 and float32
at odd and even map sizes; each output phase against the transposed
convolution's strided outputs through `phase_taps`; the split's layout;
SimplePose's head with `fused_eval` on and off; which forward the serving
rule gives K6; the wrapper's refusals; K6's bound by hand.

Card (marker `cuda`, skipped without one): K6 against its plain version
at the benchmark cell's three stage shapes at N = 512; K6's distance from
a float64 stage against cuDNN f32's, on the cell's seeded weights; edge
shapes; the split kernel bit for bit its plain version; the launch
counters; SimplePose's heatmaps through K6 against the module graph; K5's
outputs bit for bit as the parent of K6's change made them
(tests/data/k5_digests.json, written from `scripts/simplepose_probe.py
k5`).  The file imports neither JAX nor the JAX package, so on a machine
with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deconv.py -m cuda
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import deconv_bounds
from benchmark.flops import count_flops
from benchmark.weights import estimator_weights
from vatl4pose_tpu_torch.kernels import (fold_bn_module, reset_launch_counts,
                                         subpixel_deconv4x4,
                                         subpixel_deconv4x4_reference,
                                         tf32_split)
from vatl4pose_tpu_torch.kernels.deconv import (_check_operands,
                                                deconv_split, deconv_takes,
                                                phase_taps)
from vatl4pose_tpu_torch.models import simplepose
from vatl4pose_tpu_torch.models.simplepose import SimplePose

REPO = Path(__file__).resolve().parent.parent
CFG = json.loads((REPO / "benchmark" / "configs"
                  / "simplepose_r50.json").read_text())
# (Cin, Cout, H, W) of the cell's three stages at their input size
STAGES = [(2048, 256, 8, 6), (256, 256, 16, 12), (256, 256, 32, 24)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage(cin, cout, seed, dtype=torch.float32, device="cpu"):
    """ConvTranspose2d(4, 2, 1) with He-scaled weights and an eval BN with
    random statistics."""
    g = torch.Generator().manual_seed(seed)
    conv = torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
    bn = torch.nn.BatchNorm2d(cout)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                          * (2.0 / (4 * cin)) ** 0.5)
        bn.weight.copy_(torch.rand(cout, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(cout, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(cout, generator=g) + 0.5)
    return conv.to(device, dtype).eval(), bn.to(device, dtype).eval()


def stream(n, cin, h, w, seed, dtype=torch.float32, device="cpu"):
    """A post-ReLU NCHW stream, channels-last as the backbone leaves it."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cin, h, w), generator=g).relu() \
        .to(device, dtype).contiguous(memory_format=torch.channels_last)


def module_stage(conv, bn, x):
    """The module graph's stage, NHWC."""
    return torch.relu(bn(conv(x))).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [
    # (N, Cin, Cout, H, W)
    (2, 4, 128, 3, 5),      # odd H and W, one 16-byte row of channels
    (1, 64, 256, 4, 6),     # even
    (2, 36, 128, 5, 2),     # Cin not a multiple of 32
    (1, 512, 256, 2, 3),    # R18's first stage's width
], ids=["cin4", "cin64", "cin36", "cin512"])
def test_plain_version_equals_the_module_stage(one_thread, shape, dtype,
                                               tol):
    """The plain version (four 2x2 convolutions of the padded input, the
    folded BN, the interleaved store) against ConvTranspose2d -> BN ->
    ReLU: equal to f64 rounding in float64; in float32 oneDNN sums in
    another order and the BN runs folded, 1e-5 of the largest value."""
    n, cin, cout, h, w = shape
    conv, bn = stage(cin, cout, seed=cin + cout, dtype=dtype)
    x = stream(n, cin, h, w, seed=h + w, dtype=dtype)
    # fold_bn's arithmetic in the stage's dtype (fold_bn itself is f32)
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    b = bn.bias - bn.running_mean * s
    with torch.no_grad():
        want = module_stage(conv, bn, x)
        got = subpixel_deconv4x4_reference(
            x.permute(0, 2, 3, 1).contiguous(), conv.weight, s, b)
    assert got.shape == (n, 2 * h, 2 * w, cout) and got.is_contiguous()
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("phase", [(0, 0), (0, 1), (1, 0), (1, 1)],
                         ids=["p00", "p01", "p10", "p11"])
def test_each_phase_is_the_transposed_convolutions_strided_outputs(phase):
    """out[:, :, 2h + i, 2w + j] of ConvTranspose2d(4, 2, 1) is the sum
    over phase (i, j)'s four taps (dy, dx, ky, kx) of x[h + dy, w + dx]
    (zero outside) times w[:, :, ky, kx], in float64."""
    i, j = phase
    g = torch.Generator().manual_seed(7)
    n, cin, cout, h, w = 2, 3, 5, 4, 3
    x = torch.randn((n, cin, h, w), generator=g, dtype=torch.float64)
    wt = torch.randn((cin, cout, 4, 4), generator=g, dtype=torch.float64)
    full = torch.nn.functional.conv_transpose2d(x, wt, stride=2, padding=1)
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    taps = phase_taps(i, j)
    assert [(dy - i + 1, dx - j + 1) for dy, dx, _, _ in taps] \
        == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want = sum(torch.einsum("nchw,cd->ndhw",
                            xp[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w],
                            wt[:, :, ky, kx])
               for dy, dx, ky, kx in taps)
    assert torch.allclose(full[:, :, i::2, j::2], want, rtol=0, atol=1e-12)


def test_split_lays_out_each_phase_k_major():
    """deconv_split's plain version: row q * Cout + c of (4 Cout, 4, Cin)
    holds w[ci, c, ky, kx] of phase q's tap t at k = t * Cin + ci, hi + lo
    its TF32 split; s and b repeated for each phase."""
    g = torch.Generator().manual_seed(4)
    cin, cout = 12, 16
    w = torch.randn((cin, cout, 4, 4), generator=g)
    s, b = torch.rand(cout, generator=g), torch.randn(cout, generator=g)
    hi, lo, sp, bp = deconv_split(w, s, b)
    assert hi.shape == lo.shape == (4 * cout, 4, cin)
    for q in range(4):
        for t, (_, _, ky, kx) in enumerate(phase_taps(q // 2, q % 2)):
            want_hi, want_lo = tf32_split(w[:, :, ky, kx].t().contiguous())
            assert torch.equal(hi[q * cout:(q + 1) * cout, t], want_hi)
            assert torch.equal(lo[q * cout:(q + 1) * cout, t], want_lo)
    assert torch.equal(sp, s.repeat(4)) and torch.equal(bp, b.repeat(4))


def small_simplepose(fused_eval=True):
    """R18 at 64x64 with a head of 128-wide deconvolutions (K6 takes
    them: Cin 512 and 128, Cout 128), He-scaled."""
    m = SimplePose(num_joints=5, num_layers=18, deconv_dim=(128, 128, 128),
                   fused_eval=fused_eval, device="cpu")
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / p[0].numel()) ** 0.5)
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_var.uniform_(0.5, 1.5, generator=g)
                mod.running_mean.normal_(0, 0.1, generator=g)
    return m.eval()


def test_head_with_fused_eval_on_and_off(one_thread, monkeypatch):
    """SimplePose's forward with fused_eval (the head through K6's plain
    version here: three calls) against the module graph: the same
    heatmaps to f32 rounding, 1e-5 of the largest; the same state_dict
    keys, `deconv_layers.{0,1,3,4,6,7}` among them."""
    calls = []

    def counted(*a):
        calls.append(a[0].shape)
        return subpixel_deconv4x4(*a)
    monkeypatch.setattr(simplepose, "subpixel_deconv4x4", counted)
    fused, plain = small_simplepose(True), small_simplepose(False)
    plain.load_state_dict(fused.state_dict())
    assert list(fused.state_dict()) == list(plain.state_dict())
    assert {f"deconv_layers.{i}.weight" for i in (0, 1, 3, 4, 6, 7)} \
        <= set(fused.state_dict())
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert [tuple(c) for c in calls] == [(2, 2, 2, 512), (2, 4, 4, 128),
                                         (2, 8, 8, 128)]
    assert got.shape == want.shape == (2, 5, 16, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


BYPASS_CASES = {
    "served": ("eval", torch.float32, False, True, None),
    "train_mode": ("train", torch.float32, False, True, None),
    "gradient": ("eval", torch.float32, True, True, None),
    "bf16": ("eval", torch.bfloat16, False, True, None),
    "fused_eval_off": ("eval", torch.float32, False, False, None),
    "output_padding": ("eval", torch.float32, False, True,
                       dict(output_padding=1)),
    "kernel_3": ("eval", torch.float32, False, True,
                 dict(kernel_size=3, padding=1, output_padding=1)),
    "bias": ("eval", torch.float32, False, True, dict(bias=True)),
}


@pytest.mark.parametrize("case", list(BYPASS_CASES))
def test_serving_rule_gives_k6_only_served_forwards(one_thread, monkeypatch,
                                                    case):
    """kernels/serving.py's rule with K6's shape condition: only an eval
    forward in f32 that asks for no gradient, with fused_eval, through a
    head of 4x4/2/1 transposed convolutions without bias, takes K6 (three
    calls); every other runs the module graph (three ConvTranspose2d
    calls)."""
    mode, dtype, autograd, fused_eval, other = BYPASS_CASES[case]
    m = small_simplepose(fused_eval)
    if other is not None:
        kw = dict(kernel_size=4, stride=2, padding=1, bias=False)
        kw.update(other)
        m.deconv_layers[3] = torch.nn.ConvTranspose2d(128, 128, **kw)
        assert not deconv_takes(m.deconv_layers[3])
    m = m.to(dtype).train(mode == "train")
    calls = {"k6": 0, "graph": 0}

    def k6(*a):
        calls["k6"] += 1
        return subpixel_deconv4x4(*a)
    monkeypatch.setattr(simplepose, "subpixel_deconv4x4", k6)
    for conv in m.deconv_layers[0::3]:
        fwd = conv.forward

        def graph(*a, fwd=fwd):
            calls["graph"] += 1
            return fwd(*a)
        monkeypatch.setattr(conv, "forward", graph)
    x = torch.randn((1, 3, 64, 64)).to(dtype)
    with torch.set_grad_enabled(autograd):
        hm = m(x)
    assert hm.dtype == dtype and torch.isfinite(hm).all()
    want = (3, 0) if case == "served" else (0, 3)
    assert (calls["k6"], calls["graph"]) == want


@pytest.mark.parametrize("case", [
    # (x shape, Cout, what is wrong)
    ((2, 4, 4, 6), 128, "Cin not a multiple of 4"),
    ((2, 4, 4, 8), 64, "Cout not a multiple of 128"),
    ((2, 4, 40000, 8), 128, "W past the packed column"),
], ids=["cin6", "cout64", "wide"])
def test_wrapper_refuses_what_k6_cannot_take(case):
    shape, cout, _ = case
    x = torch.zeros(shape)
    w = torch.zeros((shape[-1], cout, 4, 4))
    with pytest.raises(ValueError):
        _check_operands(x, w, torch.zeros(cout), torch.zeros(cout))


def test_wrapper_refuses_operands_of_another_layout():
    x = torch.zeros((2, 4, 4, 8))
    w = torch.zeros((8, 128, 4, 4))
    s = torch.zeros(128)
    with pytest.raises(ValueError):
        _check_operands(x.permute(0, 2, 1, 3), w, s, s)
    with pytest.raises(ValueError):
        _check_operands(x, w.double(), s, s)
    with pytest.raises(ValueError):
        _check_operands(x, w.permute(1, 0, 2, 3), s, s)


def test_k6_bound_by_hand():
    """benchmark/deconv_bounds.py at the configuration, by hand: the
    three stages are 2 N H W Cin Cout 16 = 0.412, 0.206 and 0.825 TFLOP
    at a chunk of 512, each bound by three TF32 products (8.75 ms in all)
    and not by its bytes; their FLOPs a sample are benchmark/flops.py's
    count of the head's three ConvTranspose2d."""
    layers = deconv_bounds.deconv_layers(CFG)
    assert layers == STAGES
    total = 0.0
    for cin, cout, h, w in layers:
        flops = 2.0 * 512 * h * w * cin * cout * 16
        nbytes = 4 * (512 * h * w * (cin + 4 * cout) + cin * cout * 16
                      + 2 * cout)
        assert nbytes / 3.35e12 < 3 * flops / 495e12
        assert deconv_bounds.k6_bound_s(512, [(cin, cout, h, w)]) \
            == pytest.approx(3 * flops / 495e12)
        total += flops
    assert total / 1e12 == pytest.approx(0.412 + 0.206 + 0.825, abs=2e-3)
    assert deconv_bounds.k6_bound_s(512, layers) * 1e3 == pytest.approx(
        8.746, abs=1e-3)
    with torch.device("meta"):
        convs = torch.nn.Sequential(*[
            torch.nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)
            for cin, cout, _, _ in layers])
    x = torch.empty((1, 2048, 8, 6), device="meta")
    assert count_flops(convs, x) == pytest.approx(total / 512)
    for name in ("hrnet_w32", "fastpose_dcn_r50"):
        other = json.loads((REPO / "benchmark" / "configs"
                            / f"{name}.json").read_text())
        assert deconv_bounds.deconv_layers(other) == []


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def cell_head(seed, device):
    """The cell's three (ConvTranspose2d, BN) stages with its seeded
    weights (benchmark/weights.py, stream 1 of `seed`)."""
    sd = estimator_weights(CFG, seed, device)
    out = []
    for i, (cin, cout, _, _) in enumerate(STAGES):
        conv, bn = stage(cin, cout, seed=0, device=device)
        conv.weight.data.copy_(sd[f"deconv_layers.{3 * i}.weight"])
        bn.load_state_dict({k[len(f"deconv_layers.{3 * i + 1}."):]: v
                            for k, v in sd.items()
                            if k.startswith(f"deconv_layers.{3 * i + 1}.")})
        out.append((conv, bn))
    return out


def stage_f64(conv, bn, x):
    """A stage in float64 (on the card: exact enough, and a CPU float64
    pass of a chunk takes minutes), NHWC."""
    y = torch.nn.functional.conv_transpose2d(
        x.double(), conv.weight.double(), stride=2, padding=1)
    s = bn.weight.double() * torch.rsqrt(bn.running_var.double() + bn.eps)
    b = bn.bias.double() - bn.running_mean.double() * s
    return torch.relu(y * s[:, None, None] + b[:, None, None]) \
        .permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000011, 2718281829])
def test_k6_at_the_cell_no_further_from_f64_than_cudnn(cuda, seed):
    """At each of the cell's three stages at N = 512, on its seeded
    weights and a post-ReLU stream handed on by the module graph: K6
    within 1e-5 of its plain version (the max), and K6's max|err|/max
    from the float64 stage no larger than the module graph's in f32
    (cuDNN's dgrad engine, TF32 off); a launch of K6 and of its split a
    call."""
    x = stream(512, 2048, 8, 6, seed=seed % 1000, device=cuda)
    with torch.no_grad():
        for i, (conv, bn) in enumerate(cell_head(seed, cuda)):
            s, b = fold_bn_module(bn)
            xs = x.permute(0, 2, 3, 1).contiguous()
            reset_launch_counts()
            got = subpixel_deconv4x4(xs, conv.weight, s, b)
            assert (subpixel_deconv4x4.launches,
                    subpixel_deconv4x4.split_launches) == (1, 1)
            plain = subpixel_deconv4x4_reference(xs, conv.weight, s, b)
            graph = module_stage(conv, bn, x)
            exact = stage_f64(conv, bn, x)
            scale = exact.abs().max().item()
            assert (got - plain).abs().max().item() <= 1e-5 * scale
            d = {k: (v.double() - exact).abs().max().item() / scale
                 for k, v in (("K6", got), ("cuDNN", graph))}
            print(f"stage {i + 1}: max|err|/max from f64 {d}")
            assert d["K6"] <= d["cuDNN"], (i + 1, d)
            x = graph.permute(0, 3, 1, 2)
            del got, plain, exact
            torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (N, H, W, Cin, Cout)
    (2, 1, 37, 64, 128),     # H = 1: the rows above and below are padding
    (2, 29, 1, 64, 128),     # W = 1
    (1, 5, 6, 4, 128),       # M = 30 rows, one K step of 4 channels
    (3, 7, 5, 36, 256),      # ragged K steps, odd sides
    (2, 9, 11, 520, 384),    # three column tiles a phase
], ids=["h1", "w1", "m30", "cin36", "cin520"])
def test_k6_at_edge_shapes(cuda, case):
    n, h, w, cin, cout = case
    conv, bn = stage(cin, cout, seed=cin + cout, device=cuda)
    x = stream(n, cin, h, w, seed=h + w, device=cuda)
    with torch.no_grad():
        got = subpixel_deconv4x4(x.permute(0, 2, 3, 1).contiguous(),
                                 conv.weight, *fold_bn_module(bn))
        want = module_stage(conv, bn, x)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(36, 128), (2048, 256), (256, 256)])
def test_split_kernel_equals_its_plain_version(cuda, shape):
    cin, cout = shape
    g = torch.Generator().manual_seed(cin)
    w = torch.randn((cin, cout, 4, 4), generator=g)
    # ties of the TF32 rounding and values already TF32
    w.view(-1)[:64] = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, 0.5,
                                    -1 - 2 ** -11] * 16)
    s, b = torch.rand(cout, generator=g), torch.randn(cout, generator=g)
    want = deconv_split(w, s, b)
    got = deconv_split(w.to(cuda), s.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert torch.equal(a.cpu(), e)


@pytest.mark.cuda
def test_simplepose_heatmaps_through_k6(cuda):
    """The cell's model (R50, 256x192, seeded weights) on 37 random crops:
    the fused eval forward launches K6 three times (and its split three
    times) and its heatmaps meet the module graph's (fused_eval off:
    cuDNN everywhere) within 1e-4 of the largest; K1 serves the tails
    in both the served and the plain route's backbone."""
    from vatl4pose_tpu_torch.models import build_sppe
    m = build_sppe(CFG["MODEL"], CFG["DATA_PRESET"], fused_eval=True,
                   device=cuda)
    m.load_state_dict(estimator_weights(CFG, 3000000011, cuda))
    m.eval()
    x = torch.randn((37, 3, 256, 192), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    with torch.no_grad():
        reset_launch_counts()
        got = m(x)
        assert (subpixel_deconv4x4.launches,
                subpixel_deconv4x4.split_launches) == (3, 3)
        m.fused_eval = False
        want = m(x)
        assert subpixel_deconv4x4.launches == 3
    assert got.shape == want.shape == (37, 17, 64, 48)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_k5_outputs_bit_for_bit_as_kept(cuda):
    """K5 shares its body with K6: its outputs at FastPose's two DUC
    shapes at N = 512 hash to the digests its source made before K6
    (tests/data/k5_digests.json)."""
    import sys
    sys.path.insert(0, str(REPO))
    from scripts.simplepose_probe import k5_digests
    kept = json.loads((REPO / "tests" / "data" / "k5_digests.json")
                      .read_text())["digests"]
    assert k5_digests() == kept


@pytest.mark.cuda
def test_k6_refuses_a_misaligned_stream(cuda):
    flat = torch.zeros(2 * 4 * 4 * 8 + 1, device=cuda)
    x = flat[1:].view(2, 4, 4, 8)
    w = torch.zeros((8, 128, 4, 4), device=cuda)
    s = torch.zeros(128, device=cuda)
    with pytest.raises(ValueError):
        subpixel_deconv4x4(x, w, s, s)
