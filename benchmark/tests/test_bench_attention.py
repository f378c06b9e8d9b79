"""What a TransPose reference takes from the harness: the reference
attention product (benchmark/reference/layers.py) against torch's own,
its control in emulated TF32, its FLOPs in benchmark/flops.py, seeded
LayerNorm weights (benchmark/weights.py), on a post-norm encoder layer of
TransPose's widths (d 96, one head, an FFN of 192, 64x48 = 3,072
tokens), and the reference HRNet stopped after stage 3."""

import pytest
import torch
from torch import nn
from torch.nn import functional as F

from benchmark.flops import count_flops
from benchmark.reference.layers import (Attention, Conv2d, LayerNorm,
                                        Linear, round_tf32, set_tf32)
from benchmark.reference.models.PoseHighResolutionNet import \
    PoseHighResolutionNet
from benchmark.weights import make_weights


class EncoderLayer(nn.Module):
    """One post-norm transformer encoder layer with ReLU, as TransPose's:
    x = n1(x + attn(x)), x = n2(x + ffn(x)); x (N, L, d)."""

    def __init__(self, d=96, heads=1, ffn=192):
        super().__init__()
        self.heads = heads
        self.q, self.k, self.v, self.out = (Linear(d, d) for _ in range(4))
        self.attn = Attention()
        self.n1, self.n2 = LayerNorm(d), LayerNorm(d)
        self.fc1, self.fc2 = Linear(d, ffn), Linear(ffn, d)

    def forward(self, x):
        n, L, d = x.shape

        def split(t):
            return t.view(n, L, self.heads, d // self.heads).transpose(1, 2)
        a = self.attn(split(self.q(x)), split(self.k(x)), split(self.v(x)))
        x = self.n1(x + self.out(a.transpose(1, 2).reshape(n, L, d)))
        return self.n2(x + self.fc2(F.relu(self.fc1(x))))


def qkv(n, h, lq, lk, dh, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, h, lq, dh), generator=g, dtype=dtype),
            torch.randn((n, h, lk, dh), generator=g, dtype=dtype),
            torch.randn((n, h, lk, dh), generator=g, dtype=dtype))


def whole(q, k, v):
    """The product in one piece, every query at once."""
    s = q @ k.transpose(-2, -1) * q.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("lq", [45, 512, 600, 1024, 1100])
@pytest.mark.parametrize("heads", [1, 8])
def test_attention_equals_torch_sdpa(lq, heads):
    """float64, Lq != Lk; one block, one full block, and 2-3 blocks of
    512 queries that do and do not divide Lq: the blocked rows are the
    whole product's, to rounding (BLAS may take another kernel for a
    block of a few rows)."""
    q, k, v = qkv(2, heads, lq, 70, 16, seed=lq + heads)
    got = Attention()(q, k, v)
    torch.testing.assert_close(
        got, F.scaled_dot_product_attention(q, k, v), rtol=1e-12,
        atol=1e-12)
    torch.testing.assert_close(got, whole(q, k, v), rtol=0, atol=1e-15)


def hand_tf32(q, k, v, scale):
    s = round_tf32(q) @ round_tf32(k).transpose(-2, -1)
    return round_tf32(torch.softmax(s * scale, dim=-1)) @ round_tf32(v)


def test_tf32_rounds_both_products():
    """With `tf32` on, the output is exactly the hand-rounded
    computation (q, k, the probabilities and v on TF32's grid, float32
    sums), and not the float32 one."""
    q, k, v = qkv(2, 3, 40, 56, 32, dtype=torch.float32, seed=5)
    attn = Attention()
    f32 = attn(q, k, v)
    attn.tf32 = True
    got = attn(q, k, v)
    assert torch.equal(got, hand_tf32(q, k, v, 32 ** -0.5))
    assert not torch.equal(got, f32)
    assert (got - f32).abs().max() > 1e-5


def test_tf32_blocked_rounds_each_block_alike():
    """1,100 queries, three blocks: each block's rows are the whole
    hand-rounded product's."""
    q, k, v = qkv(1, 1, 1100, 20, 16, dtype=torch.float32, seed=6)
    attn = Attention()
    attn.tf32 = True
    torch.testing.assert_close(attn(q, k, v), hand_tf32(q, k, v, 0.25),
                               rtol=0, atol=1e-6)


def test_tf32_backward_rounds_the_incoming_gradients():
    """The gradient that reaches each product's output is rounded before
    it meets the product: v's gradient is round(round(p)ᵀ round(dO)),
    bit for bit, and not round(round(p)ᵀ dO); every input's gradient
    lies on TF32's grid."""
    q, k, v = (t.requires_grad_() for t in
               qkv(1, 2, 24, 24, 16, dtype=torch.float32, seed=7))
    dout = torch.randn((1, 2, 24, 16), generator=torch.Generator()
                       .manual_seed(8))
    attn = Attention()
    attn.tf32 = True
    attn(q, k, v).backward(dout)
    with torch.no_grad():
        p = round_tf32(torch.softmax(
            round_tf32(q) @ round_tf32(k).transpose(-2, -1) * 0.25, -1))
        want = round_tf32(p.transpose(-2, -1) @ round_tf32(dout))
        unrounded = round_tf32(p.transpose(-2, -1) @ dout)
    assert torch.equal(v.grad, want)
    assert not torch.equal(v.grad, unrounded)
    for t in (q, k, v):
        assert torch.equal(t.grad, round_tf32(t.grad))
    # with tf32 off the gradients are float32's own
    for t in (q, k, v):
        t.grad = None
    attn.tf32 = False
    attn(q, k, v).backward(dout)
    assert not torch.equal(q.grad, round_tf32(q.grad))


def test_set_tf32_switches_attention():
    torch.manual_seed(0)
    layer = EncoderLayer(d=32, ffn=64)
    x = torch.randn(2, 40, 32)
    f32 = layer(x)
    set_tf32(layer)
    assert layer.attn.tf32 and layer.q.tf32
    # the attention products alone rounded: apart from float32
    for m in (layer.q, layer.k, layer.v, layer.out, layer.fc1, layer.fc2):
        m.tf32 = False
    assert not torch.equal(layer(x), f32)
    set_tf32(layer, False)
    assert not layer.attn.tf32
    assert torch.equal(layer(x), f32)


def test_flops_of_one_encoder_layer_at_3072_tokens():
    """q, k, v and out 4·L·d², the FFN 2·L·d·2d (0.453 GFLOP), the two
    attention products 4·L²·d (3.624 GFLOP): 4.077 GFLOP; softmax, scale,
    LayerNorm and the sums are not counted."""
    L, d = 64 * 48, 96
    with torch.device("meta"):
        layer = EncoderLayer(d=d, ffn=2 * d)
    got = count_flops(layer, torch.empty((1, L, d), device="meta"))
    dense = 2 * (4 * L * d * d + 2 * L * d * 2 * d)
    attn = 4 * L * L * d
    assert got == dense + attn
    assert dense / 1e9 == pytest.approx(0.453, abs=5e-4)
    assert attn / 1e9 == pytest.approx(3.624, abs=5e-4)
    assert got / 1e9 == pytest.approx(4.077, abs=5e-4)


def test_flops_of_attention_count_every_head_and_sample():
    class Wrap(nn.Module):
        def __init__(self, k):
            super().__init__()
            self.attn, self.kv = Attention(), k

        def forward(self, q):
            return self.attn(q, self.kv, self.kv)

    q = torch.empty((3, 8, 1100, 16), device="meta")
    k = torch.empty((3, 8, 70, 16), device="meta")
    assert count_flops(Wrap(k), q) == 4 * 3 * 8 * 1100 * 70 * 16


def test_layernorm_leaves_are_seeded_in_range():
    with torch.device("meta"):
        layer = EncoderLayer()
    sd = make_weights(layer, 3000000123, 3, "cpu")
    assert set(sd) == set(layer.state_dict())
    for name in ("n1", "n2"):
        w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
        assert w.shape == b.shape == (96,)
        assert 0.5 <= w.min() and w.max() < 1.0
        assert 0.03 < b.std() < 0.3 and b.abs().max() < 1.0
    again = make_weights(layer, 3000000123, 3, "cpu")
    assert all(torch.equal(sd[n], again[n]) for n in sd)
    assert LayerNorm(96).eps == 1e-5


def test_an_unplanned_leaf_still_raises():
    class Bare(nn.Module):
        def __init__(self):
            super().__init__()
            self.n = LayerNorm(8)
            self.gain = nn.Parameter(torch.ones(8))

    with pytest.raises(ValueError, match="gain"):
        make_weights(Bare(), 1, 3, "cpu")


def w48_stages_2_3():
    """TransPose-H's backbone: HRNet-W48's stages 2 and 3."""
    return [dict(NUM_MODULES=1, NUM_BRANCHES=2, BLOCK="BASIC",
                 NUM_BLOCKS=[4, 4], NUM_CHANNELS=[48, 96]),
            dict(NUM_MODULES=4, NUM_BRANCHES=3, BLOCK="BASIC",
                 NUM_BLOCKS=[4, 4, 4], NUM_CHANNELS=[48, 96, 192])]


def test_hrnet_reference_stops_after_stage3_single_scale():
    """Stages as listed: no stage 4, the last stage-3 module returns the
    48-channel branch alone, and every leaf gets a seeded weight."""
    with torch.device("meta"):
        net = PoseHighResolutionNet(17, w48_stages_2_3())
    assert not hasattr(net, "stage4") and not hasattr(net, "transition3")
    assert [len(m.fuse_layers) for m in net.stage3] == [3, 3, 3, 1]
    x = torch.empty((2, 3, 256, 192), device="meta")
    assert net.features(x).shape == (2, 48, 64, 48)
    assert net(x).shape == (2, 17, 64, 48)
    sd = make_weights(net, 3000000123, 1, "cpu")
    assert set(sd) == set(net.state_dict())


def test_flops_of_transpose_h_a6_meet_the_paper():
    """The stage-3 backbone, a 1x1 48 -> 96, six encoder layers over
    3,072 tokens and a 1x1 to 17 heatmaps count within 3% of the
    paper's 21.8 G multiply-adds a sample at 256x192."""

    class TransPoseH(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = PoseHighResolutionNet(17, w48_stages_2_3())
            self.reduce = Conv2d(48, 96, 1, bias=False)
            self.layers = nn.ModuleList(EncoderLayer() for _ in range(6))
            self.head = Conv2d(96, 17, 1)

        def forward(self, x):
            f = self.reduce(self.backbone.features(x))
            n, d, h, w = f.shape
            t = f.flatten(2).transpose(1, 2)
            for layer in self.layers:
                t = layer(t)
            return self.head(t.transpose(1, 2).reshape(n, d, h, w))

    with torch.device("meta"):
        model = TransPoseH()
    got = count_flops(model, torch.empty((1, 3, 256, 192), device="meta"))
    assert got / 2 / 1e9 == pytest.approx(21.8, rel=0.03)
