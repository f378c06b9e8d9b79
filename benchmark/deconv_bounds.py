"""The least time the card could take for K6 (csrc/fused_bottleneck.cu's
subpixel_deconv4x4_kernel) over the deconvolution stages of a
SimplePose configuration's head: for each, the larger of the bytes over
the HBM rate and the operations over the lesser of the f32 CUDA-core time
and three TF32 tensor-core products' time (the kernel's 3xTF32
arithmetic, as benchmark/duc_bounds.py counts K5's).

Shapes (SimpleBaseline): the backbone's stride-32 feature (2048 channels
after a ResNet of bottlenecks, 512 after one of basic blocks), then one
ConvTranspose2d(4, stride 2, padding 1) a width of NUM_DECONV_FILTERS,
each doubling the map.  F = 2 N H W Cin Cout 16 a stage at input size
H x W, as benchmark/flops.py counts a transposed convolution (every
input value meets Cout x 4 x 4 weights); bytes: its input read once, its
output written once, the f32 weights and the folded scale and bias read
once.
"""

from __future__ import annotations

from benchmark import chip

__all__ = ["deconv_layers", "k6_bound_s"]

BASIC_BLOCK_DEPTHS = (18, 34)


def deconv_layers(cfg):
    """(Cin, Cout, H, W) of the deconvolution stages of `cfg`'s model at
    their input size, in forward order; none for a model without a
    SimplePose head."""
    model = cfg["MODEL"]
    if model.get("TYPE") != "SimplePose":
        return []
    cin = 512 if model.get("NUM_LAYERS", 50) in BASIC_BLOCK_DEPTHS else 2048
    h, w = cfg["DATA_PRESET"]["IMAGE_SIZE"]
    h, w = h // 32, w // 32
    out = []
    for cout in model.get("NUM_DECONV_FILTERS", (256, 256, 256)):
        out.append((cin, cout, h, w))
        cin, h, w = cout, 2 * h, 2 * w
    return out


def k6_bound_s(n, layers):
    """Seconds for the stages `layers` at batch `n`."""
    total = 0.0
    for cin, cout, H, W in layers:
        flops = 2.0 * n * H * W * cin * cout * 16
        nbytes = 4 * (n * H * W * (cin + 4 * cout) + cin * cout * 16
                      + 2 * cout)
        t_ops = min(flops / chip.F32_FLOPS, 3 * flops / chip.TF32_FLOPS)
        total += max(t_ops, nbytes / chip.HBM_BYTES_PER_S)
    return total
