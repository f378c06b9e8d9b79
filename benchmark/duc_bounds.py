"""The least time the card could take for K5 (csrc/fused_bottleneck.cu's
shuffle_conv3x3_kernel) over the two DUC convolutions of a FastPose
configuration's head: for each, the larger of the bytes over the HBM rate
and the operations over the lesser of the f32 CUDA-core time and three
TF32 tensor-core products' time (the kernel's 3xTF32 arithmetic, as
benchmark/bounds.py counts K1's f32 products).

Shapes (AlphaPose's FastPose): the backbone's stride-32 feature of 2048
channels, PixelShuffle(2), DUC(512 -> 1024) at stride 16, its shuffle,
DUC(256 -> 512, or 1024 for CONV_DIM 256) at stride 8.  F = 2 N Cin 9
Cout H W a DUC; bytes: its input read once, its shuffled output written
once, the f32 weights and the folded scale and bias read once.
"""

from __future__ import annotations

from benchmark import chip

__all__ = ["duc_convs", "k5_bound_s"]


def duc_convs(cfg):
    """(Cin, Cout, H, W) of the DUC convolutions of `cfg`'s model, in
    forward order; none for a model without a DUC head."""
    model = cfg["MODEL"]
    if model.get("TYPE") != "FastPose":
        return []
    h, w = cfg["DATA_PRESET"]["IMAGE_SIZE"]
    cout2 = 1024 if model.get("CONV_DIM", 128) == 256 else 512
    return [(512, 1024, h // 16, w // 16), (256, cout2, h // 8, w // 8)]


def k5_bound_s(n, convs):
    """Seconds for the convolutions `convs` at batch `n`."""
    total = 0.0
    for cin, cout, H, W in convs:
        flops = 2.0 * n * cin * 9 * cout * H * W
        nbytes = 4 * (n * H * W * (cin + cout) + cout * cin * 9 + 2 * cout)
        t_ops = min(flops / chip.F32_FLOPS, 3 * flops / chip.TF32_FLOPS)
        total += max(t_ops, nbytes / chip.HBM_BYTES_PER_S)
    return total
