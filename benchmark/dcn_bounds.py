"""The least time the card could take for the deformable im2col kernel K4
(csrc/deform_im2col.cu) over a configuration's deformable 3x3s: the
larger of the bytes over the HBM rate and the operations over the f32
rate of the CUDA cores.

Bytes: the columns (N, C*9, Ho*Wo) f32 written once, the input stream
(N, C, H, W) and the offsets (N, 18*G, Ho, Wo), with DCNv2's mask (N, 9*G,
Ho, Wo), read once.  Operations: 12 a column value (four corners, each a
product by its in-bounds bit, one by its weight and a sum), 13 with the
mask.
"""

from __future__ import annotations

from benchmark import chip
from benchmark.bounds import BLOCKS

__all__ = ["dcn_convs", "k4_bytes", "k4_bound_s"]

K = 3


def dcn_convs(cfg):
    """(C, H, W, Ho, Wo, stride, G, modulated) of every deformable 3x3 of
    `cfg`'s ResNet backbone, in forward order: every block of a stage that
    STAGE_WITH_DCN flags, the strided first block's included (AlphaPose's
    FALLBACK_ON_STRIDE false)."""
    model = cfg["MODEL"]
    dcn = model.get("DCN")
    if not dcn:
        return []
    flags = model.get("STAGE_WITH_DCN", [False] * 4)
    g, mod = dcn.get("DEFORM_GROUP", 1), bool(dcn.get("MODULATED", False))
    h, w = cfg["DATA_PRESET"]["IMAGE_SIZE"]
    out = []
    for li, n in enumerate(BLOCKS[model.get("NUM_LAYERS", 50)]):
        if not flags[li]:
            continue
        p, s = 64 * 2 ** li, 4 * 2 ** li
        for b in range(n):
            stride = 2 if b == 0 and li > 0 else 1
            out.append((p, h // (s // stride), w // (s // stride), h // s,
                        w // s, stride, g, mod))
    return out


def k4_bytes(n, conv):
    C, H, W, Ho, Wo, _, G, mod = conv
    cols = n * C * K * K * Ho * Wo
    offsets = n * (3 if mod else 2) * G * K * K * Ho * Wo
    return 4 * (cols + n * C * H * W + offsets)


def k4_bound_s(n, convs):
    """Seconds for the convolutions `convs` at batch `n`."""
    total = 0.0
    for conv in convs:
        C, _, _, Ho, Wo, _, _, mod = conv
        flops = n * C * K * K * Ho * Wo * (13 if mod else 12)
        total += max(k4_bytes(n, conv) / chip.HBM_BYTES_PER_S,
                     flops / chip.F32_FLOPS)
    return total
