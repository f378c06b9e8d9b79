"""The least time the card could take for each of the port's three
hand-written kernels, from their shapes: the larger of the operations over
the peak rate and the bytes over the HBM rate, every input byte read once
and every output byte written once.

K1 (the fused bottleneck chain, csrc/fused_bottleneck.cu): nb stride-1
bottlenecks of C channels, P inner, over an (N, H, W, C) stream,
F = 2 N H W (2 C P + 9 P^2) nb FLOPs; in bf16 over the tensor cores'
bf16 peak; in f32 over the lesser of F on the CUDA cores and 3F on TF32
(the kernel's three TF32 products); bytes: the stream read and written
once plus the folded weights, scales and biases.
K2 (the heatmap post-process, csrc/postprocess.cu): one read of the f32
heatmaps plus its outputs (coordinates, maxima, one value a sample).
K3 (the crop, csrc/rot_warp.cu): every output value written once, every
source pixel that a tap of nonzero weight reads, counted once over the
batch, the matrices and frame indices; about 20 flops a value on the
CUDA cores.
"""

from __future__ import annotations

from benchmark import chip

__all__ = ["resnet_tails", "k1_bound_s", "k2_bound_s", "k3_bound_s",
           "k3_source_bytes"]

BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet_tails(depth, input_hw):
    """(H, W, C, P, nb) of the four stages' tails (blocks 1..n-1), which
    the fused eval path runs through K1."""
    h, w = input_hw
    out = []
    for li, n in enumerate(BLOCKS[depth]):
        p = 64 * 2 ** li
        s = 4 * 2 ** li
        out.append((h // s, w // s, 4 * p, p, n - 1))
    return out


def k1_bound_s(n, tails, itemsize=4):
    """Seconds for the tails `tails` at batch `n` (itemsize 4: f32,
    2: bf16)."""
    total = 0.0
    for (H, W, C, P, nb) in tails:
        flops = 2.0 * n * H * W * (2 * C * P + 9 * P * P) * nb
        weights = nb * (C * P + 9 * P * P + P * C) * itemsize \
            + nb * (4 * P + 2 * C) * 4
        nbytes = 2 * n * H * W * C * itemsize + weights
        if itemsize == 4:
            t_ops = min(flops / chip.F32_FLOPS, 3 * flops / chip.TF32_FLOPS)
        else:
            t_ops = flops / chip.BF16_FLOPS
        total += max(t_ops, nbytes / chip.HBM_BYTES_PER_S)
    return total


def k2_bound_s(n, k, h, w):
    nbytes = n * k * h * w * 4 + n * k * 3 * 4 + n * 4
    return nbytes / chip.HBM_BYTES_PER_S


def k3_source_bytes(frames, frame_idx, mats, out_hw):
    """Bytes of the distinct source pixels that a tap of nonzero weight
    reads: frames (F, H, W, C) and the (N, 2, 3) dst->src affines, as torch
    tensors on one device."""
    import torch
    F_, H, W, C = frames.shape
    oh, ow = out_hw
    dev = frames.device
    gy, gx = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev),
                            indexing="ij")
    m = mats[..., None, None]
    sx = m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]
    sy = m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = sx - x0, sy - y0
    f = frame_idx.long()[:, None, None]
    touched = torch.zeros(F_ * H * W, dtype=torch.bool, device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            x, y = x0.long() + dx, y0.long() + dy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (wx * wy > 0)
            touched[((f * H + y) * W + x)[ok]] = True
    return int(touched.sum()) * C * frames.element_size()


def k3_bound_s(n, out_hw, source_bytes, out_itemsize=4):
    values = n * out_hw[0] * out_hw[1] * 3
    nbytes = source_bytes + values * out_itemsize + n * 6 * 4 + n * 8
    return max(nbytes / chip.HBM_BYTES_PER_S, values * 20.0 / chip.F32_FLOPS)
