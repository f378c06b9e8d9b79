"""Deformable convolution v1 and v2 in eager PyTorch (counterpart of
vatl4pose_tpu/kernels/deform_conv.py, which has no Pallas kernel).

Replaces the reference's CUDA extension (dcn/src/deform_conv_cuda.cpp):
each output location samples its K*K taps bilinearly at learned offsets
(deformable im2col), then one dense product with the kernel.  Autograd
gives the backward.  The layout is the CUDA kernel's, as the JAX package
keeps it: the offsets hold (dy, dx) interleaved per tap,
channel ((g*K*K + k)*2 + {0: dy, 1: dx}) for deform group g and tap
k = ky*K + kx; `modulated=True` (DCNv2) adds G*K*K sigmoid masks after
the offsets.  A tap outside the image reads 0, each of the four bilinear
corners masked by its own in-bounds test, not by grid_sample's padding
modes.  Tensors are NCHW.  No shipped config enables DCN; a hand kernel
waits for a profile that asks for one (ROADMAP queue B).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["bilinear_taps", "deform_conv2d", "DeformConv2d"]


def bilinear_taps(img, ys, xs):
    """img (B, C, H, W); ys, xs (B, L) sample positions in pixels.
    Returns (B, C, L): the bilinear samples, each corner zero where it
    lies outside the image."""
    B, C, H, W = img.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    flat = img.reshape(B, C, H * W)
    out = 0
    for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                      (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        v = torch.gather(flat, 2, idx[:, None, :].expand(B, C, -1))
        out = out + v * inb[:, None, :] * w[:, None, :]
    return out


def deform_conv2d(x, offset, weight, stride: int = 1, padding: int = 1,
                  mask=None, deform_groups: int = 1):
    """x (N, Cin, H, W); offset (N, 2*G*K*K, Ho, Wo) in the interleaved
    (dy, dx) layout; weight (Cout, Cin, K, K); mask: None or the sigmoided
    (N, G*K*K, Ho, Wo).  Returns (N, Cout, Ho, Wo)."""
    N, Cin, H, W = x.shape
    Cout, _, K, _ = weight.shape
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    G = deform_groups
    dev = x.device
    k = torch.arange(K * K, device=dev)
    base_y = (torch.arange(Ho, device=dev) * stride - padding)[None, :, None] \
        + (k // K)[:, None, None]
    base_x = (torch.arange(Wo, device=dev) * stride - padding)[None, None, :] \
        + (k % K)[:, None, None]
    off = offset.reshape(N, G, K * K, 2, Ho, Wo)
    ys = base_y + off[:, :, :, 0]                  # (N, G, K*K, Ho, Wo)
    xs = base_x + off[:, :, :, 1]
    cols = bilinear_taps(x.reshape(N * G, Cin // G, H, W),
                         ys.reshape(N * G, -1), xs.reshape(N * G, -1))
    if mask is not None:
        cols = cols * mask.reshape(N * G, 1, -1)
    # (N*G, Cin/G, K*K*Ho*Wo) -> (N, Cin*K*K, Ho*Wo), rows (cin, ky, kx)
    cols = cols.reshape(N, Cin * K * K, Ho * Wo)
    out = torch.matmul(weight.reshape(Cout, -1), cols)
    return out.reshape(N, Cout, Ho, Wo)


class DeformConv2d(nn.Module):
    """dcn/deform_conv.py's DeformConv / ModulatedDeformConv without
    bias: the offset (and mask) conv lives in the caller
    (Bottleneck.conv2_offset), as in the reference's layout."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 deform_groups: int = 1, modulated: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.deform_groups, self.modulated = deform_groups, modulated
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")

    def forward(self, x, offset_and_mask):
        n_off = 2 * self.deform_groups * self.weight.shape[-1] ** 2
        mask = None
        if self.modulated:
            mask = torch.sigmoid(offset_and_mask[:, n_off:])
        return deform_conv2d(x, offset_and_mask[:, :n_off], self.weight,
                             self.stride, self.padding, mask,
                             self.deform_groups)
