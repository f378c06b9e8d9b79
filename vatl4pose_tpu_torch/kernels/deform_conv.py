"""Deformable convolution v1 and v2 (counterpart of vatl4pose_tpu/
kernels/deform_conv.py, which has no Pallas kernel): the wrapper of the
CUDA kernel csrc/deform_im2col.cu (K4) and the eager PyTorch route.

Replaces the reference's CUDA extension (dcn/src/deform_conv_cuda.cpp):
each output location samples its K*K taps bilinearly at learned offsets
(deformable im2col), then one dense product with the kernel
(`torch.bmm` of the columns read transposed and the kernel, in both
routes, so that the output is channels-last like the rest of the port's
stream).  The layout is the CUDA kernel's, as the JAX package keeps it:
the offsets hold (dy, dx) interleaved per tap, channel
((g*K*K + k)*2 + {0: dy, 1: dx}) for deform group g and tap
k = ky*K + kx; `modulated=True` (DCNv2) adds G*K*K sigmoid masks after
the offsets.  A tap outside the image reads 0, each of the four bilinear
corners masked by its own in-bounds test, not by grid_sample's padding
modes.  Tensors are NCHW at the boundary, any memory format.

Two routes to the columns (N, Cin*K*K, Ho*Wo):
  eager   `deform_columns`: four gathers (`bilinear_taps`), each followed
          by its in-bounds mask, its weight and a sum; autograd gives the
          backward.  `deform_conv2d` (the JAX package's signature) always
          takes it, and so does every forward of `DeformConv2d` that
          kernels/serving.py's rule does not serve: training, a forward
          that asks for a gradient, a bf16 stream (the AL CLI's
          --speedup).
  K4      `deform_im2col`: one launch writes the columns, reading the
          channels-last stream, the offsets and the mask through their
          strides, in the eager route's f32 arithmetic and order, so its
          columns are the eager route's bit for bit.  `DeformConv2d`
          takes it on a forward that the rule serves (`fused_eval`, eval
          mode, f32, no gradient asked for).  FastPose's DCN stages
          (AlphaPose's Fast Pose (DCN)) score through it.
The wrapper launches the kernel for CUDA tensors and takes the eager
columns only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.profiling import span
from . import _build
from .serving import F32, takes_kernel

__all__ = ["bilinear_taps", "deform_columns", "deform_im2col",
           "deform_conv2d", "DeformConv2d"]

_INT_MAX = 2 ** 31 - 1


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


def _out_size(H, W, K, stride, padding):
    return ((H + 2 * padding - K) // stride + 1,
            (W + 2 * padding - K) // stride + 1)


def deform_columns(x, offset, K: int, stride: int = 1, padding: int = 1,
                   mask=None, deform_groups: int = 1):
    """The eager route's columns.  x (N, Cin, H, W); offset (N, 2*G*K*K,
    Ho, Wo) in the interleaved (dy, dx) layout; mask: None or the sigmoided
    (N, G*K*K, Ho, Wo).  Returns (N, Cin*K*K, Ho*Wo), rows (cin, ky, kx)."""
    N, Cin, H, W = x.shape
    Ho, Wo = _out_size(H, W, K, stride, padding)
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
    # (N*G, Cin/G, K*K*Ho*Wo) -> (N, Cin*K*K, Ho*Wo)
    return cols.reshape(N, Cin * K * K, Ho * Wo)


def _strides(t, what):
    if any(s > _INT_MAX for s in t.stride()):
        raise ValueError(f"{what}'s strides {t.stride()} exceed the "
                         "kernel's 32-bit range")
    return t.stride()


def deform_im2col(x, offset, K: int, stride: int = 1, padding: int = 1,
                  mask=None, deform_groups: int = 1):
    """K4: the columns of `deform_columns` in one launch, for f32 CUDA
    tensors of any strides (CPU tensors take `deform_columns`)."""
    if x.device.type == "cpu":
        return deform_columns(x, offset, K, stride, padding, mask,
                              deform_groups)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    N, Cin, H, W = x.shape
    Ho, Wo = _out_size(H, W, K, stride, padding)
    G = deform_groups
    ts = (x, offset) + (() if mask is None else (mask,))
    if any(t.dtype != torch.float32 or t.device != x.device for t in ts):
        raise ValueError("x, offset and mask must be float32 tensors on "
                         "one device")
    if Cin % G or offset.shape != (N, 2 * G * K * K, Ho, Wo) or (
            mask is not None and mask.shape != (N, G * K * K, Ho, Wo)):
        raise ValueError(f"offset {tuple(offset.shape)} / mask do not fit "
                         f"x {tuple(x.shape)} with K={K}, G={G}")
    xs = _strides(x, "x")
    if (Cin - 1) * xs[1] + (H - 1) * xs[2] + (W - 1) * xs[3] > _INT_MAX:
        raise ValueError("a sample of x exceeds the kernel's 32-bit range")
    lib = _build.load("deform_im2col")
    cols = torch.empty((N, Cin * K * K, Ho * Wo), dtype=torch.float32,
                       device=x.device)
    os_ = _strides(offset, "offset")
    ms = (0, 0, 0, 0) if mask is None else _strides(mask, "mask")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.deform_im2col_f32(
            x.data_ptr(), *xs, offset.data_ptr(), *os_,
            None if mask is None else mask.data_ptr(), *ms, cols.data_ptr(),
            N, Cin, H, W, Ho, Wo, K, stride, padding, G, stream)
    _build.check(err, "deform_im2col")
    deform_im2col.launches += 1
    return cols


deform_im2col.launches = 0


def _conv(columns, x, offset, weight, stride, padding, mask, deform_groups):
    """The columns by `columns` (`deform_columns` or `deform_im2col`), then
    the product with the kernel."""
    N, _, H, W = x.shape
    Cout, _, K, _ = weight.shape
    Ho, Wo = _out_size(H, W, K, stride, padding)
    cols = columns(x, offset, K, stride, padding, mask, deform_groups)
    # the product with the columns read transposed lands channels-last,
    # as the port's stream is: (N, Ho*Wo, Cout) = cols^T w^T; bmm takes
    # both operands transposed as they lie (matmul would fold N into the
    # rows of a copy of the columns)
    w = weight.reshape(Cout, -1).t()
    out = torch.bmm(cols.transpose(1, 2), w.expand(N, *w.shape))
    return out.view(N, Ho, Wo, Cout).permute(0, 3, 1, 2)


def deform_conv2d(x, offset, weight, stride: int = 1, padding: int = 1,
                  mask=None, deform_groups: int = 1):
    """x (N, Cin, H, W); offset (N, 2*G*K*K, Ho, Wo) in the interleaved
    (dy, dx) layout; weight (Cout, Cin, K, K); mask: None or the sigmoided
    (N, G*K*K, Ho, Wo).  Returns (N, Cout, Ho, Wo), channels-last in
    memory, from the eager columns."""
    return _conv(deform_columns, x, offset, weight, stride, padding, mask,
                 deform_groups)


class DeformConv2d(nn.Module):
    """dcn/deform_conv.py's DeformConv / ModulatedDeformConv without
    bias: the offset (and mask) conv lives in the caller
    (Bottleneck.conv2_offset), as in the reference's layout.  With
    `fused_eval`, a forward that the serving rule serves takes K4 (see the
    module's docstring)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 deform_groups: int = 1, modulated: bool = False,
                 fused_eval: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.deform_groups, self.modulated = deform_groups, modulated
        self.fused_eval = fused_eval
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")

    def forward(self, x, offset_and_mask):
        with span("dcn.conv"):
            n_off = 2 * self.deform_groups * self.weight.shape[-1] ** 2
            mask = None
            if self.modulated:
                mask = torch.sigmoid(offset_and_mask[:, n_off:])
            columns = deform_im2col \
                if takes_kernel(self, F32, x, offset_and_mask) \
                else deform_columns
            return _conv(columns, x, offset_and_mask[:, :n_off],
                         self.weight, self.stride, self.padding, mask,
                         self.deform_groups)
