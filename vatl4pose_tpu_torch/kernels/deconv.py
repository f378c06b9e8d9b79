"""SimplePose's deconvolution stage (models/simplepose.py: ConvTranspose2d
4x4, stride 2, padding 1, no bias; eval BatchNorm; ReLU) on an NHWC
stream: the wrapper of K6 (csrc/fused_bottleneck.cu's
subpixel_deconv4x4_kernel) and its plain PyTorch version.  The JAX
package has no kernel here (it leaves the head to XLA).

Such a transposed convolution is a sub-pixel convolution.  Output phase
(i, j) of input pixel (h, w), out[n, 2h + i, 2w + j], reads only the 2x2
input taps (h + dy, w + dx) with dy in {i - 1, i}, dx in {j - 1, j}, and
tap (dy, dx) uses the kernel element (1 + i - 2 dy, 1 + j - 2 dx)
(`phase_taps`).  With the BN folded to (s, b) by `fold_bn`:
  out[n, 2h + i, 2w + j, c] = relu(s[c] * sum over the 4 taps and ci of
      x[n, h + dy, w + dx, ci] * w[ci, c, 1 + i - 2 dy, 1 + j - 2 dx]
      + b[c])
for x (N, H, W, Cin), w (Cin, Cout, 4, 4) and out (N, 2H, 2W, Cout), f32.
Both versions compute each phase as its own 2x2 product over K = 4 Cin:
the kernel with column q * Cout + c holding channel c of phase q = 2i + j
(a column tile is one phase), the plain version as four 2x2 convolutions
of the padded input, so that the CPU tests reach the tap map and the
interleaved store.

The wrapper launches K6 for CUDA tensors (its weights laid out
(4 Cout, 4, Cin) and split into TF32 halves by `deconv_split`, one launch
of deconv4x4_split_kernel a call, counted in
`subpixel_deconv4x4.split_launches`; not cached, so that weights a
retrain updates are seen) and takes the plain version only for CPU
tensors; any other device raises, and so do CUDA operands the kernel
does not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_bottleneck import tf32_split

__all__ = ["phase_taps", "deconv_split", "subpixel_deconv4x4",
           "subpixel_deconv4x4_reference", "deconv_takes"]


def phase_taps(i: int, j: int):
    """The 4 taps of output phase (i, j), tap t = 2a + b in the kernel's
    K order: (dy, dx, ky, kx), the input pixel's offset (dy, dx) =
    (i - 1 + a, j - 1 + b) and the kernel element it meets."""
    out = []
    for a in (0, 1):
        for b in (0, 1):
            dy, dx = i - 1 + a, j - 1 + b
            out.append((dy, dx, 1 + i - 2 * dy, 1 + j - 2 * dx))
    return out


def _phase_weight(w, i, j):
    """(Cout, Cin, 2, 2): phase (i, j)'s kernel elements at its taps."""
    ky = [t[2] for t in phase_taps(i, j)[::2]]
    kx = [t[3] for t in phase_taps(i, j)[:2]]
    return w[:, :, ky][:, :, :, kx].permute(1, 0, 2, 3)


def deconv_takes(m) -> bool:
    """Whether K6 computes a transposed convolution of this shape: 4x4,
    stride 2, padding 1, no output padding, dilation 1, one group, no
    bias, Cin a multiple of 4 and Cout of 128."""
    return isinstance(m, torch.nn.ConvTranspose2d) \
        and m.kernel_size == (4, 4) and m.stride == (2, 2) \
        and m.padding == (1, 1) and m.output_padding == (0, 0) \
        and m.dilation == (1, 1) and m.groups == 1 and m.bias is None \
        and m.in_channels % 4 == 0 and m.out_channels % 128 == 0


def subpixel_deconv4x4_reference(x, w, s, b):
    """Plain PyTorch version: each phase (i, j) a 2x2 F.conv2d of the
    zero-padded input with `_phase_weight`, `* s + b`, ReLU, stored at
    (2h + i, 2w + j).  x (N, H, W, Cin) float; w (Cin, Cout, 4, 4);
    s, b (Cout,).  Returns (N, 2H, 2W, Cout), contiguous."""
    N, H, W, _ = x.shape
    cout = w.shape[1]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    out = x.new_empty((N, H, 2, W, 2, cout))
    for i in (0, 1):
        for j in (0, 1):
            y = F.conv2d(xp[:, :, i:i + H + 1, j:j + W + 1],
                         _phase_weight(w, i, j))
            y = torch.relu(y * s[:, None, None] + b[:, None, None])
            out[:, :, i, :, j] = y.permute(0, 2, 3, 1)
    return out.reshape(N, 2 * H, 2 * W, cout)


def deconv_split(w, s, b):
    """K6's B operand and epilogue constants: (w_hi, w_lo) (4 Cout, 4,
    Cin), row q * Cout + c holding `_phase_weight` of phase q = 2i + j for
    channel c at k = t * Cin + ci, split by `tf32_split`, and s, b
    repeated for each phase.  One launch of deconv4x4_split_kernel for
    CUDA tensors, the plain version for CPU tensors."""
    cin, cout = w.shape[:2]
    if w.device.type == "cpu":
        rows = torch.cat([_phase_weight(w, i, j).permute(0, 2, 3, 1)
                          .reshape(cout, 4, cin)
                          for i in (0, 1) for j in (0, 1)]).contiguous()
        hi, lo = tf32_split(rows)
        return hi, lo, s.repeat(4), b.repeat(4)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    outs = [torch.empty((4 * cout, 4, cin), dtype=torch.float32,
                        device=w.device) for _ in range(2)] \
        + [torch.empty(4 * cout, dtype=torch.float32, device=w.device)
           for _ in range(2)]
    lib = _build.load("fused_bottleneck")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.deconv4x4_split_f32(w.data_ptr(), s.data_ptr(),
                                      b.data_ptr(),
                                      *(o.data_ptr() for o in outs), cin,
                                      cout, stream)
    _build.check(err, "deconv_split")
    subpixel_deconv4x4.split_launches += 1
    return tuple(outs)


def _check_operands(x, w, s, b):
    if x.dim() != 4 or not x.is_contiguous() or x.dtype != torch.float32:
        raise ValueError("x must be a contiguous float32 (N, H, W, Cin) "
                         "tensor")
    N, H, W, cin = x.shape
    cout = w.shape[1]
    for t, shape in ((w, (cin, cout, 4, 4)), (s, (cout,)), (b, (cout,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"want contiguous float32 {shape} on {x.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    # 16-byte rows for TMA and the gather (Cin), a column tile inside one
    # phase (Cout), the producer's packed (h, w)
    if cin % 4 or cout % 128 or H >= 2 ** 15 or W >= 2 ** 15 \
            or N * H * W >= 2 ** 31:
        raise ValueError(f"K6 needs Cin % 4 == 0, Cout % 128 == 0, H and W "
                         f"under 32768 and N*H*W under 2**31, got "
                         f"{tuple(x.shape)} -> {cout}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    return N, H, W, cin, cout


def subpixel_deconv4x4(x, w, s, b):
    """A SimplePose deconvolution stage: ConvTranspose2d(4, 2, 1), folded
    BN, ReLU.  x (N, H, W, Cin) f32 -> (N, 2H, 2W, Cout) f32, contiguous.
    w: (Cin, Cout, 4, 4) as the module keeps it, s, b: (Cout,) folded BN
    (`fold_bn`), all f32."""
    if x.device.type == "cpu":
        return subpixel_deconv4x4_reference(x, w, s, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    N, H, W, cin, cout = _check_operands(x, w, s, b)
    w_hi, w_lo, sp, bp = deconv_split(w, s, b)
    out = torch.empty((N, 2 * H, 2 * W, cout), dtype=torch.float32,
                      device=x.device)
    lib = _build.load("fused_bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.subpixel_deconv4x4_f32(
            x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), sp.data_ptr(),
            bp.data_ptr(), out.data_ptr(), N, H, W, cin, cout, stream)
    _build.check(err, "subpixel_deconv4x4")
    subpixel_deconv4x4.launches += 1
    return out


subpixel_deconv4x4.launches = 0
subpixel_deconv4x4.split_launches = 0
