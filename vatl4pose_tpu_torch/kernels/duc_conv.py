"""The DUC convolution of FastPose's head (models/layers.py `DUC`: 3x3
conv, eval BatchNorm, ReLU, PixelShuffle(2)) on an NHWC stream: the
wrapper of K5 (csrc/fused_bottleneck.cu's shuffle_conv3x3_kernel) and
its plain PyTorch version.  The JAX package has no kernel here (it leaves
DUC to XLA).

With the BN folded to (s, b) by `fold_bn`:
  out[n, 2h + i, 2w + j, c] = relu(conv3x3(x, w)[n, h, w, 4c + 2i + j]
                                   * s[4c + 2i + j] + b[4c + 2i + j])
for x (N, H, W, Cin) and out (N, 2H, 2W, Cout / 4), f32.  Both versions
compute it in the column order `shuffle_order` gives (column
q * Cout / 4 + c holds channel 4c + q, q = 2i + j): the kernel so that a
column tile is one sub-pixel of contiguous channels, the plain version so
that the CPU tests reach the permutation and the shuffled store.

The wrapper launches K5 for CUDA tensors (its weights laid out K-major,
permuted and split into TF32 halves by `shuffle_split`, one launch of
shuffle_split_kernel a call, counted in `shuffle_conv3x3.split_launches`;
not cached, so that weights a retrain updates are seen) and takes the
plain version only for CPU tensors; any other device raises, and so do
CUDA operands the kernel does not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_bottleneck import tf32_split

__all__ = ["shuffle_order", "shuffle_split", "shuffle_conv3x3",
           "shuffle_conv3x3_reference"]


def shuffle_order(cout: int, device=None):
    """The channel of each of K5's columns: column q * cout/4 + c holds
    channel 4c + q."""
    n = torch.arange(cout, device=device)
    c4 = cout // 4
    return 4 * (n % c4) + n // c4


def _unshuffle(y, H, W):
    """(N, Cout, H, W) in the column order -> (N, 2H, 2W, Cout / 4):
    column (2i + j) * C4 + c of pixel (h, w) to (2h + i, 2w + j, c)."""
    N, cout = y.shape[:2]
    return y.reshape(N, 2, 2, cout // 4, H, W).permute(0, 4, 1, 5, 2, 3) \
        .reshape(N, 2 * H, 2 * W, cout // 4)


def shuffle_conv3x3_reference(x, w, s, b):
    """Plain PyTorch version: F.conv2d with the weights in the column
    order, `* s + b`, ReLU, then the shuffled store.  x (N, H, W, Cin)
    f32; w (Cout, Cin, 3, 3); s, b (Cout,).  Returns (N, 2H, 2W, Cout/4),
    contiguous."""
    N, H, W, _ = x.shape
    order = shuffle_order(w.shape[0], w.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), w[order], padding=1)
    y = torch.relu(y * s[order][:, None, None] + b[order][:, None, None])
    return _unshuffle(y, H, W).contiguous()


def shuffle_split(w, s, b):
    """K5's B operand and epilogue constants: (w_hi, w_lo) (Cout, 9, Cin)
    with k = tap * Cin + ci, rows in `shuffle_order`, split by
    `tf32_split`, and s, b in the same order.  One launch of
    shuffle_split_kernel for CUDA tensors, the plain version for CPU
    tensors."""
    cout, cin = w.shape[:2]
    if w.device.type == "cpu":
        order = shuffle_order(cout)
        hi, lo = tf32_split(w[order].permute(0, 2, 3, 1)
                            .reshape(cout, 9, cin).contiguous())
        return hi, lo, s[order], b[order]
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    outs = [torch.empty((cout, 9, cin), dtype=torch.float32, device=w.device)
            for _ in range(2)] + [torch.empty(cout, dtype=torch.float32,
                                              device=w.device)
                                  for _ in range(2)]
    lib = _build.load("fused_bottleneck")
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.shuffle_split_f32(w.data_ptr(), s.data_ptr(), b.data_ptr(),
                                    *(o.data_ptr() for o in outs), cin, cout,
                                    stream)
    _build.check(err, "shuffle_split")
    shuffle_conv3x3.split_launches += 1
    return tuple(outs)


def _check_operands(x, w, s, b):
    if x.dim() != 4 or not x.is_contiguous() or x.dtype != torch.float32:
        raise ValueError("x must be a contiguous float32 (N, H, W, Cin) "
                         "tensor")
    N, H, W, cin = x.shape
    cout = w.shape[0]
    for t, shape in ((w, (cout, cin, 3, 3)), (s, (cout,)), (b, (cout,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"want contiguous float32 {shape} on {x.device},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    # 16-byte rows for TMA and the gather (Cin), whole 16-byte stores of
    # one sub-pixel (Cout / 4), the producer's packed (h, w)
    if cin % 4 or cout % 16 or H >= 2 ** 15 or W >= 2 ** 15 \
            or N * H * W >= 2 ** 31:
        raise ValueError(f"K5 needs Cin % 4 == 0, Cout % 16 == 0, H and W "
                         f"under 32768 and N*H*W under 2**31, got "
                         f"{tuple(x.shape)} -> {cout}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    return N, H, W, cin, cout


def shuffle_conv3x3(x, w, s, b):
    """DUC's conv, folded BN, ReLU and PixelShuffle(2): x (N, H, W, Cin)
    f32 -> (N, 2H, 2W, Cout / 4) f32, contiguous.  w: (Cout, Cin, 3, 3),
    s, b: (Cout,) folded BN (`fold_bn`), all f32."""
    if x.device.type == "cpu":
        return shuffle_conv3x3_reference(x, w, s, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    N, H, W, cin, cout = _check_operands(x, w, s, b)
    w_hi, w_lo, sp, bp = shuffle_split(w, s, b)
    out = torch.empty((N, 2 * H, 2 * W, cout // 4), dtype=torch.float32,
                      device=x.device)
    lib = _build.load("fused_bottleneck")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.shuffle_conv3x3_f32(
            x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), sp.data_ptr(),
            bp.data_ptr(), out.data_ptr(), N, H, W, cin, cout, stream)
    _build.check(err, "shuffle_conv3x3")
    shuffle_conv3x3.launches += 1
    return out


shuffle_conv3x3.launches = 0
shuffle_conv3x3.split_launches = 0
