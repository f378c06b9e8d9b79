"""Fused ResNet bottleneck chain (counterpart of vatl4pose_tpu/kernels/
fused_bottleneck.py): the wrapper of the CUDA kernel csrc/
fused_bottleneck.cu, its plain PyTorch version, `fold_bn` and
`fold_bn_module`.

`nb` stride-1, non-downsampling bottlenecks over an NHWC stream with
eval-mode BatchNorm folded into a per-channel scale and bias:
  s = gamma / sqrt(var + eps),  b = beta - mean * s.
Each block is conv1x1·s+b, ReLU; conv3x3·s+b, ReLU; conv1x1·s+b,
+ identity, ReLU; f32 accumulation, every epilogue in f32, then a cast back
to the stream dtype.  Used by models/resnet.py on the forwards that
kernels/serving.py's rule gives the kernel.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises, and so do CUDA
operands the kernel does not take (C or P not a multiple of 8: its TMA
rows need 16-byte strides).  In f32 the kernel takes its weights K-major
and split into TF32 halves (3xTF32), which `k_major_split` makes in one
launch of the same source's k_major_split_kernel a call
(`fused_bottleneck_chain.split_launches` counts them); `tf32_split` is its
plain version.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from . import _build

_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}

__all__ = ["fold_bn", "fold_bn_module", "fused_bottleneck_chain",
           "bottleneck_chain_reference", "tf32_split", "k_major_split"]


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel (s, b): y = x*s + b (f32)."""
    scale, bias, mean, var = (t.to(torch.float32)
                              for t in (scale, bias, mean, var))
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def fold_bn_module(bn):
    """`fold_bn` of a BatchNorm module's affine, running statistics and
    eps."""
    return fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                   bn.eps)


def bottleneck_chain_reference(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """Plain PyTorch version of the same folded math: F.conv2d on
    channels-last f32 copies of the operands (exact products of bf16
    values, f32 accumulation), the cast back to the stream dtype after each
    epilogue.  x: (N, H, W, C); returns (N, H, W, C) in x's dtype."""
    dt = x.dtype
    f32 = torch.float32
    nb = w1.shape[0]
    cur = x.permute(0, 3, 1, 2)                           # NCHW view
    for i in range(nb):
        k1 = w1[i].to(f32).t()[:, :, None, None]          # (P, C, 1, 1)
        k2 = w2[i].to(f32).permute(3, 2, 0, 1)            # (P, P, 3, 3)
        k3 = w3[i].to(f32).t()[:, :, None, None]          # (C, P, 1, 1)
        h = F.conv2d(cur.to(f32), k1)
        h = torch.relu(h * s1[i][:, None, None] + b1[i][:, None, None]).to(dt)
        h = F.conv2d(h.to(f32), k2, padding=1)
        h = torch.relu(h * s2[i][:, None, None] + b2[i][:, None, None]).to(dt)
        h = F.conv2d(h.to(f32), k3)
        cur = torch.relu(h * s3[i][:, None, None] + b3[i][:, None, None]
                         + cur.to(f32)).to(dt)
    return cur.permute(0, 2, 3, 1).contiguous()


def _check_operands(x, ws):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (N, H, W, C) tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stream dtype {x.dtype} is not float32 or bfloat16")
    N, H, W, C = x.shape
    nb, _, P = ws[0].shape
    shapes = [(nb, C, P), (nb, P), (nb, P), (nb, 3, 3, P, P), (nb, P),
              (nb, P), (nb, P, C), (nb, C), (nb, C)]
    for i, (w, shape) in enumerate(zip(ws, shapes)):
        want = x.dtype if i in (0, 3, 6) else torch.float32
        if tuple(w.shape) != shape or w.dtype != want \
                or w.device != x.device or not w.is_contiguous():
            raise ValueError(f"operand {i}: want contiguous {shape} {want} on "
                             f"{x.device}, got {tuple(w.shape)} {w.dtype} on "
                             f"{w.device}")
    return N, H, W, C, P, nb


def _k_major(w1, w2, w3):
    """The kernel's B operands, K contiguous: w1t (nb, P, C), w2t
    (nb, P, 9, P) with k = tap * P + ci, w3t (nb, C, P)."""
    nb, _, _, P, _ = w2.shape
    return (w1.transpose(1, 2).contiguous(),
            w2.permute(0, 4, 1, 2, 3).reshape(nb, P, 9, P).contiguous(),
            w3.transpose(1, 2).contiguous())


def tf32_split(w):
    """(hi, lo) of a float32 tensor as the kernel's `split` makes them with
    cvt.rna.tf32.f32: hi = w rounded to nearest, ties away from zero, on its
    13 low mantissa bits (subnormals too; past the largest TF32 value it
    rounds to infinity), lo = the same rounding of w - hi."""
    def rna(v):
        bits = v.view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
        return (mag | (bits & ~0x7FFFFFFF)).view(torch.float32)
    hi = rna(w)
    return hi, rna(w - hi)


def k_major_split(w1, w2, w3):
    """The f32 kernel's B operands: `_k_major`'s three layouts, each split
    by `tf32_split`: (w1t_hi, w1t_lo, w2t_hi, w2t_lo, w3t_hi, w3t_lo).  One
    launch of k_major_split_kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if w1.device.type == "cpu":
        return tuple(half for w in _k_major(w1, w2, w3)
                     for half in tf32_split(w))
    if w1.device.type != "cuda":
        raise ValueError(f"no kernel for device {w1.device}")
    nb, C, P = w1.shape
    for w, shape in ((w1, (nb, C, P)), (w2, (nb, 3, 3, P, P)),
                     (w3, (nb, P, C))):
        if tuple(w.shape) != shape or w.dtype != torch.float32 \
                or w.device != w1.device or not w.is_contiguous():
            raise ValueError(f"want contiguous float32 {shape} on "
                             f"{w1.device}, got {tuple(w.shape)} {w.dtype} "
                             f"on {w.device}")
    outs = [torch.empty(shape, dtype=torch.float32, device=w1.device)
            for shape in ((nb, P, C),) * 2 + ((nb, P, 9, P),) * 2
            + ((nb, C, P),) * 2]
    lib = _build.load("fused_bottleneck")
    with torch.cuda.device(w1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.k_major_split_f32(
            w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            *(o.data_ptr() for o in outs), C, P, nb, stream)
    _build.check(err, "k_major_split")
    fused_bottleneck_chain.split_launches += 1
    return tuple(outs)


def fused_bottleneck_chain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """Run nb chained bottlenecks over x: (N, H, W, C) float32 or bf16.

    w1: (nb, C, P); w2: (nb, 3, 3, P, P); w3: (nb, P, C) in x's dtype;
    s1/b1/s2/b2: (nb, P) and s3/b3: (nb, C) folded BN in f32.
    """
    ws = (w1, s1, b1, w2, s2, b2, w3, s3, b3)
    if x.device.type == "cpu":
        return bottleneck_chain_reference(x, *ws)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    N, H, W, C, P, nb = _check_operands(x, ws)
    if C % 8 or P % 8:
        raise ValueError(f"the chain kernel needs C and P to be multiples "
                         f"of 8, got C={C}, P={P}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    lib = _build.load("fused_bottleneck")
    if x.dtype == torch.float32:
        w1h, w1l, w2h, w2l, w3h, w3l = k_major_split(w1, w2, w3)
        fn, wts = lib.fused_bottleneck_chain_f32, (
            w1h, w1l, s1, b1, w2h, w2l, s2, b2, w3h, w3l, s3, b3)
    else:
        w1t, w2t, w3t = _k_major(w1, w2, w3)
        fn, wts = lib.fused_bottleneck_chain_bf16, (
            w1t, s1, b1, w2t, s2, b2, w3t, s3, b3)
    out = torch.empty_like(x)
    y1 = torch.empty((N, H, W, P), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                 *(w.data_ptr() for w in wts), N, H, W, C, P, nb, stream)
    _build.check(err, "fused_bottleneck_chain")
    fused_bottleneck_chain.launches += 1
    fused_bottleneck_chain.launches_by_dtype[_DTYPE[x.dtype]] += 1
    return out


fused_bottleneck_chain.launches = 0
fused_bottleneck_chain.launches_by_dtype = Counter()
fused_bottleneck_chain.split_launches = 0
