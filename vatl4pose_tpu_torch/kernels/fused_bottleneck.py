"""Fused ResNet bottleneck chain (counterpart of vatl4pose_tpu/kernels/
fused_bottleneck.py): the wrapper of the CUDA kernel csrc/
fused_bottleneck.cu, its plain PyTorch version and `fold_bn`.

`nb` stride-1, non-downsampling bottlenecks over an NHWC stream with
eval-mode BatchNorm folded into a per-channel scale and bias:
  s = gamma / sqrt(var + eps),  b = beta - mean * s.
Each block is conv1x1·s+b, ReLU; conv3x3·s+b, ReLU; conv1x1·s+b,
+ identity, ReLU; f32 accumulation, every epilogue in f32, then a cast back
to the stream dtype.  Used by models/resnet.py when `fused_eval=True`.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fold_bn", "fused_bottleneck_chain", "bottleneck_chain_reference"]


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm as per-channel (s, b): y = x*s + b (f32)."""
    scale, bias, mean, var = (t.to(torch.float32)
                              for t in (scale, bias, mean, var))
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


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
    lib = _build.load("fused_bottleneck")
    fn = (lib.fused_bottleneck_chain_f32 if x.dtype == torch.float32
          else lib.fused_bottleneck_chain_bf16)
    out = torch.empty_like(x)
    y1 = torch.empty((N, H, W, P), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), y1.data_ptr(), y2.data_ptr(),
                 *(w.data_ptr() for w in ws), N, H, W, C, P, nb, stream)
    _build.check(err, "fused_bottleneck_chain")
    fused_bottleneck_chain.launches += 1
    return out


fused_bottleneck_chain.launches = 0
