"""Layers of the plain reference models: torch's own Conv2d,
ConvTranspose2d, Linear, BatchNorm2d and LayerNorm, and an attention
product of plain `matmul` and `softmax`, in float32, with one switch per
layer instance for the control's lower precision.

`tf32 = True` on a layer emulates a TF32 tensor-core product: the inputs
of the product (activation and weight in the forward pass, the incoming
gradient in the backward pass; for attention both products' operands)
are rounded to TF32's 10-bit mantissa,
to nearest with ties away from zero as `cvt.rna.tf32.f32` does, and the
sums stay float32.  The emulation runs alike on the CPU and the card, so
the control reads the same on both.  The real TF32 flags of torch stay
off throughout.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["round_tf32", "Conv2d", "ConvTranspose2d", "Linear",
           "Attention", "BatchNorm2d", "LayerNorm", "set_tf32"]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as
    float32."""
    bits = t.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return (sign | (mag & ~0x1FFF)).view(torch.float32).view_as(t)


class _RoundBoth(torch.autograd.Function):
    """Rounded in the forward pass; its gradient rounded too."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class _RoundGrad(torch.autograd.Function):
    """Unchanged in the forward pass; its gradient rounded (the incoming
    gradient of a product's output feeds both backward products)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _product(layer, fn, x, w):
    if not getattr(layer, "tf32", False):
        return fn(x, w)
    return _RoundGrad.apply(fn(_RoundBoth.apply(x), _RoundBoth.apply(w)))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return _product(self, lambda a, w: self._conv_forward(a, w, self.bias),
                        x, self.weight)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return _product(self, lambda a, w: F.conv_transpose2d(
            a, w, self.bias, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation), x, self.weight)


class Linear(nn.Linear):
    def forward(self, x):
        return _product(self, lambda a, w: F.linear(a, w, self.bias),
                        x, self.weight)


_BLOCK = 512   # queries a block of `Attention`


class Attention(nn.Module):
    """softmax(q kᵀ / √dh) v over the last two dimensions, q (N, H, Lq, dh)
    and k, v (N, H, Lk, dh), by plain `matmul` and `softmax` (no fused
    kernel).  Queries go 512 at a time, so that under `no_grad`, as the
    score reference runs, one block's scores (N·H·512·Lk floats) are all
    that is held; under autograd every block's scores stay alive until
    the backward pass.  Each row's softmax is over all its keys, so the
    blocks give the whole product's rows.  No parameters."""

    def forward(self, q, k, v, /):
        scale = q.shape[-1] ** -0.5
        out = []
        for i in range(0, q.shape[-2], _BLOCK):
            s = _product(self, lambda a, b: a @ b.transpose(-2, -1),
                         q[..., i:i + _BLOCK, :], k)
            out.append(_product(self, torch.matmul,
                                torch.softmax(s * scale, dim=-1), v))
        return torch.cat(out, dim=-2)


def BatchNorm2d(ch: int) -> nn.BatchNorm2d:
    """The published BatchNorm: eps 1e-5, momentum 0.1."""
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def LayerNorm(d: int) -> nn.LayerNorm:
    """The published LayerNorm: eps 1e-5, a gain and a bias."""
    return nn.LayerNorm(d, eps=1e-5)


def set_tf32(model: nn.Module, on: bool = True) -> nn.Module:
    """Every product of `model` in emulated TF32 (on) or float32."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, Attention)):
            m.tf32 = on
    return model
