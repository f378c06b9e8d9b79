"""Forward FLOPs of one sample through a configuration's estimator,
counted from its layer shapes: the plain reference model is run on the
meta device (shapes only, no arithmetic) at the configuration's input
size, and every convolution, transposed convolution and linear layer adds
2 FLOPs per multiply-add, as does each attention call's two products, q kᵀ
and the probabilities times v (4·N·H·Lq·Lk·dh FLOPs).  Normalisation
(attention's softmax and scale with it), activations, pooling and sums
are left out (under 1% of a ResNet-50's or an HRNet-W32's)."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.layers import Attention
from benchmark.reference.models import build_estimator

__all__ = ["layer_macs", "attention_macs", "count_flops", "forward_flops"]


def layer_macs(module, x, y) -> int:
    """Multiply-adds of one call of `module` from input `x` to output
    `y`, per the whole batch."""
    if isinstance(module, nn.Conv2d):
        k = module.weight.shape[1] * module.weight.shape[2] \
            * module.weight.shape[3]
        return y.numel() * k
    if isinstance(module, nn.ConvTranspose2d):
        # every input value meets out_channels x kh x kw weights
        return x.numel() * module.weight.shape[1] * module.weight.shape[2] \
            * module.weight.shape[3] // module.groups
    if isinstance(module, nn.Linear):
        return y.numel() * module.in_features
    return 0


def attention_macs(q, k) -> int:
    """Multiply-adds of one attention call on queries `q` (N, H, Lq, dh)
    and keys `k` (N, H, Lk, dh): q kᵀ, then the probabilities times v (of
    width dh), N·H·Lq·Lk·dh each."""
    return 2 * q.numel() * k.shape[-2]


def count_flops(model, x) -> float:
    """FLOPs of one call `model(x)` (2 a multiply-add of its
    convolutions, transposed convolutions, linear layers and attention
    products)."""
    total = [0]

    def hook(m, inp, out):
        total[0] += attention_macs(inp[0], inp[1]) \
            if isinstance(m, Attention) else layer_macs(m, inp[0], out)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                                 Attention))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return 2.0 * total[0]


def forward_flops(cfg) -> float:
    """FLOPs of one sample's forward pass of `cfg`'s estimator."""
    with torch.device("meta"):
        model = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"]).eval()
    h, w = cfg["DATA_PRESET"]["IMAGE_SIZE"]
    return count_flops(model, torch.empty((1, 3, h, w), device="meta"))
