"""SimplePose (SimpleBaseline) in PyTorch (counterpart of vatl4pose_tpu/
models/simplepose.py; alphapose/models/simplepose.py:12-91): ResNet
backbone, three (ConvTranspose 4x4/2 + BN + ReLU) stages, a 1x1 conv to K
joint heatmaps.  Module names follow the reference (`preact`,
`deconv_layers.{0,1,3,4,6,7}`, `final_layer`)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from .layers import batchnorm, conv_transpose
from .resnet import RESNET_SPECS, ResNet

__all__ = ["SimplePose"]


class SimplePose(nn.Module):
    def __init__(self, num_joints: int = 17, num_layers: int = 50,
                 deconv_dim: Sequence[int] = (256, 256, 256),
                 fused_eval: bool = False, device=None):
        super().__init__()
        self.preact = ResNet(num_layers, fused_eval=fused_eval, device="cpu")
        in_ch = 2048 if RESNET_SPECS[num_layers][0] == "bottleneck" else 512
        mods = []
        for d in deconv_dim:
            mods += [conv_transpose(in_ch, d), batchnorm(d),
                     nn.ReLU(inplace=True)]
            in_ch = d
        self.deconv_layers = nn.Sequential(*mods)
        self.final_layer = nn.Conv2d(deconv_dim[2], num_joints, 1)
        self.to(resolve_device(device))

    def forward(self, x, return_embedding: bool = False):
        """x: (N, 3, H, W).  Returns heatmaps (N, K, H/4, W/4) and, when
        asked, the GAP embedding of the same backbone pass (N, 2048)."""
        feat = self.preact(x.contiguous(memory_format=torch.channels_last))
        hm = self.final_layer(self.deconv_layers(feat))
        if return_embedding:
            return hm, feat.mean(dim=(2, 3))
        return hm
