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
        # the reference's head init (simplepose.py _initialize; the JAX
        # package's normal(0.001) kernels): trained from scratch with
        # torch's default init instead, the maps collapse to zero and stay
        for m in (*self.deconv_layers, self.final_layer):
            if isinstance(m, (nn.ConvTranspose2d, nn.Conv2d)):
                nn.init.normal_(m.weight, std=0.001)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, model_cfg, preset_cfg, fused_eval=False, device=None):
        """The reference's MODEL keys: NUM_LAYERS, NUM_DECONV_FILTERS."""
        return cls(num_joints=preset_cfg["NUM_JOINTS"],
                   num_layers=model_cfg.get("NUM_LAYERS", 50),
                   deconv_dim=tuple(model_cfg.get("NUM_DECONV_FILTERS",
                                                  (256, 256, 256))),
                   fused_eval=fused_eval, device=device)

    def backbone(self, x):
        """x: (N, 3, H, W) -> the stride-32 feature (N, 2048, H/32, W/32),
        channels-last; with fused_eval the bottleneck tails run through
        the chain kernel."""
        return self.preact(x.contiguous(memory_format=torch.channels_last))

    def head(self, feat):
        """The backbone feature -> heatmaps (N, K, H/4, W/4)."""
        return self.final_layer(self.deconv_layers(feat))

    def forward(self, x, return_embedding: bool = False):
        """x: (N, 3, H, W).  Returns heatmaps (N, K, H/4, W/4) and, when
        asked, the GAP embedding of the same backbone pass (N, 2048)."""
        feat = self.backbone(x)
        hm = self.head(feat)
        if return_embedding:
            return hm, feat.mean(dim=(2, 3))
        return hm
