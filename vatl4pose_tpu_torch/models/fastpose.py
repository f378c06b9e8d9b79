"""FastPose in PyTorch (counterpart of vatl4pose_tpu/models/fastpose.py;
alphapose/models/fastpose.py:14-73): an SE-ResNet (`preact`, optional DCN
stages), PixelShuffle(2) (`suffle1`, the reference's spelling), DUC(512 ->
1024), DUC(256 -> 512, or 1024 for CONV_DIM 256) and a 3x3 `conv_out` to
K heatmaps.  With `fused_eval=True` in eval mode the SE-ResNet's stage
tails (plain bottlenecks: SE sits on each stage's block 0) run through
the chain kernel K1, as SimplePose's do, the deformable 3x3s of DCN
stages (AlphaPose's Fast Pose (DCN): stages 2-4) take their columns from
the deformable im2col kernel K4, and each DUC is one launch of K5 (3x3
conv, folded BN, ReLU and the shuffle), the first reading `suffle1`'s
output made channels-last, the second the first's NHWC output."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from .layers import DUC
from .resnet import ResNet

__all__ = ["FastPose"]


class FastPose(nn.Module):
    def __init__(self, num_joints: int = 17, num_layers: int = 50,
                 conv_dim: int = 128, dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 fused_eval: bool = False, device=None):
        super().__init__()
        self.preact = ResNet(num_layers, fused_eval=fused_eval, use_se=True,
                             dcn=dcn, stage_with_dcn=stage_with_dcn,
                             device="cpu")
        self.suffle1 = nn.PixelShuffle(2)
        self.duc1 = DUC(512, 1024, fused_eval=fused_eval)
        self.duc2 = DUC(256, 1024 if conv_dim == 256 else 512,
                        fused_eval=fused_eval)
        self.conv_out = nn.Conv2d(conv_dim, num_joints, 3, 1, 1)
        nn.init.normal_(self.conv_out.weight, std=0.001)
        nn.init.zeros_(self.conv_out.bias)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, model_cfg, preset_cfg, fused_eval=False, device=None):
        """The reference's MODEL keys: NUM_LAYERS, CONV_DIM, DCN,
        STAGE_WITH_DCN."""
        return cls(num_joints=preset_cfg["NUM_JOINTS"],
                   num_layers=model_cfg.get("NUM_LAYERS", 50),
                   conv_dim=model_cfg.get("CONV_DIM", 128),
                   dcn=dict(model_cfg["DCN"]) if "DCN" in model_cfg
                   else None,
                   stage_with_dcn=tuple(model_cfg.get("STAGE_WITH_DCN",
                                                      (False,) * 4)),
                   fused_eval=fused_eval, device=device)

    def backbone(self, x):
        """x: (N, 3, H, W) -> the stride-32 feature (N, 2048, H/32, W/32),
        channels-last."""
        return self.preact(x.contiguous(memory_format=torch.channels_last))

    def head(self, feat):
        """The backbone feature -> heatmaps (N, K, H/4, W/4).  `conv_out`
        reads NCHW: K5's output is channels-last, and there cuDNN takes an
        NHWC engine 2.7 times slower for the 17 output channels."""
        y = self.duc2(self.duc1(self.suffle1(feat)))
        return self.conv_out(y.contiguous())

    def forward(self, x, return_embedding: bool = False):
        """Heatmaps and, when asked, the GAP embedding of the same
        backbone pass (N, 2048)."""
        feat = self.backbone(x)
        hm = self.head(feat)
        if return_embedding:
            return hm, feat.mean(dim=(2, 3))
        return hm

    def get_embedding(self, x):
        return self.backbone(x).mean(dim=(2, 3))
