"""PoseHighResolutionNet (HRNet) in PyTorch (counterpart of
vatl4pose_tpu/models/hrnet.py; alphapose/models/hrnet.py:25-494), with the
reference's module names: the stem `conv1`/`bn1`/`conv2`/`bn2`, `layer1`
(4 Bottlenecks), `transition{1,2,3}` (ModuleLists holding None where a
branch passes through), `stage{2,3,4}.m.branches.i.b`,
`stage{2,3,4}.m.fuse_layers.i.j.{0,1}` (1x1 conv, BN and nearest
upsampling of a lower-resolution branch) and `.fuse_layers.i.j.k.{0,1}`
(the strided 3x3 chains of a higher-resolution one), `final_layer`.

Fusion sums branch j = 0..nb-1 in order into output i, then the ReLU;
stage 4's last module returns the highest-resolution branch only.  Every
conv starts from normal(0.001) and zero bias, as the reference's
_initialize does (hrnet.py:457-472): with PyTorch's default init the
branch sums start a from-scratch HRNet at about N(0, 6) heatmaps.  The
embedding (absent from the reference, added by the JAX package) is the
GAP of the highest-resolution stage-4 feature, zero-padded to 2048.
HRNet has no chain-kernel path: the JAX builder ignores `fused_eval` for
it, so its pass launches the crop (K3) and the post-process (K2) only.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from .layers import batchnorm
from .resnet import BasicBlock, Bottleneck

__all__ = ["PoseHighResolutionNet", "HighResolutionModule",
           "DEFAULT_STAGES"]

# configs/posetrack21/hrnetw32_posetrack21.yaml:36-57 (HRNet-W32)
DEFAULT_STAGES = {
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "NUM_BLOCKS": [4, 4],
               "NUM_CHANNELS": [32, 64], "BLOCK": "BASIC"},
    "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "NUM_BLOCKS": [4, 4, 4],
               "NUM_CHANNELS": [32, 64, 128], "BLOCK": "BASIC"},
    "STAGE4": {"NUM_MODULES": 3, "NUM_BRANCHES": 4, "NUM_BLOCKS": [4, 4, 4, 4],
               "NUM_CHANNELS": [32, 64, 128, 256], "BLOCK": "BASIC"},
}
_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(in_ch, out_ch, kernel, stride, relu):
    mods = [nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                      bias=False), batchnorm(out_ch)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


class HighResolutionModule(nn.Module):
    """Per-branch residual blocks, then all-to-all SUM fusion
    (hrnet.py:98-260)."""

    def __init__(self, num_branches, block, num_blocks, num_inchannels,
                 num_channels, multi_scale_output=True):
        super().__init__()
        blk = _BLOCKS[block]
        chans = [c * blk.expansion for c in num_channels]
        branches = []
        for i in range(num_branches):
            ds = None
            if num_inchannels[i] != chans[i]:
                ds = nn.Sequential(nn.Conv2d(num_inchannels[i], chans[i], 1,
                                             bias=False), batchnorm(chans[i]))
            branches.append(nn.Sequential(
                blk(num_inchannels[i], num_channels[i], 1, ds),
                *(blk(chans[i], num_channels[i])
                  for _ in range(1, num_blocks[i]))))
        self.branches = nn.ModuleList(branches)
        self.fuse_layers = None
        if num_branches == 1:
            return
        rows = []
        for i in range(num_branches if multi_scale_output else 1):
            row = []
            for j in range(num_branches):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(chans[j], chans[i], 1, bias=False),
                        batchnorm(chans[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(chans[j], chans[i] if k == i - j - 1
                                 else chans[j], 3, 2, relu=k < i - j - 1)
                        for k in range(i - j))))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        outs = [b(x) for b, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for row in self.fuse_layers:
            y = None
            for j, f in enumerate(row):
                t = outs[j] if f is None else f(outs[j])
                y = t if y is None else y + t
            fused.append(torch.relu(y))
        return fused


class PoseHighResolutionNet(nn.Module):
    def __init__(self, num_joints: int = 17, final_conv_kernel: int = 1,
                 stages=None, device=None):
        super().__init__()
        stages = stages or DEFAULT_STAGES
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = batchnorm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = batchnorm(64)
        ds = nn.Sequential(nn.Conv2d(64, 256, 1, bias=False), batchnorm(256))
        self.layer1 = nn.Sequential(Bottleneck(64, 64, 1, ds),
                                    *(Bottleneck(256, 64) for _ in range(3)))
        pre = [256]
        for si, key in enumerate(("STAGE2", "STAGE3", "STAGE4")):
            scfg = stages[key]
            cur = [c * _BLOCKS[scfg["BLOCK"]].expansion
                   for c in scfg["NUM_CHANNELS"]]
            trans = []
            for i in range(scfg["NUM_BRANCHES"]):
                if i < len(pre):          # a branch kept: adapt or pass
                    trans.append(_conv_bn(pre[i], cur[i], 3, 1, True)
                                 if cur[i] != pre[i] else None)
                else:                     # a new branch from the last one
                    trans.append(nn.Sequential(*(
                        _conv_bn(pre[-1], cur[i] if j == i - len(pre)
                                 else pre[-1], 3, 2, True)
                        for j in range(i + 1 - len(pre)))))
            setattr(self, f"transition{si + 1}", nn.ModuleList(trans))
            n = scfg["NUM_MODULES"]
            setattr(self, f"stage{si + 2}", nn.Sequential(*(
                HighResolutionModule(
                    scfg["NUM_BRANCHES"], scfg["BLOCK"], scfg["NUM_BLOCKS"],
                    cur, scfg["NUM_CHANNELS"],
                    multi_scale_output=not (key == "STAGE4" and m == n - 1))
                for m in range(n))))
            pre = cur
        self.final_layer = nn.Conv2d(pre[0], num_joints, final_conv_kernel,
                                     1, 1 if final_conv_kernel == 3 else 0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, std=0.001)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    @classmethod
    def from_cfg(cls, model_cfg, preset_cfg, fused_eval=False, device=None):
        """The reference's MODEL keys: FINAL_CONV_KERNEL and STAGE2/3/4;
        `fused_eval` is ignored, as the JAX builder ignores it for HRNet."""
        stages = {k: dict(model_cfg[k]) for k in ("STAGE2", "STAGE3",
                                                  "STAGE4")
                  if k in model_cfg} or None
        return cls(num_joints=preset_cfg["NUM_JOINTS"],
                   final_conv_kernel=model_cfg.get("FINAL_CONV_KERNEL", 1),
                   stages=stages, device=device)

    def forward(self, x, return_embedding: bool = False):
        """x: (N, 3, H, W).  Returns heatmaps (N, K, H/4, W/4) and, when
        asked, the (N, 2048) embedding."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for si in range(3):
            trans = getattr(self, f"transition{si + 1}")
            # the reference feeds every transition the last branch
            xs = [ys[i] if t is None else t(ys[-1])
                  for i, t in enumerate(trans)]
            ys = getattr(self, f"stage{si + 2}")(xs)
        hm = self.final_layer(ys[0])
        if return_embedding:
            emb = ys[0].mean(dim=(2, 3))
            return hm, F.pad(emb, (0, max(0, 2048 - emb.shape[1])))
        return hm

    def get_embedding(self, x):
        return self(x, return_embedding=True)[1]
