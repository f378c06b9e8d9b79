"""HRNet (Sun et al., CVPR 2019) for top-down pose: a stride-4 stem,
`layer1` of four Bottlenecks, then the stages that MODEL lists (STAGE2,
STAGE3 and, where given, STAGE4) of parallel branches whose outputs are
summed into every branch (1x1 conv, BN and nearest upsampling from a
lower resolution; strided 3x3 chains from a higher one), a ReLU after
each sum, and a 1x1 convolution of the highest-resolution branch to the
heatmaps.  The last module of the last stage returns that branch alone,
as the published code's `multi_scale_output=False` does.  Parameter
names as leoxiaobin/deep-high-resolution-net (`transition{1,2,3}`,
`stage{2,3,4}.m.branches.i.b`, `stage{2,3,4}.m.fuse_layers.i.j`).
Every transition reads the last branch, as the published code does.  The
embedding is the global average of the last stage's highest-resolution
feature, zero-padded to 2048."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..layers import BatchNorm2d, Conv2d
from .resnet import BasicBlock, Bottleneck

BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}
STAGES = ("STAGE2", "STAGE3", "STAGE4")
LR_MULT = {}          # one learning rate for every module


def _conv_bn(in_ch, out_ch, stride, relu):
    mods = [Conv2d(in_ch, out_ch, 3, stride, 1, bias=False),
            BatchNorm2d(out_ch)]
    if relu:
        mods.append(nn.ReLU(inplace=True))
    return nn.Sequential(*mods)


class HighResolutionModule(nn.Module):
    def __init__(self, num_branches, block, num_blocks, in_chans, num_chans,
                 multi_scale_output=True):
        super().__init__()
        blk = BLOCKS[block]
        chans = [c * blk.expansion for c in num_chans]
        branches = []
        for i in range(num_branches):
            ds = None
            if in_chans[i] != chans[i]:
                ds = nn.Sequential(Conv2d(in_chans[i], chans[i], 1,
                                          bias=False), BatchNorm2d(chans[i]))
            branches.append(nn.Sequential(
                blk(in_chans[i], num_chans[i], 1, ds),
                *(blk(chans[i], num_chans[i])
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
                        Conv2d(chans[j], chans[i], 1, bias=False),
                        BatchNorm2d(chans[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(chans[j], chans[i] if k == i - j - 1
                                 else chans[j], 2, relu=k < i - j - 1)
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
    def __init__(self, num_joints, stages, final_conv_kernel=1):
        """`stages`: the configuration of STAGE2, STAGE3, ... in order."""
        super().__init__()
        self.num_stages = len(stages)
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        ds = nn.Sequential(Conv2d(64, 256, 1, bias=False), BatchNorm2d(256))
        self.layer1 = nn.Sequential(Bottleneck(64, 64, 1, ds),
                                    *(Bottleneck(256, 64) for _ in range(3)))
        pre = [256]
        for si, s in enumerate(stages):
            cur = [c * BLOCKS[s["BLOCK"]].expansion
                   for c in s["NUM_CHANNELS"]]
            trans = []
            for i in range(s["NUM_BRANCHES"]):
                if i < len(pre):
                    trans.append(_conv_bn(pre[i], cur[i], 1, True)
                                 if cur[i] != pre[i] else None)
                else:
                    trans.append(nn.Sequential(*(
                        _conv_bn(pre[-1], cur[i] if j == i - len(pre)
                                 else pre[-1], 2, True)
                        for j in range(i + 1 - len(pre)))))
            setattr(self, f"transition{si + 1}", nn.ModuleList(trans))
            n = s["NUM_MODULES"]
            setattr(self, f"stage{si + 2}", nn.Sequential(*(
                HighResolutionModule(
                    s["NUM_BRANCHES"], s["BLOCK"], s["NUM_BLOCKS"], cur,
                    s["NUM_CHANNELS"],
                    multi_scale_output=not (si == len(stages) - 1
                                            and m == n - 1))
                for m in range(n))))
            pre = cur
        self.final_layer = Conv2d(pre[0], num_joints, final_conv_kernel, 1,
                                  1 if final_conv_kernel == 3 else 0)

    def features(self, x):
        """The last stage's highest-resolution branch."""
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        ys = [self.layer1(x)]
        for si in range(self.num_stages):
            trans = getattr(self, f"transition{si + 1}")
            xs = [ys[i] if t is None else t(ys[-1])
                  for i, t in enumerate(trans)]
            ys = getattr(self, f"stage{si + 2}")(xs)
        return ys[0]

    def forward(self, x, return_embedding=False):
        f = self.features(x)
        hm = self.final_layer(f)
        if return_embedding:
            emb = f.mean(dim=(2, 3))
            return hm, F.pad(emb, (0, max(0, 2048 - emb.shape[1])))
        return hm


def build(model_cfg, preset_cfg):
    return PoseHighResolutionNet(
        preset_cfg["NUM_JOINTS"],
        [model_cfg[k] for k in STAGES if k in model_cfg],
        model_cfg.get("FINAL_CONV_KERNEL", 1))
