"""ResNet backbones in PyTorch (counterpart of vatl4pose_tpu/models/
resnet.py), with the reference's module names (alphapose/models/layers/
Resnet.py: `conv1`, `bn1`, `layer2.3.conv1`, `downsample.0`; SE_Resnet.py:
`layer1.0.se.fc.0`; a DCN stage's `conv2_offset` and `conv2`), so a
reference state_dict loads as it is.

`use_se=True` is the SE-ResNet of FastPose: SE only on each stage's
downsampling block (SE_Resnet.py:199-207).  `dcn` with `stage_with_dcn`
makes every 3x3 of the flagged stages a deformable one
(kernels/deform_conv.py, Resnet.py:68-97), strided blocks included
(FALLBACK_ON_STRIDE is not taken), whose offsets come from a
zero-initialised `conv2_offset`.

Tensors are NCHW at the module boundary and channels-last in memory.

`fused_eval=True`: on a forward that kernels/serving.py's rule serves
(eval mode, f32 or bf16, no gradient asked for), blocks 1..n-1 of every
bottleneck stage run through the CUDA chain kernel
(kernels/fused_bottleneck.py) with eval BN folded on every forward call,
so weights changed after construction are always seen.  The TPU package
splits the chain by a VMEM weight budget; all four stages' tails go
through the kernel here, bar the tails of DCN stages: their deformable
3x3s take their columns from the deformable im2col kernel K4 instead,
by the same rule.  Every other forward runs the exact module graph.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.deform_conv import DeformConv2d
from ..kernels.fused_bottleneck import (fold_bn_module,
                                        fused_bottleneck_chain)
from ..kernels.serving import K1_DTYPES, takes_kernel
from .layers import SELayer, batchnorm, max_pool

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

__all__ = ["ResNet", "Bottleneck", "BasicBlock", "RESNET_SPECS"]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = batchnorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = batchnorm(planes)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 use_se=False, dcn=None, fused_eval=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batchnorm(planes)
        if dcn is None:
            self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        else:
            groups = dcn.get("DEFORM_GROUP", 1)
            modulated = dcn.get("MODULATED", False)
            self.conv2_offset = nn.Conv2d(
                planes, (27 if modulated else 18) * groups, 3, stride, 1)
            nn.init.zeros_(self.conv2_offset.weight)
            nn.init.zeros_(self.conv2_offset.bias)
            self.conv2 = DeformConv2d(planes, planes, 3, stride, 1, groups,
                                      modulated, fused_eval)
        self.bn2 = batchnorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = batchnorm(planes * 4)
        if use_se:
            self.se = SELayer(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        if hasattr(self, "conv2_offset"):
            out = self.conv2(out, self.conv2_offset(out))
        else:
            out = self.conv2(out)
        out = torch.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "se"):
            out = self.se(out)
        return torch.relu(out + identity)

    def folded(self, dtype):
        """(w1 (C, P), s1, b1, w2 (3, 3, P, P), s2, b2, w3 (P, C), s3, b3):
        conv kernels in `dtype`, folded BN in f32."""
        return (self.conv1.weight[:, :, 0, 0].t().to(dtype),
                *fold_bn_module(self.bn1),
                self.conv2.weight.permute(2, 3, 1, 0).to(dtype),
                *fold_bn_module(self.bn2),
                self.conv3.weight[:, :, 0, 0].t().to(dtype),
                *fold_bn_module(self.bn3))


class ResNet(nn.Module):
    """Stride-32 feature extractor: NCHW in, NCHW (channels-last) out."""

    def __init__(self, depth: int = 50, fused_eval: bool = False,
                 use_se: bool = False, dcn=None,
                 stage_with_dcn=(False, False, False, False), device=None):
        super().__init__()
        kind, layers = RESNET_SPECS[depth]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.fused_eval = fused_eval and block is Bottleneck
        # the chain kernel takes plain bottlenecks only: no tail of a DCN
        # stage goes through it (SE sits on block 0, outside the tail)
        self.stage_dcn = [dcn is not None and bool(f) for f in stage_with_dcn]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batchnorm(64)
        self.maxpool = max_pool()
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            downsample = None
            if stride != 1 or inplanes != planes * block.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(inplanes, planes * block.expansion, 1, stride,
                              bias=False),
                    batchnorm(planes * block.expansion))
            stage_dcn = dcn if self.stage_dcn[li] else None
            blocks = [self._block(block, inplanes, planes, stride,
                                  downsample, use_se, stage_dcn,
                                  self.fused_eval)]
            inplanes = planes * block.expansion
            blocks += [self._block(block, inplanes, planes, 1, None, use_se,
                                   stage_dcn, self.fused_eval)
                       for _ in range(1, n)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.to(resolve_device(device))

    @staticmethod
    def _block(block, inplanes, planes, stride, downsample, use_se, dcn,
               fused_eval):
        if block is BasicBlock:       # SE and DCN are bottleneck options
            return BasicBlock(inplanes, planes, stride, downsample)
        # SE on the stage's downsampling block only
        return Bottleneck(inplanes, planes, stride, downsample,
                          use_se=use_se and downsample is not None, dcn=dcn,
                          fused_eval=fused_eval)

    def forward(self, x):
        served = takes_kernel(self, K1_DTYPES, x)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(4):
            layer = getattr(self, f"layer{li + 1}")
            if served and len(layer) > 1 and not self.stage_dcn[li]:
                x = _fused_tail(layer[0](x), layer[1:])
            else:
                x = layer(x)
        return x


def _fused_tail(x, blocks):
    """Blocks 1..n-1 of a stage through the chain kernel on the NHWC view
    of the channels-last stream."""
    cols = zip(*(blk.folded(x.dtype) for blk in blocks))
    stacked = [torch.stack(c).contiguous() for c in cols]
    y = fused_bottleneck_chain(x.permute(0, 2, 3, 1).contiguous(), *stacked)
    return y.permute(0, 3, 1, 2)
