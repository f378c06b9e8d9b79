"""ShuffleResnet in PyTorch (counterpart of vatl4pose_tpu/models/
shuffle_resnet.py; alphapose/models/layers/ShuffleResnet.py:19-200): an
SE-ResNet whose strided blocks downsample losslessly with
PixelUnshuffle(stride) (space-to-depth) before a stride-1 3x3 conv; the
downsample shortcuts stay strided 1x1 convs; SE on each stage's
downsampling block.  A backbone only: no shipped config builds it, and
the JAX builder registers no SPPE of it."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .layers import SELayer, batchnorm, max_pool
from .resnet import RESNET_SPECS

__all__ = ["ShuffleBottleneck", "ShuffleResnet"]


class ShuffleBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 use_se=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = batchnorm(planes)
        self.unshuffle = nn.PixelUnshuffle(stride) if stride > 1 \
            else nn.Identity()
        self.conv2 = nn.Conv2d(planes * stride * stride, planes, 3, 1, 1,
                               bias=False)
        self.bn2 = batchnorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = batchnorm(planes * 4)
        if use_se:
            self.se = SELayer(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(self.unshuffle(out))))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "se"):
            out = self.se(out)
        return torch.relu(out + identity)


class ShuffleResnet(nn.Module):
    """Stride-32 feature extractor: NCHW in, NCHW (channels-last) out."""

    def __init__(self, depth: int = 50, device=None):
        super().__init__()
        _, layers = RESNET_SPECS[depth]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batchnorm(64)
        self.maxpool = max_pool()
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            ds = nn.Sequential(nn.Conv2d(inplanes, planes * 4, 1, stride,
                                         bias=False), batchnorm(planes * 4))
            blocks = [ShuffleBottleneck(inplanes, planes, stride, ds,
                                        use_se=True)]
            blocks += [ShuffleBottleneck(planes * 4, planes)
                       for _ in range(1, n)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            inplanes = planes * 4
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x
