"""FastPose (AlphaPose's Fast Pose, alphapose/models/fastpose.py): an
SE-ResNet backbone, PixelShuffle(2), two DUCs (3x3 convolution, BN, ReLU,
PixelShuffle(2)) and a 3x3 convolution to the joint heatmaps.  With
`DCN` and `STAGE_WITH_DCN` (Fast Pose (DCN), configs/coco/resnet/
256x192_res50_lr1e-3_2x-dcn.yaml) every 3x3 of the flagged stages, the
strided first block's included, is a deformable convolution.

Parameter names as AlphaPose's (`preact`, `preact.layer2.0.conv2_offset`,
`preact.layer2.0.conv2`, `preact.layer1.0.se.fc.0`, `suffle1`, `duc1.conv`,
`duc2.bn`, `conv_out`).  SE (channel scale: global average, Linear C ->
C/16, ReLU, Linear -> C, sigmoid) sits on each stage's first block only,
after bn3 and before the residual sum.  The embedding is the global
average of the stride-32 backbone feature.

The deformable convolution follows Dai et al. (ICCV 2017), eq. 2:
y(p0) = sum_k w_k x(p0 + p_k + dp_k), x sampled bilinearly with
G(q, p) = max(0, 1 - |q_x - p_x|) max(0, 1 - |q_y - p_y|) over integral
q, so a tap outside the image contributes 0.  Here `grid_sample` with
zero padding samples every tap at once (each pixel position mapped to
its centre's normalised coordinate), then one product with the kernel
over (channel, tap).  Offsets come from `conv2_offset` (3x3, same stride,
with bias): 2 G K^2 channels, (dy, dx) interleaved by tap, channel
((g K^2 + k) 2 + {0: dy, 1: dx}) for deform group g and tap k = ky K + kx,
as the published CUDA extension lays them out; DCNv2 (`MODULATED`) adds
G K^2 mask channels after them, through a sigmoid.  Input channel c
belongs to group c // (C / G).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..layers import BatchNorm2d, Conv2d, Linear, _product
from .resnet import DEPTHS

# the retraining optimizer's learning-rate multiplier by top-level module
# (VATL's retrain_model: the head 10x, the DUCs 5x)
LR_MULT = {"preact": 1.0, "duc1": 5.0, "duc2": 5.0, "conv_out": 10.0}


class DeformConv2d(Conv2d):
    """A K x K deformable convolution without bias; forward(x, offset,
    mask=None).  A Conv2d, so that the benchmark's weights and FLOP count
    take it as the convolution it is."""

    def __init__(self, in_ch, out_ch, k=3, stride=1, padding=1,
                 deform_groups=1):
        super().__init__(in_ch, out_ch, k, stride, padding, bias=False)
        self.deform_groups = deform_groups

    def columns(self, x, offset, mask):
        """(N, C K^2, Ho Wo): every tap's sample, rows (c, ky, kx)."""
        N, C, H, W = x.shape
        K = self.kernel_size[0]
        s, p = self.stride[0], self.padding[0]
        G = self.deform_groups
        Ho, Wo = offset.shape[-2:]
        dev = x.device
        ky = torch.arange(K, device=dev).repeat_interleave(K)
        kx = torch.arange(K, device=dev).repeat(K)
        py = (torch.arange(Ho, device=dev) * s - p)[None, :, None] \
            + ky[:, None, None]                          # (K^2, Ho, 1)
        px = (torch.arange(Wo, device=dev) * s - p)[None, None, :] \
            + kx[:, None, None]                          # (K^2, 1, Wo)
        d = offset.reshape(N * G, K * K, 2, Ho, Wo)
        y = py + d[:, :, 0]                              # (NG, K^2, Ho, Wo)
        xx = px + d[:, :, 1]
        # pixel centre i of a side n sits at (2 i + 1) / n - 1
        grid = torch.stack([(2 * xx + 1) / W - 1, (2 * y + 1) / H - 1], -1)
        # (NG, C/G, K^2 Ho, Wo)
        samp = F.grid_sample(x.reshape(N * G, C // G, H, W),
                             grid.reshape(N * G, K * K * Ho, Wo, 2),
                             mode="bilinear", padding_mode="zeros",
                             align_corners=False)
        if mask is not None:
            samp = samp * mask.reshape(N * G, 1, K * K * Ho, Wo)
        return samp.reshape(N, C * K * K, Ho * Wo)

    def forward(self, x, offset, mask=None):
        N = x.shape[0]
        Ho, Wo = offset.shape[-2:]
        cols = self.columns(x, offset, mask)
        out = _product(self, lambda c, w: torch.matmul(
            w.reshape(w.shape[0], -1), c), cols, self.weight)
        return out.reshape(N, -1, Ho, Wo)


class SELayer(nn.Module):
    def __init__(self, ch, reduction=16):
        super().__init__()
        self.fc = nn.Sequential(Linear(ch, ch // reduction),
                                nn.ReLU(inplace=True),
                                Linear(ch // reduction, ch), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 se=False, dcn=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.modulated = bool(dcn and dcn.get("MODULATED", False))
        if dcn is None:
            self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        else:
            g = dcn.get("DEFORM_GROUP", 1)
            self.n_off = 2 * 9 * g
            self.conv2_offset = Conv2d(
                planes, (27 if self.modulated else 18) * g, 3, stride, 1)
            self.conv2 = DeformConv2d(planes, planes, 3, stride, 1, g)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        if se:
            self.se = SELayer(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(x)))
        if hasattr(self, "conv2_offset"):
            om = self.conv2_offset(out)
            mask = torch.sigmoid(om[:, self.n_off:]) if self.modulated \
                else None
            out = self.conv2(out, om[:, :self.n_off], mask)
        else:
            out = self.conv2(out)
        out = torch.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        if hasattr(self, "se"):
            out = self.se(out)
        return torch.relu(out + identity)


class SEResNet(nn.Module):
    """Stride-32 feature extractor of SE bottleneck stages."""

    def __init__(self, depth=50, dcn=None, stage_with_dcn=(False,) * 4):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                             DEPTHS[depth])):
            stride = 1 if li == 0 else 2
            d = dcn if stage_with_dcn[li] else None
            downsample = nn.Sequential(
                Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                BatchNorm2d(planes * 4))
            blocks = [Bottleneck(inplanes, planes, stride, downsample,
                                 se=True, dcn=d)]
            inplanes = planes * 4
            blocks += [Bottleneck(inplanes, planes, dcn=d)
                       for _ in range(1, n)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x


class DUC(nn.Module):
    def __init__(self, inplanes, planes, upscale=2):
        super().__init__()
        self.conv = Conv2d(inplanes, planes, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(planes)
        self.pixel_shuffle = nn.PixelShuffle(upscale)

    def forward(self, x):
        return self.pixel_shuffle(torch.relu(self.bn(self.conv(x))))


class FastPose(nn.Module):
    def __init__(self, num_joints=17, num_layers=50, conv_dim=128, dcn=None,
                 stage_with_dcn=(False,) * 4):
        super().__init__()
        self.preact = SEResNet(num_layers, dcn, stage_with_dcn)
        self.suffle1 = nn.PixelShuffle(2)
        self.duc1 = DUC(512, 1024)
        self.duc2 = DUC(256, 1024 if conv_dim == 256 else 512)
        self.conv_out = Conv2d(conv_dim, num_joints, 3, 1, 1)

    def forward(self, x, return_embedding=False):
        feat = self.preact(x)
        hm = self.conv_out(self.duc2(self.duc1(self.suffle1(feat))))
        if return_embedding:
            return hm, feat.mean(dim=(2, 3))
        return hm


def build(model_cfg, preset_cfg):
    return FastPose(num_joints=preset_cfg["NUM_JOINTS"],
                    num_layers=model_cfg.get("NUM_LAYERS", 50),
                    conv_dim=model_cfg.get("CONV_DIM", 128),
                    dcn=model_cfg.get("DCN"),
                    stage_with_dcn=tuple(model_cfg.get("STAGE_WITH_DCN",
                                                       (False,) * 4)))
