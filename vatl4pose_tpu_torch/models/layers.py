"""Building blocks with the reference's torch semantics (counterpart of
vatl4pose_tpu/models/layers.py): BatchNorm2d with eps 1e-5 and momentum
0.1, ConvTranspose2d(4, 2, 1) without bias, MaxPool2d(3, 2, 1), the
Squeeze-and-Excitation layer (SE_module.py:9-24) and DUC (DUC.py:9-29).
The JAX package's `pixel_shuffle`/`pixel_unshuffle` are torch's
nn.PixelShuffle/nn.PixelUnshuffle channel order written for NHWC; the
port uses torch's own modules."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.duc_conv import shuffle_conv3x3
from ..kernels.fused_bottleneck import fold_bn_module
from ..kernels.serving import F32, takes_kernel
from ..parallel.mesh import active_mesh, all_reduce_sum

__all__ = ["BatchNorm2d", "batchnorm", "conv_transpose", "max_pool",
           "SELayer", "DUC"]


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training step updates `running_var` with the
    biased batch variance, as Flax's BatchNorm in the JAX package does
    (torch's own uses the unbiased one, n/(n-1) larger).  The forward
    normalizes with the batch statistics either way; eval mode is
    unchanged.

    The batch statistics come from the same F.batch_norm call, run with
    momentum 1 into scratch buffers (which then hold the batch mean and the
    unbiased variance); the running buffers are updated from those.  A
    bf16 input (bf16 retraining) is normalized as Flax does it: the
    statistics and the affine in f32, the output rounded to bf16.

    In train mode inside `with mesh:` (parallel/mesh.py) over more than
    one rank, the batch statistics are the global batch's (SyncBatchNorm
    semantics, as the JAX package's jit over a mesh computes them): see
    `_synced`.  Outside a mesh the F.batch_norm call above runs as it
    is."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        mesh = active_mesh()
        if mesh is not None and mesh.shape.get("data", 1) > 1:
            return self._synced(x, mesh.group("data"))
        c = self.num_features
        stat = torch.promote_types(x.dtype, torch.float32)
        batch_mean = torch.zeros(c, dtype=stat, device=x.device)
        batch_var = torch.zeros(c, dtype=stat, device=x.device)
        y = F.batch_norm(x, batch_mean, batch_var, self.weight.to(stat),
                         self.bias.to(stat), True, 1.0, self.eps)
        n = x.numel() // c
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1 - m).add_(batch_mean, alpha=m)
            self.running_var.mul_(1 - m).add_(batch_var,
                                              alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    def _synced(self, x, group):
        """The batch statistics over the group's ranks, in f32 (f64 for an
        f64 input): the count and the per-channel sum first, then the
        centred sum of squares (E[x^2] - mean^2 would cancel on post-ReLU
        maps), each summed over the ranks by a differentiable all-reduce,
        so that the backward carries the cross-rank terms.  running_var
        takes the biased global variance (the Flax update);
        nn.SyncBatchNorm would take the unbiased one."""
        c = self.num_features
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype,
                           device=x.device)
        stats = all_reduce_sum(torch.cat([count, xf.sum(dims)]), group)
        n, mean = stats[0], stats[1:] / stats[0]
        centred = xf - mean[None, :, None, None]
        var = all_reduce_sum(centred.square().sum(dims), group) / n
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight.to(xf.dtype)[None, :, None, None] \
            + self.bias.to(xf.dtype)[None, :, None, None]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batchnorm(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def conv_transpose(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """The SimplePose deconv (alphapose/models/simplepose.py:40-48)."""
    return nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1,
                              bias=False)


def max_pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, stride=2, padding=1)


class SELayer(nn.Module):
    """GAP -> fc/reduction -> ReLU -> fc -> sigmoid -> channel scale, with
    the reference's `fc.0`/`fc.2` names."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction),
                                nn.ReLU(inplace=True),
                                nn.Linear(channel // reduction, channel),
                                nn.Sigmoid())

    def forward(self, x):
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


class DUC(nn.Module):
    """Dense Upsampling Convolution: 3x3 conv -> BN -> ReLU ->
    PixelShuffle(upscale_factor).  With `fused_eval`, a forward that
    kernels/serving.py's rule serves (eval mode, f32, no gradient asked
    for) at upscale 2 runs as one launch of K5
    (kernels/duc_conv.py; its plain version on the CPU) on the NHWC view
    of x, and returns the NCHW view of its channels-last output, so that
    a DUC after it reads that output as it lies."""

    def __init__(self, inplanes: int, planes: int, upscale_factor: int = 2,
                 fused_eval: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(inplanes, planes, 3, padding=1, bias=False)
        self.bn = batchnorm(planes)
        self.relu = nn.ReLU(inplace=True)
        self.pixel_shuffle = nn.PixelShuffle(upscale_factor)
        self.fused_eval = fused_eval

    def forward(self, x):
        if self.pixel_shuffle.upscale_factor != 2 \
                or not takes_kernel(self, F32, x):
            return self.pixel_shuffle(self.relu(self.bn(self.conv(x))))
        y = shuffle_conv3x3(x.permute(0, 2, 3, 1).contiguous(),
                            self.conv.weight, *fold_bn_module(self.bn))
        return y.permute(0, 3, 1, 2)
