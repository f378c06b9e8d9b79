"""Building blocks with the reference's torch semantics (counterpart of
vatl4pose_tpu/models/layers.py, the parts SimplePose-R50 needs):
BatchNorm2d with eps 1e-5 and momentum 0.1, ConvTranspose2d(4, 2, 1)
without bias, MaxPool2d(3, 2, 1)."""

from __future__ import annotations

from torch import nn

__all__ = ["batchnorm", "conv_transpose", "max_pool"]


def batchnorm(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)


def conv_transpose(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """The SimplePose deconv (alphapose/models/simplepose.py:40-48)."""
    return nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1,
                              bias=False)


def max_pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, stride=2, padding=1)
