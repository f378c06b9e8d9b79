"""VL4Pose auxiliary network in PyTorch (counterpart of vatl4pose_tpu/
models/auxnet.py; active_learning/VL4Pose/AuxiliaryNet.py:10-115).

The estimator's stride-32 backbone feature (N, C, h, w) -> per-link
Gaussian parameters (N, 16, 2) = (mu, log sigma^2) of the 16-link COCO
tree rooted at the nose: a 1x1 projection to 128 channels, two stride-2
3x3 convolutions each added to a 2x2 average pool of its input (the pool
floors odd sizes, and the add broadcasts a width of 1, as in the JAX
package), a global mean, an FC head 128-64-32-16 and 2·16 outputs.
Module names follow the Flax module (`proj`, `down0`, `down1`, `fc0`-`fc3`,
`out`), so models/convert.state_dict_from_flax(variables, "auxnet")
carries its weights across.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

__all__ = ["COCO_LINKS", "AuxNet"]

# 16-link tree over the 17 COCO keypoints, rooted at the nose (0)
COCO_LINKS = np.array([
    [0, 1], [1, 3], [0, 2], [2, 4],          # nose→eyes→ears
    [0, 5], [5, 7], [7, 9],                  # left arm
    [0, 6], [6, 8], [8, 10],                 # right arm
    [5, 11], [11, 13], [13, 15],             # left leg
    [6, 12], [12, 14], [14, 16],             # right leg
], dtype=np.int32)


class AuxNet(nn.Module):
    """in_channels: the backbone feature's (2048 for ResNet-50 and deeper,
    512 below).  The initial weights are LeCun-normal kernels and zero
    biases, Flax's defaults, drawn from a generator seeded with `seed`
    (the JAX package seeds PRNGKey(318); the bits differ).  device=None
    is the card (device.resolve_device)."""

    def __init__(self, in_channels: int = 2048, num_links: int = len(COCO_LINKS),
                 channels: int = 128, fc_dims=(128, 64, 32, 16),
                 seed: int = 318, device=None):
        super().__init__()
        self.num_links = num_links
        self.proj = nn.Conv2d(in_channels, channels, 1)
        self.down0 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        self.down1 = nn.Conv2d(channels, channels, 3, stride=2, padding=1)
        dims = (channels,) + tuple(fc_dims)
        for i in range(len(fc_dims)):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n_fc = len(fc_dims)
        self.out = nn.Linear(dims[-1], num_links * 2)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    fan_in = m.weight[0].numel()
                    m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
                    m.bias.zero_()
        self.to(resolve_device(device))

    def forward(self, feat):
        x = F.relu(self.proj(feat.to(self.proj.weight.dtype)))
        for down in (self.down0, self.down1):
            x = F.relu(down(x) + F.avg_pool2d(x, 2, 2))
        x = x.mean(dim=(2, 3))
        for i in range(self.n_fc):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.out(x).reshape(x.shape[0], self.num_links, 2)
