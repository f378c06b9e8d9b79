"""SimpleBaseline (Xiao et al., ECCV 2018): a ResNet backbone, three
4x4 stride-2 deconvolutions with BN and ReLU, a 1x1 convolution to the
joint heatmaps.  Parameter names as AlphaPose's SimplePose (`preact`,
`deconv_layers.{0,1,3,4,6,7}`, `final_layer`).  The embedding is the
global average of the backbone's stride-32 feature."""

from __future__ import annotations

from torch import nn

from ..layers import BatchNorm2d, Conv2d, ConvTranspose2d
from .resnet import ResNet

# the retraining optimizer's learning-rate multiplier by top-level module
# (VATL's retrain_model: the head 10x, the deconvolutions 5x)
LR_MULT = {"preact": 1.0, "deconv_layers": 5.0, "final_layer": 10.0}


class SimplePose(nn.Module):
    def __init__(self, num_joints=17, num_layers=50,
                 deconv_dim=(256, 256, 256)):
        super().__init__()
        self.preact = ResNet(num_layers)
        in_ch, mods = 2048, []
        for d in deconv_dim:
            mods += [ConvTranspose2d(in_ch, d, 4, stride=2, padding=1,
                                     bias=False),
                     BatchNorm2d(d), nn.ReLU(inplace=True)]
            in_ch = d
        self.deconv_layers = nn.Sequential(*mods)
        self.final_layer = Conv2d(in_ch, num_joints, 1)

    def forward(self, x, return_embedding=False):
        feat = self.preact(x)
        hm = self.final_layer(self.deconv_layers(feat))
        if return_embedding:
            return hm, feat.mean(dim=(2, 3))
        return hm


def build(model_cfg, preset_cfg):
    return SimplePose(num_joints=preset_cfg["NUM_JOINTS"],
                      num_layers=model_cfg.get("NUM_LAYERS", 50),
                      deconv_dim=tuple(model_cfg["NUM_DECONV_FILTERS"]))
