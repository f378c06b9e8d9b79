"""Models: SimplePose on a ResNet backbone and the WholeBodyAE."""

from .builder import build_sppe, build_wholebody_ae
from .convert import state_dict_from_flax
from .resnet import RESNET_SPECS, BasicBlock, Bottleneck, ResNet
from .simplepose import SimplePose
from .wholebody_ae import WholeBodyAE
