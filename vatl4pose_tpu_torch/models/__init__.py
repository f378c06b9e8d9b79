"""Models: SimplePose and FastPose on a (SE-)ResNet backbone, HRNet, the
ShuffleResnet backbone, the WholeBodyAE and the VL4Pose AuxNet."""

from .auxnet import COCO_LINKS, AuxNet
from .builder import build_sppe, build_wholebody_ae
from .convert import state_dict_from_flax
from .fastpose import FastPose
from .hrnet import HighResolutionModule, PoseHighResolutionNet
from .resnet import RESNET_SPECS, BasicBlock, Bottleneck, ResNet
from .shuffle_resnet import ShuffleBottleneck, ShuffleResnet
from .simplepose import SimplePose
from .wholebody_ae import WholeBodyAE
