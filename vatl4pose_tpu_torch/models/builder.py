"""Model builders (counterpart of vatl4pose_tpu/models/builder.py;
alphapose/models/builder.py:17-37): MODEL.TYPE resolved through the SPPE
registry, and the reference's config keys (NUM_LAYERS,
NUM_DECONV_FILTERS, CONV_DIM, DCN, STAGE_WITH_DCN, STAGE2/3/4,
FINAL_CONV_KERNEL) mapped by each model's `from_cfg`.  An unknown TYPE
raises the registry's KeyError.

One nn.Module serves both modes, so there is no `train` argument: train()
runs the exact module graph; with `fused_eval=True`, an eval forward that
asks for no gradient takes the hand kernels where kernels/serving.py's
rule gives them (SimplePose's and FastPose's bottleneck tails, FastPose's
deformable 3x3s and DUCs); HRNet ignores `fused_eval`.
"""

from __future__ import annotations

from ..registry import SPPE
from .criterion import LOSS_REGISTRY
from .fastpose import FastPose
from .hrnet import PoseHighResolutionNet
from .simplepose import SimplePose
from .wholebody_ae import WholeBodyAE

__all__ = ["build_sppe", "build_loss", "build_wholebody_ae"]

SPPE.register_module(SimplePose)
SPPE.register_module(FastPose)
SPPE.register_module(PoseHighResolutionNet)


def build_sppe(model_cfg, preset_cfg, fused_eval: bool = False,
               device=None):
    """A pose estimator from a reference-style config.  device=None means
    CUDA."""
    return SPPE.get(model_cfg["TYPE"]).from_cfg(
        model_cfg, preset_cfg, fused_eval=fused_eval, device=device)


def build_loss(loss_cfg):
    """The loss function of LOSS.TYPE (LOSS_REGISTRY)."""
    return LOSS_REGISTRY[loss_cfg["TYPE"]]


def build_wholebody_ae(ae_cfg, input_dim: int = 38,
                       device=None) -> WholeBodyAE:
    return WholeBodyAE(z_dim=ae_cfg.get("Z_DIM", 4), input_dim=input_dim,
                       device=device)
