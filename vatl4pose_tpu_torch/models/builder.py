"""Model builders (counterpart of vatl4pose_tpu/models/builder.py;
alphapose/models/builder.py:17-37): the reference's config keys
(NUM_LAYERS, NUM_DECONV_FILTERS) onto the port's modules.

One nn.Module serves both modes, so there is no `train` argument: train()
runs the exact module graph, eval() with `fused_eval=True` routes the
ResNet bottleneck tails through the chain kernel (models/resnet.py).
"""

from __future__ import annotations

from .simplepose import SimplePose
from .wholebody_ae import WholeBodyAE

__all__ = ["build_sppe", "build_wholebody_ae"]

_NOT_PORTED = ("FastPose", "PoseHighResolutionNet", "ShuffleResnet")


def build_sppe(model_cfg, preset_cfg, fused_eval: bool = False,
               device=None) -> SimplePose:
    """A pose estimator from a reference-style config.  device=None means
    CUDA."""
    t = model_cfg["TYPE"]
    if t in _NOT_PORTED:
        raise NotImplementedError(
            f"MODEL.TYPE {t} is not ported yet (ROADMAP A12)")
    if t != "SimplePose":
        raise ValueError(f"unknown MODEL.TYPE {t}")
    return SimplePose(num_joints=preset_cfg["NUM_JOINTS"],
                      num_layers=model_cfg.get("NUM_LAYERS", 50),
                      deconv_dim=tuple(model_cfg.get(
                          "NUM_DECONV_FILTERS", (256, 256, 256))),
                      fused_eval=fused_eval, device=device)


def build_wholebody_ae(ae_cfg, input_dim: int = 38,
                       device=None) -> WholeBodyAE:
    return WholeBodyAE(z_dim=ae_cfg.get("Z_DIM", 4), input_dim=input_dim,
                       device=device)
