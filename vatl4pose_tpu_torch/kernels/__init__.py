"""Hand-written CUDA kernels (sources in ../csrc) with their plain
PyTorch versions.  Each wrapper counts its kernel launches in its
`launches` attribute, K1 and K3 also by dtype (`launches_by_dtype`: the
stream's, the crops'), K1 also the launches of its f32 weights' layout
and split (`split_launches`).

The JAX package's plain (non-Pallas) kernels are eager PyTorch here,
with no hand kernel and no launch count: deformable convolution
(`deform_conv2d`, `DeformConv2d`), deformable PS-RoI pooling
(`deform_roi_pool`) and RoIAlign (`roi_align`)."""

from .deform_conv import DeformConv2d, deform_conv2d
from .deform_pool import deform_roi_pool
from .fused_bottleneck import (bottleneck_chain_reference, fold_bn,
                               fused_bottleneck_chain, k_major_split,
                               tf32_split)
from .postprocess import fused_postprocess, postprocess_reference
from .roi_align import roi_align
from .rot_warp import rot_warp_crop, rot_warp_crop_reference

KERNELS = (fused_bottleneck_chain, fused_postprocess, rot_warp_crop)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "launches_by_dtype"):
            k.launches_by_dtype.clear()
        if hasattr(k, "split_launches"):
            k.split_launches = 0
