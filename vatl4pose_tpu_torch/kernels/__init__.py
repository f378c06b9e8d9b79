"""Hand-written CUDA kernels (sources in ../csrc) with their plain
PyTorch versions.  Each wrapper counts its kernel launches in its
`launches` attribute, K1 and K3 also by dtype (`launches_by_dtype`: the
stream's, the crops'), K1, K5 and K6 also the launches of their f32
weights' layout and split (`split_launches`).  Which forward of a model
takes K1, K4, K5 or K6 is decided by one rule, `serving.takes_kernel`.

The JAX package's plain (non-Pallas) kernels are eager PyTorch here:
deformable convolution (`deform_conv2d`, `DeformConv2d`), whose columns
a served forward takes from the hand kernel K4 (`deform_im2col`),
deformable PS-RoI pooling (`deform_roi_pool`) and RoIAlign
(`roi_align`), these two with no hand kernel and no launch count."""

from .deform_conv import (DeformConv2d, deform_columns, deform_conv2d,
                          deform_im2col)
from .deconv import (deconv_split, subpixel_deconv4x4,
                     subpixel_deconv4x4_reference)
from .deform_pool import deform_roi_pool
from .duc_conv import (shuffle_conv3x3, shuffle_conv3x3_reference,
                       shuffle_split)
from .fused_bottleneck import (bottleneck_chain_reference, fold_bn,
                               fold_bn_module, fused_bottleneck_chain,
                               k_major_split, tf32_split)
from .postprocess import fused_postprocess, postprocess_reference
from .roi_align import roi_align
from .rot_warp import rot_warp_crop, rot_warp_crop_reference

KERNELS = (fused_bottleneck_chain, fused_postprocess, rot_warp_crop,
           deform_im2col, shuffle_conv3x3, subpixel_deconv4x4)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "launches_by_dtype"):
            k.launches_by_dtype.clear()
        if hasattr(k, "split_launches"):
            k.split_launches = 0
