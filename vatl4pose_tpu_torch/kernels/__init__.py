"""Hand-written CUDA kernels (sources in ../csrc) with their plain
PyTorch versions.  Each wrapper counts its kernel launches in its
`launches` attribute, K1 and K3 also by dtype (`launches_by_dtype`: the
stream's, the crops')."""

from .fused_bottleneck import (bottleneck_chain_reference, fold_bn,
                               fused_bottleneck_chain)
from .postprocess import fused_postprocess, postprocess_reference
from .rot_warp import rot_warp_crop, rot_warp_crop_reference

KERNELS = (fused_bottleneck_chain, fused_postprocess, rot_warp_crop)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        if hasattr(k, "launches_by_dtype"):
            k.launches_by_dtype.clear()
