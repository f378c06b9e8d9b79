"""Hand-written CUDA kernels (sources in ../csrc) with their plain
PyTorch versions.  Each wrapper counts its kernel launches in its
`launches` attribute."""

from .fused_bottleneck import (bottleneck_chain_reference, fold_bn,
                               fused_bottleneck_chain)
from .postprocess import fused_postprocess, postprocess_reference

KERNELS = (fused_bottleneck_chain, fused_postprocess)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
