"""The serving rule: whether a forward of a kernel-served module takes its
hand-written kernel, or the module graph that autograd and every dtype
run.

The served modules are the ResNet's bottleneck tails (K1,
models/resnet.py), a deformable 3x3 (K4, `deform_conv.DeformConv2d`) and
a DUC (K5, models/layers.py).  Each asks `takes_kernel` and adds only
what its kernel's shapes need (a stage with a tail that is not
deformable; upscale 2).  The kernels write into buffers of their own, so
their outputs carry no autograd graph: a forward that asks for a
gradient never takes them.
"""

from __future__ import annotations

import torch

__all__ = ["K1_DTYPES", "F32", "takes_kernel"]

K1_DTYPES = (torch.float32, torch.bfloat16)
F32 = (torch.float32,)


def takes_kernel(module, dtypes, x, *inputs) -> bool:
    """True when this forward of `module` (which has `fused_eval`) takes
    its hand kernel: `fused_eval` is set, the module is in eval mode, x's
    dtype is one of `dtypes` (the kernel's), and no gradient is asked
    for: autograd off, or none of x, `inputs` and the module's parameters
    requires one."""
    if not module.fused_eval or module.training or x.dtype not in dtypes:
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(t.requires_grad for t in (x, *inputs)) \
        and not any(p.requires_grad for p in module.parameters())
