"""Heatmap post-process (counterpart of vatl4pose_tpu/kernels/
pallas_postprocess.py): the wrapper of the CUDA kernel csrc/
postprocess.cu and its plain PyTorch version.

One read of the (N, K, H, W) f32 heatmaps gives per joint the argmax
(row-major, first max wins) and the max value, decoded into refined
heatmap coords exactly as `get_max_pred` + `subpixel_refine` do (coords
zeroed where maxval <= 0 before the strict 1 < p < size-1 window test on
rounded coords, then the ±0.25 shift toward the larger neighbour), and
per sample the mean of the kept 3x3 local peaks.  The kernel writes these
final outputs itself.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from ..ops.heatmap import get_max_pred, subpixel_refine
from ..ops.peaks import localpeak_mean
from . import _build

__all__ = ["fused_postprocess", "postprocess_reference"]

# one map and the K per-map partials in the dynamic shared memory of one
# block (the 227 KB an H100 block can opt in to)
_MAX_SMEM_BYTES = 232448


def postprocess_reference(hms):
    """Plain version: (coords (N, K, 2) refined in heatmap space,
    maxvals (N, K), gc (N,))."""
    coords, maxvals = get_max_pred(hms)
    return subpixel_refine(hms, coords), maxvals, localpeak_mean(hms)


def fused_postprocess(hms):
    """hms: (N, K, H, W) float32.  Returns (coords (N, K, 2) refined in
    heatmap space, maxvals (N, K), gc (N,))."""
    if hms.device.type == "cpu":
        return postprocess_reference(hms)
    if hms.device.type != "cuda":
        raise ValueError(f"no kernel for device {hms.device}")
    if hms.dim() != 4 or hms.dtype != torch.float32 \
            or not hms.is_contiguous():
        raise ValueError("hms must be a contiguous (N, K, H, W) float32 "
                         "tensor")
    N, K, H, W = hms.shape
    # the kernel's buffer per map: H*W floats and 4 of slack, 16-aligned
    smem = (2 * K + 3) // 4 * 16 + (H * W + 7) // 4 * 16
    if H < 3 or W < 3 or smem > _MAX_SMEM_BYTES:
        raise ValueError(f"{K} maps of {H}x{W} outside the kernel's range")
    lib = _build.load("postprocess")
    # one allocation for the three outputs
    out = torch.empty(N * K * 3 + N, dtype=torch.float32, device=hms.device)
    coords = out[:N * K * 2].view(N, K, 2)
    maxvals = out[N * K * 2:N * K * 3].view(N, K)
    gc = out[N * K * 3:]
    with torch.cuda.device(hms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.heatmap_postprocess_f32(hms.data_ptr(), coords.data_ptr(),
                                          maxvals.data_ptr(), gc.data_ptr(),
                                          N, K, H, W, stream)
    _build.check(err, "fused_postprocess")
    fused_postprocess.launches += 1
    return coords, maxvals, gc


fused_postprocess.launches = 0
