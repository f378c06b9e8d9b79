"""Heatmap post-process (counterpart of vatl4pose_tpu/kernels/
pallas_postprocess.py): the wrapper of the CUDA kernel csrc/
postprocess.cu, its plain PyTorch version and the host glue.

One read of the (N, K, H, W) f32 heatmaps gives per joint the argmax
(row-major, first max wins), the max value and the 4 neighbours at the
clamped peak, and per sample the mean of the kept 3x3 local peaks.  The
glue turns these into refined heatmap coords exactly as
`get_max_pred` + `subpixel_refine` do: coords zeroed where maxval <= 0
before the strict 1 < p < size-1 window test on rounded coords.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from ..ops.heatmap import get_max_pred, subpixel_refine
from ..ops.peaks import localpeak_mean
from . import _build

__all__ = ["fused_postprocess", "postprocess_reference"]

# one map in dynamic shared memory, under the 48 KB a block gets without
# opting in, less room for the kernel's static reduction buffers
_MAX_MAP_BYTES = 47 * 1024


def postprocess_reference(hms):
    """Plain version: (coords (N, K, 2) refined in heatmap space,
    maxvals (N, K), gc (N,))."""
    coords, maxvals = get_max_pred(hms)
    return subpixel_refine(hms, coords), maxvals, localpeak_mean(hms)


def _glue(joint, W, H):
    px, py, maxvals, left, right, up, down = joint.unbind(1)
    coords = torch.stack([px, py], dim=-1)
    masked = coords * (maxvals > 0)[..., None].to(coords.dtype)
    pxi = torch.round(masked[..., 0]).to(torch.int32)
    pyi = torch.round(masked[..., 1]).to(torch.int32)
    ok = (pxi > 1) & (pxi < W - 1) & (pyi > 1) & (pyi < H - 1)
    shift = torch.stack([torch.sign(right - left), torch.sign(down - up)],
                        dim=-1) * 0.25
    return masked + shift * ok[..., None].to(coords.dtype), maxvals


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
    if H < 3 or W < 3 or H * W * 4 > _MAX_MAP_BYTES:
        raise ValueError(f"map size {H}x{W} outside the kernel's range")
    lib = _build.load("postprocess")
    joint = torch.empty((N, 7, K), dtype=torch.float32, device=hms.device)
    part = torch.empty((N * K, 2), dtype=torch.float32, device=hms.device)
    gc = torch.empty((N,), dtype=torch.float32, device=hms.device)
    with torch.cuda.device(hms.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.heatmap_postprocess_f32(hms.data_ptr(), joint.data_ptr(),
                                          part.data_ptr(), gc.data_ptr(),
                                          N, K, H, W, stream)
    _build.check(err, "fused_postprocess")
    fused_postprocess.launches += 1
    coords, maxvals = _glue(joint, W, H)
    return coords, maxvals, gc


fused_postprocess.launches = 0
