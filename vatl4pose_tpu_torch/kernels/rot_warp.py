"""Person crop (counterpart of vatl4pose_tpu/kernels/rot_warp.py): the
wrapper of the CUDA kernel csrc/rot_warp.cu and its plain PyTorch version.

The JAX package rotates with a separable pre-warp and three Pallas shear
passes because a gather is slow on a TPU; they approximate one function,
the scaled, flipped and rotated crop of cv2.warpAffine (INTER_LINEAR,
BORDER_CONSTANT 0), and its default path computes that function exactly
with a gather (ops/warp.warp_affine_bilinear).  On Hopper a gather is a
cached load, so one kernel computes the exact function in one pass, for
any dst->src affine (no angle reduction, no isotropy limit), with the
/255 - RGB mean normalization in its epilogue.  The training crop takes
it with augmentation matrices, the scoring crop (ops/warp.crop_batch)
with rot=0 ones.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..ops.warp import RGB_MEAN, warp_affine_bilinear_batch
from . import _build

__all__ = ["rot_warp_crop", "rot_warp_crop_reference"]

# the kernel's instances, by (frames dtype, output dtype)
_SRC = {torch.uint8: "u8", torch.float32: "f32"}
_OUT = {torch.float32: "f32", torch.bfloat16: "bf16"}
# PyTorch's CUDA `x / 255.0` multiplies by the f32 reciprocal; the kernel
# multiplies by the same number, so that on the card it equals the plain
# version bit for bit
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_MAX_INT = 2 ** 31 - 1


def rot_warp_crop_reference(frames, frame_idx, inv_mats, out_size,
                            dtype=torch.float32):
    """Plain version: (N, oh, ow, 3) crops, /255 - RGB_MEAN in float32,
    then rounded once to `dtype`."""
    crops = warp_affine_bilinear_batch(frames, frame_idx, inv_mats, out_size)
    crops = crops / 255.0 - torch.as_tensor(RGB_MEAN, device=crops.device)
    return crops.to(dtype)


def _check_operands(frames, frame_idx, inv_mats, out_size, dtype):
    dev = frames.device
    if frames.dim() != 4 or frames.shape[3] != 3 \
            or frames.dtype not in _SRC or not frames.is_contiguous() \
            or min(frames.shape[:3]) < 1:
        raise ValueError("frames must be a contiguous (F, H, W, 3) uint8 or "
                         "float32 tensor")
    N = frame_idx.shape[0] if frame_idx.dim() == 1 else -1
    if N < 0 or frame_idx.dtype != torch.int64 or frame_idx.device != dev \
            or not frame_idx.is_contiguous():
        raise ValueError(f"frame_idx must be a contiguous (N,) int64 tensor "
                         f"on {dev}")
    if tuple(inv_mats.shape) != (N, 2, 3) \
            or inv_mats.dtype != torch.float32 or inv_mats.device != dev \
            or not inv_mats.is_contiguous():
        raise ValueError(f"inv_mats must be a contiguous ({N}, 2, 3) float32 "
                         f"tensor on {dev}")
    if dtype not in _OUT:
        raise ValueError(f"no kernel writes {dtype} crops (float32 or "
                         "bfloat16)")
    oh, ow = int(out_size[0]), int(out_size[1])
    # the kernel takes sizes as int; only N * oh * ow is counted in int64
    if oh <= 0 or ow <= 0 or max(N, oh * ow, *frames.shape[:3]) > _MAX_INT:
        raise ValueError(f"{N} samples of {oh}x{ow} from frames "
                         f"{tuple(frames.shape)} outside the kernel's range")
    return N, oh, ow


def rot_warp_crop(frames, frame_idx, inv_mats, out_size, dtype=torch.float32):
    """Normalized crops.

    frames: (F, H, W, 3) RGB, uint8 or float32 in [0, 255]; frame_idx:
    (N,) int64; inv_mats: (N, 2, 3) float32 dst->src; out_size: (oh, ow);
    dtype: float32 or bfloat16.  Returns (N, oh, ow, 3) in `dtype` =
    bilinear crop / 255 - RGB_MEAN, computed in float32 and rounded once.
    """
    if frames.device.type == "cpu":
        return rot_warp_crop_reference(frames, frame_idx, inv_mats, out_size,
                                       dtype)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    N, oh, ow = _check_operands(frames, frame_idx, inv_mats, out_size, dtype)
    F_, H, W, _ = frames.shape
    entry = f"rot_warp_{_SRC[frames.dtype]}_{_OUT[dtype]}"
    lib = _build.load("rot_warp")
    out = torch.empty((N, oh, ow, 3), dtype=dtype, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(frames.data_ptr(), frame_idx.data_ptr(),
                                  inv_mats.data_ptr(), out.data_ptr(), F_, H,
                                  W, N, oh, ow, _INV_255,
                                  *(float(m) for m in RGB_MEAN), stream)
    _build.check(err, entry)
    rot_warp_crop.launches += 1
    rot_warp_crop.launches_by_dtype[_OUT[dtype]] += 1
    return out


rot_warp_crop.launches = 0
rot_warp_crop.launches_by_dtype = Counter()
