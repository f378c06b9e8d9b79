"""Training crop (counterpart of vatl4pose_tpu/kernels/rot_warp.py): the
wrapper of the CUDA kernel csrc/rot_warp.cu and its plain PyTorch version.

The JAX package rotates with a separable pre-warp and three Pallas shear
passes because a gather is slow on a TPU; they approximate one function,
the scaled, flipped and rotated crop of cv2.warpAffine (INTER_LINEAR,
BORDER_CONSTANT 0), and its default path computes that function exactly
with a gather (ops/warp.warp_affine_bilinear).  On Hopper a gather is a
cached load, so one kernel computes the exact function in one pass, for
any dst->src affine (no angle reduction, no isotropy limit), with the
/255 - RGB mean normalization in its epilogue.

The wrapper launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from ..ops.warp import RGB_MEAN, warp_affine_bilinear_batch
from . import _build

__all__ = ["rot_warp_crop", "rot_warp_crop_reference", "rot_warp_copy"]

_MAX_SAMPLES = 65535          # the kernel's grid.y


def rot_warp_crop_reference(frames, frame_idx, inv_mats, out_size):
    """Plain version: (N, oh, ow, 3) float32 crops, /255 - RGB_MEAN."""
    crops = warp_affine_bilinear_batch(frames, frame_idx, inv_mats, out_size)
    return crops / 255.0 - torch.as_tensor(RGB_MEAN, device=crops.device)


def _check_operands(frames, frame_idx, inv_mats, out_size):
    dev = frames.device
    if frames.dim() != 4 or frames.shape[3] != 3 \
            or frames.dtype != torch.uint8 or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous (F, H, W, 3) uint8 "
                         "tensor")
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
    oh, ow = int(out_size[0]), int(out_size[1])
    if N > _MAX_SAMPLES or oh <= 0 or ow <= 0:
        raise ValueError(f"{N} samples of {oh}x{ow} outside the kernel's "
                         "range")
    return N, oh, ow


def _launch(entry, frames, frame_idx, inv_mats, out_size):
    N, oh, ow = _check_operands(frames, frame_idx, inv_mats, out_size)
    F_, H, W, _ = frames.shape
    lib = _build.load("rot_warp")
    out = torch.empty((N, oh, ow, 3), dtype=torch.float32,
                      device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(frames.data_ptr(), frame_idx.data_ptr(),
                                  inv_mats.data_ptr(), out.data_ptr(), F_, H,
                                  W, N, oh, ow, *(float(m) for m in RGB_MEAN),
                                  stream)
    _build.check(err, entry)
    return out


def rot_warp_crop(frames, frame_idx, inv_mats, out_size):
    """Normalized training crops.

    frames: (F, H, W, 3) uint8 RGB; frame_idx: (N,) int64; inv_mats:
    (N, 2, 3) float32 dst->src; out_size: (oh, ow).  Returns (N, oh, ow, 3)
    float32 = bilinear crop / 255 - RGB_MEAN.
    """
    if frames.device.type == "cpu":
        return rot_warp_crop_reference(frames, frame_idx, inv_mats, out_size)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    out = _launch("rot_warp_f32", frames, frame_idx, inv_mats, out_size)
    rot_warp_crop.launches += 1
    return out


rot_warp_crop.launches = 0


def rot_warp_copy(frames, frame_idx, inv_mats, out_size):
    """The kernel's copy variant (CUDA only, for timing): the same grid and
    bytes written, one tap read per pixel and no interpolation."""
    if frames.device.type != "cuda":
        raise ValueError("the copy variant runs on CUDA only")
    return _launch("rot_warp_copy_f32", frames, frame_idx, inv_mats, out_size)
