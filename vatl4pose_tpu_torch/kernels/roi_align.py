"""RoIAlign in eager PyTorch (counterpart of vatl4pose_tpu/kernels/
roi_align.py, which has no Pallas kernel; reference
alphapose/utils/roi_align, a commented-out path of SimpleTransform).

Mask R-CNN style: each output cell averages sample_num x sample_num
bilinear samples at ((i + (k + 0.5)/s) * bin) from the box corner; a
fixed sample_num (the JAX package's static-shape choice, 2 by default;
the reference's -1 adaptive mode is not offered).  A sample corner
outside the map reads 0 (kernels/deform_conv.bilinear_taps).  Tensors
are NCHW.
"""

from __future__ import annotations

import torch

from .deform_conv import bilinear_taps

__all__ = ["roi_align"]


def roi_align(features, rois, out_size, spatial_scale: float = 1.0,
              sample_num: int = 2):
    """features (N, C, H, W); rois (R, 5) = (batch index, x1, y1, x2, y2);
    out_size (oh, ow).  Returns (R, C, oh, ow)."""
    oh, ow = int(out_size[0]), int(out_size[1])
    s = max(sample_num, 1)
    rois = torch.as_tensor(rois, dtype=torch.float32,
                           device=features.device)
    R = rois.shape[0]
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    bin_w = (x2 - x1).clamp(min=1.0) / ow
    bin_h = (y2 - y1).clamp(min=1.0) / oh
    dev = features.device
    sub = (torch.arange(s, device=dev) + 0.5) / s
    gy = y1[:, None, None] + torch.arange(oh, device=dev)[None, :, None] \
        * bin_h[:, None, None] + sub[None, None, :] * bin_h[:, None, None]
    gx = x1[:, None, None] + torch.arange(ow, device=dev)[None, :, None] \
        * bin_w[:, None, None] + sub[None, None, :] * bin_w[:, None, None]
    ys = gy[:, :, None, :, None].expand(R, oh, ow, s, s)
    xs = gx[:, None, :, None, :].expand(R, oh, ow, s, s)
    samp = bilinear_taps(features[rois[:, 0].long()], ys.reshape(R, -1),
                         xs.reshape(R, -1))
    return samp.reshape(R, -1, oh, ow, s * s).mean(dim=-1)
