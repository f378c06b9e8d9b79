"""Deformable position-sensitive RoI pooling in eager PyTorch
(counterpart of vatl4pose_tpu/kernels/deform_pool.py, which has no
Pallas kernel; reference dcn/deform_pool.py:10-229).

R-FCN style: each output bin averages sample_per_part² bilinear samples,
shifted, unless `no_trans`, by learned per-bin offsets times trans_std
and the RoI's size; the boxes are rounded to the CUDA kernel's 0.5-offset
grid; output channel c of bin (i, j) reads input channel
(c*g + gy(i))*g + gy(j), gy(i) = min(i*g // P, g - 1).  A sample corner
outside the map reads 0.  Tensors are NCHW; `offset` is (R, 2, P, P)
holding (dy, dx).
"""

from __future__ import annotations

import torch

from .deform_conv import bilinear_taps

__all__ = ["deform_roi_pool"]


def deform_roi_pool(data, rois, offset=None, spatial_scale: float = 1.0,
                    out_size: int = 7, out_channels: int = None,
                    no_trans: bool = True, group_size: int = 1,
                    sample_per_part: int = 4, trans_std: float = 0.0):
    """data (N, C, H, W) with C == out_channels * group_size²; rois (R, 5)
    = (batch index, x1, y1, x2, y2).  Returns (R, out_channels, P, P)."""
    C = data.shape[1]
    g = group_size
    if out_channels is None:
        out_channels = C // (g * g)
    P, s = out_size, sample_per_part
    dev = data.device
    rois = torch.as_tensor(rois, dtype=torch.float32, device=dev)
    R = rois.shape[0]
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bin_w, bin_h = rw / P, rh / P
    sub_w, sub_h = bin_w / s, bin_h / s
    ii = torch.arange(P, device=dev)
    kk = torch.arange(s, device=dev)

    def r(v):                                   # per-RoI (R,) -> (R,1,1,1,1)
        return v[:, None, None, None, None]
    ys = r(y1) + ii[None, :, None, None, None] * r(bin_h) \
        + (kk[None, None, None, :, None] + 0.5) * r(sub_h)
    xs = r(x1) + ii[None, None, :, None, None] * r(bin_w) \
        + (kk[None, None, None, None, :] + 0.5) * r(sub_w)
    ys = ys.expand(R, P, P, s, s)
    xs = xs.expand(R, P, P, s, s)
    if not no_trans and offset is not None:
        ys = ys + (offset[:, 0] * trans_std * rh[:, None, None])[..., None,
                                                                 None]
        xs = xs + (offset[:, 1] * trans_std * rw[:, None, None])[..., None,
                                                                 None]
    samp = bilinear_taps(data[rois[:, 0].long()], ys.reshape(R, -1),
                         xs.reshape(R, -1))
    pooled = samp.reshape(R, C, P, P, s * s).mean(dim=-1)
    gy = torch.clamp((ii * g) // P, 0, g - 1)
    ch = (torch.arange(out_channels, device=dev)[:, None, None] * g
          + gy[None, :, None]) * g + gy[None, None, :]
    return pooled.gather(1, ch[None].expand(R, -1, -1, -1))
