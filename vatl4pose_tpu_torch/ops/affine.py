"""Affine-crop geometry on tensors (counterpart of vatl4pose_tpu/ops/
affine.py).

The reference builds the 2x3 affine from three point correspondences
(cv2.getAffineTransform); they always encode a similarity transform, so
the matrix is built in closed form.  bboxes are xyxy unless suffixed _xywh;
`output_size` is (w, h); every function broadcasts over leading dims.
"""

from __future__ import annotations

import math

import torch

__all__ = ["box_to_center_scale", "center_scale_to_box",
           "get_affine_transform", "affine_transform_points",
           "transform_preds", "bbox_xyxy_to_xywh"]


def bbox_xyxy_to_xywh(box):
    x0, y0, x1, y1 = box.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def box_to_center_scale(x, y, w, h, aspect_ratio: float,
                        scale_mult: float = 1.25):
    """bbox -> (center, scale) with aspect correction and 1.25 padding
    (alphapose/utils/bbox.py:197-216); scale is (w, h) in pixels."""
    center = torch.stack([x + w * 0.5, y + h * 0.5], dim=-1)
    too_wide = w > aspect_ratio * h
    too_tall = w < aspect_ratio * h
    h = torch.where(too_wide, w / aspect_ratio, h)
    w = torch.where(too_tall, h * aspect_ratio, w)
    scale = torch.stack([w, h], dim=-1) * scale_mult
    return center, scale


def center_scale_to_box(center, scale):
    """(center, scale) -> xyxy box (bbox.py:217-228)."""
    w, h = scale[..., 0], scale[..., 1]
    xmin = center[..., 0] - w * 0.5
    ymin = center[..., 1] - h * 0.5
    return torch.stack([xmin, ymin, xmin + w, ymin + h], dim=-1)


def get_affine_transform(center, scale, rot_deg, output_size,
                         shift=(0.0, 0.0), inv: bool = False):
    """Closed-form similarity transform equal to the reference's 3-point
    solve (transforms.py:753-786).  Returns (..., 2, 3) float32."""
    center = torch.as_tensor(center, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=center.device)
    rot_rad = torch.as_tensor(rot_deg, dtype=torch.float32,
                              device=center.device) * (math.pi / 180.0)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=center.device)
    dst_w = float(output_size[0])
    dst_h = float(output_size[1])

    src_w = scale[..., 0]
    s = dst_w / src_w
    cs, sn = torch.cos(rot_rad), torch.sin(rot_rad)
    a = s * cs
    b = s * sn
    src0x = center[..., 0] + scale[..., 0] * shift[..., 0]
    src0y = center[..., 1] + scale[..., 1] * shift[..., 1]
    # dst = [[a, b], [-b, a]] @ (p - src0) + (dst_w/2, dst_h/2)
    if not inv:
        m00, m01, m10, m11 = a, b, -b, a
        m02 = dst_w * 0.5 - (m00 * src0x + m01 * src0y)
        m12 = dst_h * 0.5 - (m10 * src0x + m11 * src0y)
        return torch.stack([torch.stack([m00, m01, m02], dim=-1),
                            torch.stack([m10, m11, m12], dim=-1)], dim=-2)
    # inverse similarity: p = R(rot)/s * (d - d0) + src0
    inv_s = src_w / dst_w
    ia = inv_s * cs
    ib = inv_s * sn
    i00, i01, i10, i11 = ia, -ib, ib, ia
    i02 = src0x - (i00 * dst_w * 0.5 + i01 * dst_h * 0.5)
    i12 = src0y - (i10 * dst_w * 0.5 + i11 * dst_h * 0.5)
    return torch.stack([torch.stack([i00, i01, i02], dim=-1),
                        torch.stack([i10, i11, i12], dim=-1)], dim=-2)


def affine_transform_points(pts, mat):
    """Apply (..., 2, 3) affine to (..., 2) points (transforms.py:789-792)."""
    x, y = pts[..., 0], pts[..., 1]
    nx = mat[..., 0, 0] * x + mat[..., 0, 1] * y + mat[..., 0, 2]
    ny = mat[..., 1, 0] * x + mat[..., 1, 1] * y + mat[..., 1, 2]
    return torch.stack([nx, ny], dim=-1)


def transform_preds(coords, center, scale, output_size):
    """Heatmap-space coords -> image space via the inverse crop affine
    (transforms.py:704-708).  `output_size` = (hm_w, hm_h); coords may carry
    extra per-joint dims beyond center's."""
    mat = get_affine_transform(center, scale, 0.0, output_size, inv=True)
    for _ in range(coords.dim() - center.dim()):
        mat = mat[..., None, :, :]
    return affine_transform_points(coords, mat)
