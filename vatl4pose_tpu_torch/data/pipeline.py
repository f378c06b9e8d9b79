"""Host-side sample geometry and static-shape batching helpers (counterpart
of vatl4pose_tpu/data/pipeline.py; numpy only).

Train path parity: the reference's train transform (simple_transform.py:
179-251): half-body transform, scale jitter, rotation jitter, horizontal
flip, as per-sample dst->src affines for the crop kernel
(kernels/rot_warp.py).  Eval path parity: test_transform (simple_transform
.py:81-98): no augmentation, scale*1.0, rot 0.

`train_sample_geometry` draws from the caller's numpy Generator in exactly
the JAX package's order (dpg -> half-body gate -> half-body normal -> scale
normal -> rot uniform [-> rot normal] -> flip uniform), so one seed gives
both packages the same crops.

Eager PyTorch does not recompile per shape, so the scoring engine does not
pad stage 2 to a bucket; `pad_to`/`bucket_size` stay for callers that want
fixed batch shapes (the AE trainer's zero-padded batches, a CUDA graph of
one chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["UPPER_BODY_IDS", "np_affine_transform",
           "AugCfg", "add_dpg", "train_sample_geometry",
           "eval_sample_geometry", "pad_to", "bucket_size"]

UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)


def np_affine_transform(center, scale, rot_deg, out_wh, inv=False):
    """Closed-form similarity affine (src->dst, or dst->src with inv)."""
    dst_w, dst_h = float(out_wh[0]), float(out_wh[1])
    rot = np.deg2rad(rot_deg)
    src_w = float(scale[0])
    s = dst_w / src_w
    cs, sn = np.cos(rot), np.sin(rot)
    if not inv:
        m00, m01 = s * cs, s * sn
        m10, m11 = -s * sn, s * cs
        m02 = dst_w * 0.5 - (m00 * center[0] + m01 * center[1])
        m12 = dst_h * 0.5 - (m10 * center[0] + m11 * center[1])
    else:
        inv_s = src_w / dst_w
        m00, m01 = inv_s * cs, -inv_s * sn
        m10, m11 = inv_s * sn, inv_s * cs
        m02 = center[0] - (m00 * dst_w * 0.5 + m01 * dst_h * 0.5)
        m12 = center[1] - (m10 * dst_w * 0.5 + m11 * dst_h * 0.5)
    return np.array([[m00, m01, m02], [m10, m11, m12]], np.float32)


@dataclasses.dataclass
class AugCfg:
    scale_factor: float = 0.3
    rot_factor: float = 40.0
    flip: bool = False
    num_joints_half_body: int = 8
    prob_half_body: float = -1.0
    add_dpg: bool = False             # DPG second-stage aug (transforms.py:43)


def add_dpg(bbox_xyxy, imgwidth, imght, rng):
    """DPG random crop / random shift of the person box (transforms.py:
    43-73 addDPG), drawn from the numpy Generator `rng`."""
    b = list(bbox_xyxy)
    patch_scale = rng.uniform()
    width = b[2] - b[0]
    ht = b[3] - b[1]
    if patch_scale > 0.85:
        ratio = ht / width
        if width < ht:
            patch_w = patch_scale * width
            patch_h = patch_w * ratio
        else:
            patch_h = patch_scale * ht
            patch_w = patch_h / ratio
        xmin = b[0] + rng.uniform() * (width - patch_w)
        ymin = b[1] + rng.uniform() * (ht - patch_h)
        xmax = xmin + patch_w + 1
        ymax = ymin + patch_h + 1
    else:
        xmin = max(1, min(b[0] + rng.normal(-0.0142, 0.1158) * width,
                          imgwidth - 3))
        ymin = max(1, min(b[1] + rng.normal(0.0043, 0.068) * ht, imght - 3))
        xmax = min(max(xmin + 2, b[2] + rng.normal(0.0154, 0.1337) * width),
                   imgwidth - 3)
        ymax = min(max(ymin + 2, b[3] + rng.normal(-0.0013, 0.0711) * ht),
                   imght - 3)
    return np.array([xmin, ymin, xmax, ymax], np.float32)


def _box_center_scale_np(bbox_xyxy, aspect_ratio, scale_mult=1.25):
    x0, y0, x1, y1 = bbox_xyxy
    w, h = x1 - x0, y1 - y0
    cx, cy = x0 + 0.5 * w, y0 + 0.5 * h
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return np.array([cx, cy], np.float32), \
        np.array([w, h], np.float32) * scale_mult


def _half_body(joints_xy, joints_vis, aspect_ratio, rng):
    """simple_transform.py:253-296."""
    upper, lower = [], []
    for j in range(joints_xy.shape[0]):
        if joints_vis[j] > 0:
            (upper if j in UPPER_BODY_IDS else lower).append(joints_xy[j])
    if rng.standard_normal() < 0.5 and len(upper) > 2:
        sel = upper
    else:
        sel = lower if len(lower) > 2 else upper
    if len(sel) < 2:
        return None, None
    sel = np.asarray(sel, np.float32)
    center = sel.mean(axis=0)
    lt, rb = sel.min(axis=0), sel.max(axis=0)
    w, h = rb[0] - lt[0], rb[1] - lt[1]
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.array([w, h], np.float32) * 1.5


def train_sample_geometry(bboxes_xyxy: np.ndarray, joints_xy: np.ndarray,
                          joints_vis: np.ndarray, img_wh, input_size:
                          Tuple[int, int], aug: AugCfg, joint_pairs,
                          rng: np.random.Generator):
    """Per-sample augmented crop geometry for a training batch.

    img_wh: (width, height), or (N, 2) per-sample sizes.  Returns
    (inv_mats (N, 2, 3) dst->src with the flip folded in, flips (N,) bool,
    target joints_xy in input space (N, K, 2), joints_vis (N, K), fwd_mats
    (N, 2, 3) src->dst with the flip folded in).
    """
    n = joints_xy.shape[0]
    inp_h, inp_w = input_size
    ar = inp_w / inp_h
    if np.ndim(img_wh) == 2:
        widths, heights = np.asarray(img_wh)[:, 0], np.asarray(img_wh)[:, 1]
    else:
        widths = np.full(n, img_wh[0])
        heights = np.full(n, img_wh[1])
    widths = widths.astype(np.float32)

    # pass 1: the per-sample rng draws and branches, in the fixed order
    jxy_all = joints_xy.astype(np.float32).copy()
    jv_all = joints_vis.astype(np.float32).copy()
    centers = np.zeros((n, 2), np.float32)
    scales = np.zeros((n, 2), np.float32)
    rots = np.zeros(n, np.float32)
    flips = np.zeros(n, bool)
    sf, rf = aug.scale_factor, aug.rot_factor
    jv_sums = jv_all.sum(axis=1)
    if not aug.add_dpg:
        # aspect-pad the boxes and scale by 1.25 (no rng involved)
        bbf = np.asarray(bboxes_xyxy, np.float32)
        bw, bh = bbf[:, 2] - bbf[:, 0], bbf[:, 3] - bbf[:, 1]
        c_all = np.stack([bbf[:, 0] + 0.5 * bw, bbf[:, 1] + 0.5 * bh], 1)
        w_adj = np.where(bw < ar * bh, bh * ar, bw)
        h_adj = np.where(bw > ar * bh, bw / ar, bh)
        s_all = np.stack([w_adj, h_adj], 1) * 1.25
    for i in range(n):
        if aug.add_dpg:
            bb = add_dpg(bboxes_xyxy[i], widths[i], heights[i], rng)
            center, scale = _box_center_scale_np(bb, ar)
        else:
            center, scale = c_all[i], s_all[i]
        if (jv_sums[i] > aug.num_joints_half_body
                and rng.uniform() < aug.prob_half_body):
            c_h, s_h = _half_body(jxy_all[i], jv_all[i], ar, rng)
            if c_h is not None:
                center, scale = c_h, s_h
        centers[i] = center
        scales[i] = scale * np.clip(rng.standard_normal() * sf + 1,
                                    1 - sf, 1 + sf)
        rots[i] = (np.clip(rng.standard_normal() * rf, -rf * 2, rf * 2)
                   if rng.uniform() <= 0.6 else 0.0)
        if aug.flip and rng.uniform() > 0.5:
            flips[i] = True

    # pass 2: batched flip / affine / joint-map math
    # flip joints (transforms.py:521-547): x' = w - x - 1, pair swap, x *= vis
    if flips.any():
        f = flips
        jxy_all[f, :, 0] = widths[f, None] - jxy_all[f, :, 0] - 1
        if joint_pairs:
            pa = np.asarray([p[0] for p in joint_pairs])
            pb = np.asarray([p[1] for p in joint_pairs])
            tmp = jxy_all[np.ix_(f, pa)].copy()
            jxy_all[np.ix_(f, pa)] = jxy_all[np.ix_(f, pb)]
            jxy_all[np.ix_(f, pb)] = tmp
            tmpv = jv_all[np.ix_(f, pa)].copy()
            jv_all[np.ix_(f, pa)] = jv_all[np.ix_(f, pb)]
            jv_all[np.ix_(f, pb)] = tmpv
        jxy_all[f, :, 0] *= jv_all[f]
        centers[f, 0] = widths[f] - centers[f, 0] - 1

    # batched similarity affines (the vector twin of np_affine_transform)
    dst_w, dst_h = float(inp_w), float(inp_h)
    rr = np.deg2rad(rots.astype(np.float64))
    cs, sn = np.cos(rr), np.sin(rr)
    src_w = scales[:, 0].astype(np.float64)
    s = dst_w / src_w
    cx, cy = centers[:, 0].astype(np.float64), centers[:, 1].astype(np.float64)
    fwd_mats = np.empty((n, 2, 3), np.float32)
    m00, m01 = s * cs, s * sn
    m10, m11 = -s * sn, s * cs
    fwd_mats[:, 0, 0], fwd_mats[:, 0, 1] = m00, m01
    fwd_mats[:, 1, 0], fwd_mats[:, 1, 1] = m10, m11
    fwd_mats[:, 0, 2] = dst_w * 0.5 - (m00 * cx + m01 * cy)
    fwd_mats[:, 1, 2] = dst_h * 0.5 - (m10 * cx + m11 * cy)
    inv_mats = np.empty((n, 2, 3), np.float32)
    inv_s = src_w / dst_w
    i00, i01 = inv_s * cs, -inv_s * sn
    i10, i11 = inv_s * sn, inv_s * cs
    inv_mats[:, 0, 0], inv_mats[:, 0, 1] = i00, i01
    inv_mats[:, 1, 0], inv_mats[:, 1, 1] = i10, i11
    inv_mats[:, 0, 2] = cx - (i00 * dst_w * 0.5 + i01 * dst_h * 0.5)
    inv_mats[:, 1, 2] = cy - (i10 * dst_w * 0.5 + i11 * dst_h * 0.5)

    # the joints map through the unflipped fwd (they are already flipped),
    # so map them before the flip is folded into the matrices
    mapped = (np.einsum("nij,nkj->nki", fwd_mats[:, :, :2], jxy_all)
              + fwd_mats[:, None, :, 2])
    vis_mask = (jv_all > 0)[..., None]
    out_joints = np.where(vis_mask, mapped, jxy_all).astype(np.float32)

    if flips.any():
        f = flips
        # the flipped image's pixel sx reads the original at width-1-sx
        inv_mats[f, 0, 2] = widths[f] - 1 - inv_mats[f, 0, 2]
        inv_mats[f, 0, 0] = -inv_mats[f, 0, 0]
        inv_mats[f, 0, 1] = -inv_mats[f, 0, 1]
        # and dst = fwd(w-1-x, y) for the src->dst map
        fwd_flip = fwd_mats[f]
        fwd_flip[:, :, 2] += fwd_flip[:, :, 0] * (widths[f, None] - 1)
        fwd_flip[:, :, 0] = -fwd_flip[:, :, 0]
        fwd_mats[f] = fwd_flip

    return inv_mats, flips, out_joints, jv_all, fwd_mats


def eval_sample_geometry(bboxes_xyxy: np.ndarray,
                         input_size: Tuple[int, int], want_fwd: bool = False):
    """Deterministic eval-crop geometry: (inv_mats (N, 2, 3), bbox_crop
    (N, 4)), and with want_fwd the src->dst mats too."""
    inp_h, inp_w = input_size
    ar = inp_w / inp_h
    n = bboxes_xyxy.shape[0]
    inv_mats = np.zeros((n, 2, 3), np.float32)
    fwd_mats = np.zeros((n, 2, 3), np.float32)
    bbox_crop = np.zeros((n, 4), np.float32)
    for i in range(n):
        center, scale = _box_center_scale_np(bboxes_xyxy[i], ar)
        inv_mats[i] = np_affine_transform(center, scale, 0.0,
                                          (inp_w, inp_h), inv=True)
        if want_fwd:
            fwd_mats[i] = np_affine_transform(center, scale, 0.0,
                                              (inp_w, inp_h))
        bbox_crop[i] = [center[0] - scale[0] / 2, center[1] - scale[1] / 2,
                        center[0] + scale[0] / 2, center[1] + scale[1] / 2]
    if want_fwd:
        return inv_mats, bbox_crop, fwd_mats
    return inv_mats, bbox_crop


def pad_to(arr: np.ndarray, n: int, axis: int = 0):
    """Pad along axis to length n with zeros (static-shape batching)."""
    pad = n - arr.shape[axis]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def bucket_size(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)):
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024
