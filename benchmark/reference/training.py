"""The plain retraining steps: VATL's retrain_model (AdamW with a
learning rate per top-level module, weight decay, an exponential decay per
epoch, shuffled batches, the last one cycle-padded) on SimpleBaseline's
training transform, written out in float32 torch and numpy.

The augmentation is drawn from a numpy Generator in the order the
published transform draws it per sample (a half-body gate where enough
joints are visible, the half-body choice, the scale, the rotation gate and
angle, the flip), after one permutation of the labeled rows per epoch; the
crop is the bilinear warp of reference.scoring at the augmented affine;
the target is the unnormalised Gaussian of sigma 2 at the joint's
rounded heatmap cell, cut at 3 sigma, weight 0 where that window misses
the map; the loss is 0.5 * the mean squared error of the masked maps over
the real rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scoring
from .models import build_estimator, lr_mult
from .layers import set_tf32

__all__ = ["geometry", "target", "follow_steps"]

UPPER_BODY = tuple(range(11))


def _half_body(jxy, jv, ar, rng):
    upper = [jxy[j] for j in range(len(jv)) if jv[j] > 0 and j in UPPER_BODY]
    lower = [jxy[j] for j in range(len(jv))
             if jv[j] > 0 and j not in UPPER_BODY]
    if rng.standard_normal() < 0.5 and len(upper) > 2:
        sel = upper
    else:
        sel = lower if len(lower) > 2 else upper
    if len(sel) < 2:
        return None, None
    sel = np.asarray(sel, np.float32)
    lt, rb = sel.min(0), sel.max(0)
    w, h = rb[0] - lt[0], rb[1] - lt[1]
    if w > ar * h:
        h = w / ar
    elif w < ar * h:
        w = h * ar
    return sel.mean(0), np.array([w, h], np.float32) * 1.5


def geometry(boxes, jxy, jv, img_wh, input_size, aug, pairs, rng):
    """Per-sample augmented crops of one batch: (dst->src affines
    (N, 2, 3), joints in input space (N, K, 2), visibility (N, K))."""
    n = len(boxes)
    h_in, w_in = input_size
    ar = w_in / h_in
    img_w = float(img_wh[0])
    jxy = jxy.astype(np.float32).copy()
    jv = jv.astype(np.float32).copy()
    b = boxes.astype(np.float32)
    bw, bh = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    centers = np.stack([b[:, 0] + 0.5 * bw, b[:, 1] + 0.5 * bh], 1)
    scales = np.stack([np.where(bw < ar * bh, bh * ar, bw),
                       np.where(bw > ar * bh, bw / ar, bh)], 1) * 1.25
    rots = np.zeros(n, np.float32)
    flips = np.zeros(n, bool)
    sf, rf = aug["SCALE_FACTOR"], aug["ROT_FACTOR"]
    for i in range(n):
        if (jv[i].sum() > aug["NUM_JOINTS_HALF_BODY"]
                and rng.uniform() < aug["PROB_HALF_BODY"]):
            c, s = _half_body(jxy[i], jv[i], ar, rng)
            if c is not None:
                centers[i], scales[i] = c, s
        scales[i] = scales[i] * np.clip(rng.standard_normal() * sf + 1,
                                        1 - sf, 1 + sf)
        rots[i] = (np.clip(rng.standard_normal() * rf, -rf * 2, rf * 2)
                   if rng.uniform() <= 0.6 else 0.0)
        if aug["FLIP"] and rng.uniform() > 0.5:
            flips[i] = True
    for i in np.flatnonzero(flips):
        jxy[i, :, 0] = img_w - jxy[i, :, 0] - 1
        for a, c in pairs:
            jxy[i, [a, c]] = jxy[i, [c, a]]
            jv[i, [a, c]] = jv[i, [c, a]]
        jxy[i, :, 0] *= jv[i]
        centers[i, 0] = img_w - centers[i, 0] - 1
    rr = np.deg2rad(rots.astype(np.float64))
    cs, sn = np.cos(rr), np.sin(rr)
    src_w = scales[:, 0].astype(np.float64)
    cx, cy = centers[:, 0].astype(np.float64), centers[:, 1].astype(np.float64)
    s = w_in / src_w
    fwd = np.empty((n, 2, 3), np.float32)
    fwd[:, 0, :2] = np.stack([s * cs, s * sn], 1)
    fwd[:, 1, :2] = np.stack([-s * sn, s * cs], 1)
    fwd[:, 0, 2] = w_in * 0.5 - (s * cs * cx + s * sn * cy)
    fwd[:, 1, 2] = h_in * 0.5 - (-s * sn * cx + s * cs * cy)
    inv_s = src_w / w_in
    inv = np.empty((n, 2, 3), np.float32)
    inv[:, 0, :2] = np.stack([inv_s * cs, -inv_s * sn], 1)
    inv[:, 1, :2] = np.stack([inv_s * sn, inv_s * cs], 1)
    inv[:, 0, 2] = cx - (inv_s * cs * w_in * 0.5 - inv_s * sn * h_in * 0.5)
    inv[:, 1, 2] = cy - (inv_s * sn * w_in * 0.5 + inv_s * cs * h_in * 0.5)
    mapped = np.einsum("nij,nkj->nki", fwd[:, :, :2], jxy) + fwd[:, None, :, 2]
    joints = np.where((jv > 0)[..., None], mapped, jxy).astype(np.float32)
    for i in np.flatnonzero(flips):
        inv[i, 0, 2] = img_w - 1 - inv[i, 0, 2]
        inv[i, 0, :2] = -inv[i, 0, :2]
    return inv, joints, jv


def target(joints, vis, hm_size, sigma):
    """Gaussian targets (N, K, H, W) and joint weights (N, K)."""
    H, W = hm_size
    r = int(sigma * 3)
    mx = torch.trunc(joints[..., 0] / 4.0 + 0.5).int()
    my = torch.trunc(joints[..., 1] / 4.0 + 0.5).int()
    out = (mx - r >= W) | (my - r >= H) | (mx + r + 1 < 0) | (my + r + 1 < 0)
    weight = torch.where(out, 0.0, vis)
    dx = torch.arange(W, device=joints.device, dtype=torch.int32) - mx[..., None]
    dy = torch.arange(H, device=joints.device, dtype=torch.int32) - my[..., None]
    gx = torch.exp(-dx.float() ** 2 / (2 * sigma ** 2)) * (dx.abs() <= r)
    gy = torch.exp(-dy.float() ** 2 / (2 * sigma ** 2)) * (dy.abs() <= r)
    g = gy[..., :, None] * gx[..., None, :]
    return g * (weight > 0.5).float()[..., None, None], weight


def follow_steps(cfg, weights, video, indices, seed, n_steps, device,
                 tf32=False):
    """The first `n_steps` retraining steps over the labeled rows
    `indices` (one epoch's batches at a time) from `weights`, with the
    retrainer's Generator seeded by `seed`.  Returns {"loss": [...],
    "grad": {leaf: |g| of step 1}, "change": {leaf: |p_n - p_0|}}."""
    model = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"]).to(device)
    model.load_state_dict(weights)
    set_tf32(model, tf32)
    model.train()
    rc, pre = cfg["RETRAIN"], cfg["DATA_PRESET"]
    input_size = tuple(pre["IMAGE_SIZE"])
    hm_size = tuple(pre["HEATMAP_SIZE"])
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    p0 = [p.detach().clone() for p in params]
    mult = [lr_mult(cfg["MODEL"]["TYPE"], n.split(".")[0]) for n in names]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, float(rc["WEIGHT_DECAY"])
    rng = np.random.default_rng(seed)
    bs = rc["BATCH_SIZE"]
    out = {"loss": [], "grad": {}, "change": {}}
    frames = video.frames
    step, epoch = 0, 0
    while step < n_steps:
        lr = rc["LR"] * rc["LR_GAMMA"] ** epoch
        order = rng.permutation(len(indices))
        for s in range(0, len(order), bs):
            if step == n_steps:
                break
            sel = np.resize(indices[order[s:s + bs]], bs)
            real = min(bs, len(order) - s)
            inv, joints, jv = geometry(
                video.bboxes[sel], video.joints_xy[sel], video.joints_vis[sel],
                (video.width, video.height), input_size, cfg["AUG"],
                video.joint_pairs, rng)
            x = scoring.crops(frames,
                              torch.as_tensor(video.frame_idx[sel],
                                              device=device),
                              torch.as_tensor(inv, device=device),
                              input_size).permute(0, 3, 1, 2)
            tgt, tw = target(torch.as_tensor(joints, device=device),
                             torch.as_tensor(jv, device=device), hm_size,
                             float(pre["SIGMA"]))
            pred = model(x)
            valid = (torch.arange(bs, device=device) < real).float()
            sq = ((pred - tgt) * tw[:, :, None, None]).square()
            loss = 0.5 * (sq.reshape(bs, -1).sum(1) * valid).sum() \
                / (real * sq[0].numel())
            for p in params:
                p.grad = None
            loss.backward()
            step += 1
            out["loss"].append(float(loss.detach()))
            with torch.no_grad():
                if step == 1:
                    out["grad"] = {n: float(p.grad.norm())
                                   for n, p in zip(names, params)}
                for i, p in enumerate(params):
                    g = p.grad
                    lr_i = lr * mult[i]
                    p.mul_(1 - lr_i * wd)
                    m[i].mul_(b1).add_(g, alpha=1 - b1)
                    v[i].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[i].sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                    p.addcdiv_(m[i], denom, value=-lr_i / (1 - b1 ** step))
        epoch += 1
    with torch.no_grad():
        out["change"] = {n: float((p - q).norm())
                         for n, p, q in zip(names, params, p0)}
    return out
