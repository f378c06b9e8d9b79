"""COCO keypoint mAP evaluation (the port's own copy of
vatl4pose_tpu/eval/cocoeval.py, numpy on the host).

It reproduces the reference's VENDORED cocoapi (data/coco/cocoapi/
PythonAPI/pycocotools/{coco,cocoeval}.py), which the reference patched
away from upstream pycocotools in ways that change the numbers; the AL
loop reaches it through alphapose/utils/metrics.py:65-115 (evaluate_mAP).

Vendored deviations from upstream pycocotools reproduced here:
  - stats vector (cocoeval.py:484-496 _summarizeKps): AP at IoU
    .5/.6/.7/.75/.8/.95 plus AP(M)/AP(L)/AR —
    ['AP','AP .5','AP .6','AP .7','AP .75','AP .8','AP .95',
     'AP (M)','AP (L)','AR'] (the keys metrics.py:111 reads).
  - maxDets = [100] for keypoints (cocoeval.py:530), not upstream's 20.
  - gt ignore = iscrowd only (cocoeval.py:109-110 — line 110 overwrites
    the 'ignore'-field read, and there is no num_keypoints ignore).
  - gt area falls back to bbox w*h when absent (cocoeval.py:211,248 —
    the AL loop's GT_kpt.json entries carry no 'area',
    ActiveLearning.py:311-327).
  - dt area from loadRes (coco.py:335-364): a detection WITH a non-empty
    'bbox' takes area = (bb[2]-bb[0])*(bb[3]-bb[1]) — the vendored patch
    applies the xyxy formula to the AL loop's xywh boxes — and only
    bbox-less detections get the keypoint-extent area.  Pre-existing
    'area' fields are overwritten either way.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Union

import numpy as np

from ..ops.oks import COCO_SIGMAS
from ..utils.profiling import span

IOU_THRS = np.linspace(.5, .95, 10)
REC_THRS = np.linspace(.0, 1.00, 101)
AREA_RNG = {"all": (0.0, 1e10), "medium": (32 ** 2, 96 ** 2),
            "large": (96 ** 2, 1e10)}
MAX_DET = 100
STAT_KEYS = ["AP", "AP .5", "AP .6", "AP .7", "AP .75", "AP .8", "AP .95",
             "AP (M)", "AP (L)", "AR"]

__all__ = ["evaluate_map", "STAT_KEYS"]


def _load(obj):
    if isinstance(obj, str):
        with open(obj) as f:
            return json.load(f)
    return obj


def _dt_area(ann):
    """Vendored COCO.loadRes area (coco.py:335-364): the 'bbox' branch wins
    when present and applies (bb[2]-bb[0])*(bb[3]-bb[1]); otherwise the
    keypoint-extent area.  Overwrites any pre-existing 'area'."""
    bb = ann.get("bbox")
    if bb is not None and bb != []:
        return float((bb[2] - bb[0]) * (bb[3] - bb[1]))
    kp = np.asarray(ann["keypoints"], np.float64)
    x, y = kp[0::3], kp[1::3]
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    return float((x1 - x0) * (y1 - y0))


def _compute_oks_matrix(dts, gts, sigmas):
    var = (np.asarray(sigmas) * 2) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = np.count_nonzero(vg > 0)
        bb = gt["bbox"]
        x0 = bb[0] - bb[2]; x1 = bb[0] + bb[2] * 2
        y0 = bb[1] - bb[3]; y1 = bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                z = np.zeros(k)
                dx = np.max((z, x0 - xd), axis=0) + np.max((z, xd - x1), axis=0)
                dy = np.max((z, y0 - yd), axis=0) + np.max((z, yd - y1), axis=0)
            e = (dx ** 2 + dy ** 2) / var / (gt["_area"] + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


@span("eval.map")
def evaluate_map(res: Union[str, list], ann: Union[str, dict],
                 sigmas=None) -> Dict[str, float]:
    """COCO keypoints evaluation of `res` (list of detection annotations)
    against `ann` (COCO-format GT dict).  Both accept paths or objects."""
    sigmas = COCO_SIGMAS if sigmas is None else np.asarray(sigmas)
    gt_data = _load(ann)
    dt_list = _load(res)

    # sorted unique ids — COCOeval's p.imgIds ordering, which fixes the
    # stable tie order of the global score sort in accumulate
    img_ids = sorted({im.get("id", im.get("image_id"))
                      for im in gt_data["images"]})
    gts_by_img = defaultdict(list)
    for g in gt_data["annotations"]:
        g = dict(g)
        # vendored cocoeval.py:110 — ignore = iscrowd only (overwrites the
        # 'ignore'-field read on :109; no num_keypoints ignore exists)
        g["_ignore0"] = bool(g.get("iscrowd", 0))
        g["_area"] = float(g.get("area", g["bbox"][2] * g["bbox"][3]))
        gts_by_img[g["image_id"]].append(g)
    dts_by_img = defaultdict(list)
    for d in dt_list:
        d = dict(d)
        d["_area"] = _dt_area(d)
        dts_by_img[d["image_id"]].append(d)

    T, R, A = len(IOU_THRS), len(REC_THRS), len(AREA_RNG)
    area_names = list(AREA_RNG)

    # per-image evaluation
    eval_imgs = {}
    for iid in img_ids:
        gts = gts_by_img.get(iid, [])
        dts = sorted(dts_by_img.get(iid, []),
                     key=lambda d: -d["score"])[:MAX_DET]
        if not gts and not dts:
            continue
        ious = _compute_oks_matrix(dts, gts, sigmas) if (gts and dts) else \
            np.zeros((len(dts), len(gts)))
        per_area = []
        for aname in area_names:
            a0, a1 = AREA_RNG[aname]
            gt_ig = np.array([1 if (g["_ignore0"] or g["_area"] < a0
                                    or g["_area"] > a1) else 0
                              for g in gts])
            gtind = np.argsort(gt_ig, kind="mergesort")
            gt_ig = gt_ig[gtind]
            crowd = np.array([int(g.get("iscrowd", 0)) for g in gts],
                             np.int64)[gtind] if gts else np.zeros(0, np.int64)
            iou_s = ious[:, gtind] if ious.size else ious
            G, D = len(gts), len(dts)
            gtm = np.zeros((T, G))
            dtm = np.zeros((T, D))
            dt_ig = np.zeros((T, D))
            if len(gts) and len(dts):
                for tind, t in enumerate(IOU_THRS):
                    for dind in range(D):
                        iou = min(t, 1 - 1e-10)
                        m = -1
                        for gind in range(G):
                            # matched gts are closed except crowds, which
                            # may absorb further dts (cocoeval.py:279-280)
                            if gtm[tind, gind] > 0 and not crowd[gind]:
                                continue
                            if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                                break
                            if iou_s[dind, gind] < iou:
                                continue
                            iou = iou_s[dind, gind]
                            m = gind
                        if m == -1:
                            continue
                        dt_ig[tind, dind] = gt_ig[m]
                        dtm[tind, dind] = 1
                        gtm[tind, m] = 1
            a_out = np.array([d["_area"] < a0 or d["_area"] > a1
                              for d in dts])
            if D:
                dt_ig = np.logical_or(
                    dt_ig, np.logical_and(dtm == 0,
                                          np.tile(a_out, (T, 1))))
            per_area.append({
                "dtm": dtm, "dt_ig": dt_ig,
                "scores": np.array([d["score"] for d in dts]),
                "n_gt": int(np.count_nonzero(gt_ig == 0)),
            })
        eval_imgs[iid] = per_area

    precision = -np.ones((T, R, A))
    recall = -np.ones((T, A))
    for ai in range(A):
        rows = [eval_imgs[iid][ai] for iid in img_ids if iid in eval_imgs]
        if not rows:
            continue
        scores = np.concatenate([r["scores"] for r in rows])
        order = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([r["dtm"] for r in rows], axis=1)[:, order]
        dt_ig = np.concatenate([r["dt_ig"] for r in rows], axis=1)[:, order]
        npig = sum(r["n_gt"] for r in rows)
        if npig == 0:
            continue
        tps = np.logical_and(dtm, np.logical_not(dt_ig))
        fps = np.logical_and(np.logical_not(dtm), np.logical_not(dt_ig))
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
        for t in range(T):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            recall[t, ai] = rc[-1] if nd else 0
            q = np.zeros(R)
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, REC_THRS, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[t, :, ai] = q

    def _ap(t=None, area="all"):
        ai = area_names.index(area)
        s = precision[:, :, ai] if t is None else \
            precision[IOU_THRS.tolist().index(t), :, ai]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _ar(t=None, area="all"):
        ai = area_names.index(area)
        s = recall[:, ai] if t is None else \
            recall[IOU_THRS.tolist().index(t), ai:ai + 1]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    # vendored _summarizeKps layout (cocoeval.py:484-496)
    stats = [_ap(), _ap(.5), _ap(.6), _ap(.7), _ap(.75), _ap(.8), _ap(.95),
             _ap(area="medium"), _ap(area="large"), _ar()]
    return dict(zip(STAT_KEYS, stats))
