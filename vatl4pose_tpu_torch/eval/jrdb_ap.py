"""JRDB keypoint AP: greedy per-joint PCK-match average precision (the
port's own copy of vatl4pose_tpu/eval/jrdb_ap.py, numpy on the host).

Parity: JRDB_toolkit/pose_eval.py:370-595 (computeRPC / VOCap /
computeMetrics / average_precision_for_loc); the JAX package's copy is
cross-checked to 1e-9 against that code in tests/test_eval_parity.py, and
this one against the JAX package's in tests/test_torch_tracking.py.

Per frame: per-keypoint OKS with visibility forced on
(get_per_kp_oks_matrix, :127-175) thresholded at oks_threshold gives a PCK
count matrix; GT→prediction matching is greedy by
PCK count (:528-539); per-joint TP/FP labels accumulate into VOC-style
interpolated AP.

Reference quirks replicated deliberately (they shape the published numbers):
  - The label-emission loop (:541-568) iterates an index over the
    PREDICTION count but tests it against MATCHED-GT values: entry order is
    by matched-gt index, and the false-positive branch re-uses that index
    into prFrames — so with more predictions than GTs the FP entries come
    from prFrames[G:], not from the actually-unmatched predictions.
  - Joints that never accumulate scores keep AP 0 (computeMetrics zero
    init, :412) and still count in the final mean.
  - Unmatched-prediction forgiveness tests keypoint-extent boxes against
    unlabeled GT boxes at IOU_THRESHOLD = 0.5 (:12, :555-557), where
    unlabeled boxes are box-file entries whose track_id appears in no pose
    annotation (get_unseen_boxes, :289-299).
"""

from __future__ import annotations

import json
from typing import Optional, Union

import numpy as np

from ..ops.oks import JRDB_SIGMAS

__all__ = ["IOU_THRESHOLD", "average_precision_for_loc"]

IOU_THRESHOLD = 0.5


def _per_kp_oks_matrix(gt_annots, pr_annots, sigmas=JRDB_SIGMAS):
    """(G, P, K) per-keypoint OKS with vg forced to ones
    (pose_eval.py:127-175 get_per_kp_oks_matrix)."""
    var = (np.asarray(sigmas) * 2) ** 2
    G, P = len(gt_annots), len(pr_annots)
    K = len(sigmas)
    out = np.zeros((G, P, K))
    for j, gt in enumerate(gt_annots):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg = g[0::3], g[1::3]
        bb = gt["bbox"]
        area = gt.get("area", bb[2] * bb[3])
        for i, dt in enumerate(pr_annots):
            d = np.asarray(dt["keypoints"], np.float64)
            dx = d[0::3] - xg
            dy = d[1::3] - yg
            e = (dx ** 2 + dy ** 2) / var / (area + np.spacing(1)) / 2
            out[j, i] = np.exp(-e)
    return out


def _matrix_iou(a, b):
    """a (4, Na) xyxy columns, b (4, Nb) → (Na, Nb) IoU (pose_eval
    matrix_iou values; only its max vs IOU_THRESHOLD is consumed)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0 = np.maximum(ax0[:, None], bx0[None, :])
    iy0 = np.maximum(ay0[:, None], by0[None, :])
    ix1 = np.minimum(ax1[:, None], bx1[None, :])
    iy1 = np.minimum(ay1[:, None], by1[None, :])
    iw = np.maximum(0, ix1 - ix0)
    ih = np.maximum(0, iy1 - iy0)
    inter = iw * ih
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-12)


def _boxes_from_annos(annos):
    """Keypoint-extent boxes, (4, N) columns (pose_eval boxes_from_annos)."""
    cols = []
    for a in annos:
        kp = np.asarray(a["keypoints"], np.float64)
        x, y = kp[0::3], kp[1::3]
        cols.append([x.min(), y.min(), x.max(), y.max()])
    return np.asarray(cols).T if cols else np.zeros((4, 0))


def _unseen_boxes(box_entries, annos):
    """Box-file entries whose track id is absent from the pose annotations,
    as (4, N) xyxy columns (pose_eval.py:289-299 get_unseen_boxes; boxes are
    {'label_id': '...:<tid>', 'box': [x, y, w, h]})."""
    seen = {a.get("track_id") for a in annos}
    cols = []
    for box in box_entries:
        tid = int(str(box["label_id"]).split(":")[-1])
        if tid not in seen:
            x, y, w, h = box["box"]
            cols.append([x, y, x + w, y + h])
    return np.asarray(cols).T if cols else np.zeros((4, 0))


def _voc_ap(rec, prec):
    """VOCap (pose_eval.py:391-408)."""
    mpre = np.zeros(len(prec) + 2)
    mpre[1:len(prec) + 1] = prec
    mrec = np.zeros(len(rec) + 2)
    mrec[1:len(rec) + 1] = rec
    mrec[len(rec) + 1] = 1.0
    for i in range(mpre.size - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.argwhere(~np.equal(mrec[1:], mrec[:-1])).flatten() + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def _forgiven(pr, unl):
    """Unmatched prediction overlaps an unlabeled box (pose_eval.py:555-557)."""
    if unl.shape[1] == 0:
        return False
    return bool((_matrix_iou(unl, _boxes_from_annos([pr]))
                 > IOU_THRESHOLD).max())


def average_precision_for_loc(data_gt: Union[str, dict],
                              data_pr: Union[str, dict],
                              unlabeled_boxes: Optional[dict] = None,
                              oks_threshold: float = 0.5,
                              n_joints: int = 17):
    """Returns (ap_list, recall_list) of length n_joints+1 (last = mean),
    values in percent (pose_eval.py:439-595).

    unlabeled_boxes: the reference's box-file dict
    {'labels': {'%06d.jpg' % (image_id - 1): [{'label_id', 'box'}, ...]}}
    (or None for no forgiveness, the mode the shipped experiments use)."""
    if isinstance(data_gt, str):
        with open(data_gt) as f:
            data_gt = json.load(f)
    if isinstance(data_pr, str):
        with open(data_pr) as f:
            data_pr = json.load(f)
    pr_anns = data_pr["annotations"] if isinstance(data_pr, dict) else data_pr
    box_labels = (unlabeled_boxes or {}).get("labels", {})

    all_iids = [im["id"] for im in data_gt["images"]]
    gt_by = {iid: [] for iid in all_iids}
    for a in data_gt["annotations"]:
        gt_by[a["image_id"]].append(a)
    pr_by = {iid: [] for iid in all_iids}
    for a in pr_anns:
        if a["image_id"] in pr_by:
            pr_by[a["image_id"]].append(a)

    scores_all = [[np.zeros(0, np.float32) for _ in all_iids]
                  for _ in range(n_joints)]
    labels_all = [[np.zeros(0, np.int8) for _ in all_iids]
                  for _ in range(n_joints)]
    n_gt_all = np.zeros((n_joints, len(all_iids)))

    def emit(ii, labels):
        for k in range(n_joints):
            scores_all[k][ii] = np.append(scores_all[k][ii], 1.0)
            labels_all[k][ii] = np.append(labels_all[k][ii], int(labels[k]))

    for ii, iid in enumerate(all_iids):
        gts = gt_by[iid]
        prs = pr_by[iid]
        unl = _unseen_boxes(box_labels.get("{:06d}.jpg".format(iid - 1), []),
                            gts)

        if gts and prs:
            match = _per_kp_oks_matrix(gts, prs) > oks_threshold  # (G, P, K)
            pck = match.sum(-1)                                   # (G, P)
            # greedy GT->prediction matching (pose_eval.py:528-539)
            pr_to_gt = np.full(len(prs), -1)
            left = list(range(len(prs)))
            for g in range(len(gts)):
                t = int(pck[g, left].argmax())
                m = left[t]
                del left[t]
                pr_to_gt[m] = g
                if not left:
                    break
            # label emission in the reference's order: the loop index runs
            # over predictions but selects MATCHED-GT values first
            # (pose_eval.py:541-568) — see module docstring
            for ridx in range(len(prs)):
                hit = np.argwhere(pr_to_gt == ridx)
                if hit.size:
                    assert hit.size == 1
                    emit(ii, match[ridx, hit[0, 0], :])
                elif not _forgiven(prs[ridx], unl):
                    emit(ii, np.zeros(n_joints))
        elif not gts:
            for p in range(len(prs)):
                if not _forgiven(prs[p], unl):
                    emit(ii, np.zeros(n_joints))

        n_gt_all[:, ii] += len(gts)

    # computeMetrics (pose_eval.py:411-437): zero init — dataless joints
    # keep AP 0 and still enter the mean
    ap = np.zeros(n_joints + 1)
    rec = np.zeros(n_joints + 1)
    for k in range(n_joints):
        scores = np.concatenate(scores_all[k])
        labels = np.concatenate(labels_all[k])
        n_gt = n_gt_all[k].sum()
        if len(scores) == 0:
            continue
        # computeRPC (:370-388) — same argsort call as the reference so
        # equal-score tie order is bit-identical
        order = np.asarray(scores).argsort()[::-1]
        ls = labels[order]
        with np.errstate(divide="ignore", invalid="ignore"):
            tp = np.cumsum(ls == 1)
            recall = tp / n_gt
            precision = tp / np.arange(1, len(ls) + 1)
            ap[k] = _voc_ap(recall, precision) * 100
            rec[k] = recall[-1] * 100
    with np.errstate(invalid="ignore"):
        ap[n_joints] = ap[:n_joints][~np.isnan(ap[:n_joints])].mean()
        rec[n_joints] = rec[:n_joints][~np.isnan(rec[:n_joints])].mean()
    return ap.tolist(), rec.tolist()
