"""OSPA pose metric (Optimal Sub-Pattern Assignment; the port's own copy
of vatl4pose_tpu/eval/ospa.py, numpy and scipy on the host).

JRDB_toolkit/pose_eval.py:177-367 — per frame: Hungarian assignment on a
(1 - OKS) cost matrix (JRDB sigmas, GT 'area' field when present),
matching cost + cardinality penalty over max(G, P), averaged over frames.
Inherits the reference's empty-set conventions (both empty → 0; GT empty &
preds present → 1; GT size != 1 & preds empty → 1 — including the
len(gt) != 1 quirk noted in SURVEY §7).
"""

from __future__ import annotations

import json
from typing import Union

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..ops.oks import JRDB_SIGMAS, oks_matrix
from ..utils.profiling import span

__all__ = ["ospa_for_loc", "get_ospa"]


def _load(obj):
    if isinstance(obj, str):
        with open(obj) as f:
            return json.load(f)
    return obj


def get_ospa(gt_annots, pr_annots, sigmas=None):
    if len(gt_annots) == 0 and len(pr_annots) == 0:
        return 0
    if len(gt_annots) == 0 and len(pr_annots) != 0:
        return 1
    if len(gt_annots) != 1 and len(pr_annots) == 0:
        return 1
    if len(pr_annots) == 0:
        # the len(gt)==1 case falls through the quirk above in the
        # reference too (pose_eval.py:324): empty assignment, cost 0,
        # cardinality 1, max(G,P)=1 → 1.0
        return 1.0
    sig = JRDB_SIGMAS if sigmas is None else sigmas
    gk = np.array([g["keypoints"] for g in gt_annots], np.float64)
    pk = np.array([p["keypoints"] for p in pr_annots], np.float64)
    gb = np.array([g["bbox"] for g in gt_annots], np.float64)
    ga = np.array([g.get("area", g["bbox"][2] * g["bbox"][3])
                   for g in gt_annots], np.float64)
    cost = 1 - oks_matrix(gk, gb, ga, pk, variances=(np.asarray(sig) * 2) ** 2)
    gi, pi = linear_sum_assignment(cost)
    num_gt, num_pr = len(gt_annots), len(pr_annots)
    matching = cost[gi, pi].sum()
    cardinality = abs(num_gt - num_pr)
    return (matching + cardinality) / max(num_gt, num_pr)


@span("eval.ospa")
def ospa_for_loc(ann_json_path: Union[str, dict],
                 pr_json_path: Union[str, list], sigmas=None) -> float:
    """Mean per-frame OSPA over all GT images (pose_eval.py:338-367)."""
    data_gt = _load(ann_json_path)
    data_pr = _load(pr_json_path)
    all_iids = [im["id"] for im in data_gt["images"]]
    gt_by = {iid: [] for iid in all_iids}
    for ann in data_gt["annotations"]:
        gt_by[ann["image_id"]].append(ann)
    pr_by = {iid: [] for iid in all_iids}
    for ann in data_pr:
        if ann["image_id"] in pr_by:
            pr_by[ann["image_id"]].append(ann)
    scores = [get_ospa(gt_by.get(iid, []), pr_by.get(iid, []), sigmas)
              for iid in all_iids]
    return float(np.mean(scores))
