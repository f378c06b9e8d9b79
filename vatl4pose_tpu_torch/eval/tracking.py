"""Offline pose-tracking evaluation: HOTA, CLEAR (MOTA), Identity (IDF1),
OSPA2 over OKS similarity (the port's own copy of
vatl4pose_tpu/eval/tracking.py, numpy and scipy on the host).

Parity target: JRDB_toolkit/posetrack/ (TrackEval-style framework:
eval_pose.py + metrics/{hota,clear,identity,ospa2}.py), the offline
counterpart of the live per-round OSPA.  Published algorithms (TrackEval,
Luiten et al.; OSPA2, Rezatofighi et al.) over COCO-video jsons with track
ids.

Input: GT dict + predictions (each annotation: image_id, track_id,
keypoints, bbox/area[, score]).  Similarity = OKS with JRDB sigmas.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..ops.oks import JRDB_VARS, oks_kpts_matrix, oks_matrix

__all__ = ["hota", "clear", "identity", "ospa2", "evaluate_tracking",
           "combine_sequences"]


def _load(o):
    if isinstance(o, str):
        with open(o) as f:
            return json.load(f)
    return o


def _prepare(gt_data, pr_data, per_kpt: bool = False):
    """Per-frame gt/pred track-id arrays + OKS similarity matrices.

    The similarity counts ALL joints (force_visible — the toolkit's 'JRDB
    assumption: all joints are valid', jrdbpose.py:595-620).  With per_kpt,
    each frame also carries the (G, P, K) per-keypoint OKS terms and the
    GT keypoint-visibility levels (0 invisible / 1 occluded / 2 visible)
    for the occlusion-level OSPA2 (posetrack/metrics/ospa2.py).
    """
    gt_data = _load(gt_data)
    pr_data = _load(pr_data)
    pr_anns = pr_data["annotations"] if isinstance(pr_data, dict) else pr_data
    iids = [im["id"] for im in gt_data["images"]]
    gt_by, pr_by = defaultdict(list), defaultdict(list)
    for a in gt_data["annotations"]:
        gt_by[a["image_id"]].append(a)
    for a in pr_anns:
        if a["image_id"] in set(iids):
            pr_by[a["image_id"]].append(a)

    gt_track_ids = sorted({a["track_id"] for anns in gt_by.values()
                           for a in anns})
    pr_track_ids = sorted({a["track_id"] for anns in pr_by.values()
                           for a in anns})
    gt_map = {t: i for i, t in enumerate(gt_track_ids)}
    pr_map = {t: i for i, t in enumerate(pr_track_ids)}

    frames = []
    for iid in iids:
        gts, prs = gt_by[iid], pr_by[iid]
        g_ids = np.array([gt_map[a["track_id"]] for a in gts], int)
        p_ids = np.array([pr_map[a["track_id"]] for a in prs], int)
        kpt_sim = None
        kpt_vis = None
        if gts:
            gk = np.array([a["keypoints"] for a in gts], np.float64)
            kpt_vis = gk[:, 2::3].astype(int)
        if gts and prs:
            garea = np.array([a.get("area", a["bbox"][2] * a["bbox"][3])
                              for a in gts], np.float64)
            pk = np.array([a["keypoints"] for a in prs], np.float64)
            sim = oks_matrix(
                gk, np.array([a["bbox"] for a in gts], np.float64),
                garea, pk, variances=JRDB_VARS, force_visible=True)
            if per_kpt:
                kpt_sim = oks_kpts_matrix(gk, garea, pk,
                                          variances=JRDB_VARS)
        else:
            sim = np.zeros((len(gts), len(prs)))
        if per_kpt:
            frames.append((g_ids, p_ids, sim, kpt_sim, kpt_vis))
        else:
            frames.append((g_ids, p_ids, sim))
    return frames, len(gt_track_ids), len(pr_track_ids)


def hota(gt_data, pr_data) -> Dict[str, float]:
    """HOTA over 19 alpha thresholds (TrackEval hota.py semantics):
    per-alpha Hungarian matching biased by global association scores,
    HOTA_a = sqrt(DetA_a * AssA_a), final = mean over alphas."""
    frames, n_gt, n_pr = _prepare(gt_data, pr_data)
    alphas = np.arange(0.05, 0.99, 0.05)
    # global potential-match counts for association scoring
    pot = np.zeros((n_gt, n_pr))
    gt_cnt = np.zeros(n_gt)
    pr_cnt = np.zeros(n_pr)
    for g_ids, p_ids, sim in frames:
        gt_cnt[g_ids] += 1
        pr_cnt[p_ids] += 1
        if len(g_ids) and len(p_ids):
            pot[np.ix_(g_ids, p_ids)] += (sim >= 0.5 - np.finfo(float).eps)
    glob = pot / np.maximum(1.0, gt_cnt[:, None] + pr_cnt[None, :] - pot)

    n_alpha = len(alphas)
    res = {"HOTA": 0.0, "DetA": 0.0, "AssA": 0.0,
           # per-alpha counters — what combine_sequences aggregates
           # (the toolkit sums HOTA_TP/FN/FP and TP-weights AssA,
           # hota.py:157-169)
           "HOTA_TP": np.zeros(n_alpha), "HOTA_FN": np.zeros(n_alpha),
           "HOTA_FP": np.zeros(n_alpha), "AssA_arr": np.zeros(n_alpha),
           "DetA_arr": np.zeros(n_alpha), "HOTA_arr": np.zeros(n_alpha)}
    for ai, alpha in enumerate(alphas):
        tp = fn = fp = 0
        match_count = np.zeros((n_gt, n_pr))
        for g_ids, p_ids, sim in frames:
            if len(g_ids) and len(p_ids):
                score = glob[np.ix_(g_ids, p_ids)] + sim * np.finfo(float).eps
                rows, cols = linear_sum_assignment(-score)
                ok = sim[rows, cols] >= alpha - np.finfo(float).eps
                rows, cols = rows[ok], cols[ok]
                tp += len(rows)
                fn += len(g_ids) - len(rows)
                fp += len(p_ids) - len(rows)
                match_count[g_ids[rows], p_ids[cols]] += 1
            else:
                fn += len(g_ids)
                fp += len(p_ids)
        det_a = tp / max(1, tp + fn + fp)
        if tp > 0:
            union = (gt_cnt[:, None] + pr_cnt[None, :] - match_count)
            ass_per = match_count / np.maximum(union, 1)
            ass_a = float(np.sum(match_count * ass_per) / tp)
        else:
            ass_a = 0.0
        res["HOTA_TP"][ai] = tp
        res["HOTA_FN"][ai] = fn
        res["HOTA_FP"][ai] = fp
        res["DetA_arr"][ai] = det_a
        res["AssA_arr"][ai] = ass_a
        res["HOTA_arr"][ai] = np.sqrt(det_a * ass_a)
        res["DetA"] += det_a / n_alpha
        res["AssA"] += ass_a / n_alpha
        res["HOTA"] += np.sqrt(det_a * ass_a) / n_alpha
    return res


def clear(gt_data, pr_data, threshold: float = 0.5) -> Dict[str, float]:
    """CLEAR metrics (MOTA/MOTP/IDSW, TrackEval clear.py semantics with
    matched-in-previous-frame continuity bonus)."""
    frames, n_gt, n_pr = _prepare(gt_data, pr_data)
    tp = fn = fp = idsw = 0
    motp_sum = 0.0
    prev_match = {}          # gt track -> pr track
    for g_ids, p_ids, sim in frames:
        if len(g_ids) and len(p_ids):
            score = sim.copy()
            # continuity bonus: prefer previous-frame matches
            for i, g in enumerate(g_ids):
                if g in prev_match:
                    j = np.where(p_ids == prev_match[g])[0]
                    if len(j):
                        score[i, j[0]] += 1000 * (sim[i, j[0]] >= threshold)
            rows, cols = linear_sum_assignment(-score)
            ok = sim[rows, cols] >= threshold - np.finfo(float).eps
            rows, cols = rows[ok], cols[ok]
            tp += len(rows)
            fn += len(g_ids) - len(rows)
            fp += len(p_ids) - len(rows)
            motp_sum += float(sim[rows, cols].sum())
            new_match = {}
            for r, c in zip(rows, cols):
                g, p = int(g_ids[r]), int(p_ids[c])
                if g in prev_match and prev_match[g] != p:
                    idsw += 1
                new_match[g] = p
            prev_match.update(new_match)
        else:
            fn += len(g_ids)
            fp += len(p_ids)
    num_gt_dets = tp + fn
    mota = 1 - (fn + fp + idsw) / max(1, num_gt_dets)
    return {"MOTA": mota, "MOTP": motp_sum / max(1, tp),
            "MOTP_sum": motp_sum, "IDSW": idsw,
            "CLR_TP": tp, "CLR_FN": fn, "CLR_FP": fp}


def identity(gt_data, pr_data, threshold: float = 0.5) -> Dict[str, float]:
    """IDF1 (TrackEval identity.py): global trajectory-level bipartite
    matching of per-frame-matchable detections."""
    frames, n_gt, n_pr = _prepare(gt_data, pr_data)
    match_count = np.zeros((n_gt, n_pr))
    gt_cnt = np.zeros(n_gt)
    pr_cnt = np.zeros(n_pr)
    for g_ids, p_ids, sim in frames:
        gt_cnt[g_ids] += 1
        pr_cnt[p_ids] += 1
        if len(g_ids) and len(p_ids):
            match_count[np.ix_(g_ids, p_ids)] += (sim >= threshold)
    # pad to square cost with per-track FP/FN costs
    n = n_gt + n_pr
    cost = np.zeros((n, n))
    cost[:n_gt, :n_pr] = gt_cnt[:, None] + pr_cnt[None, :] \
        - 2 * match_count
    for i in range(n_gt):
        cost[i, n_pr:] = np.inf
        cost[i, n_pr + i] = gt_cnt[i]
    for j in range(n_pr):
        cost[n_gt:, j] = np.inf
        cost[n_gt + j, j] = pr_cnt[j]
    rows, cols = linear_sum_assignment(cost)
    idtp = 0.0
    for r, c in zip(rows, cols):
        if r < n_gt and c < n_pr:
            idtp += match_count[r, c]
    idfn = gt_cnt.sum() - idtp
    idfp = pr_cnt.sum() - idtp
    idf1 = idtp / max(1e-9, idtp + 0.5 * idfn + 0.5 * idfp)
    return {"IDF1": idf1, "IDTP": idtp, "IDFN": idfn, "IDFP": idfp}


def ospa2(gt_data, pr_data, occlusion_levels: bool = True
          ) -> Dict[str, float]:
    """OSPA2 (posetrack/metrics/ospa2.py eval_sequence): time-averaged
    pairwise track distance + Hungarian + cardinality term, plus the
    per-occlusion-level variants (OSPA_INVI/OSPA_OCCL/OSPA_VIS) computed on
    keypoint-visibility-masked per-keypoint distances with the SAME
    level-3 track matching (ospa2.py:58-97).
    """
    frames, n_gt, n_pr = _prepare(gt_data, pr_data,
                                  per_kpt=occlusion_levels)
    if n_gt == 0 and n_pr == 0:
        return {"OSPA": 0.0, "OSPA_CARD": 0.0, "OSPA_LOC": 0.0}
    n_levels = 4 if occlusion_levels else 1
    dist_sum = [np.zeros((n_gt, n_pr)) for _ in range(n_levels)]
    counts = np.zeros((n_gt, n_pr))
    for fr in frames:
        g_ids, p_ids, sim = fr[0], fr[1], fr[2]
        if len(p_ids) == 0:
            continue
        # level 3 (= the only level when occlusion_levels is off): full OKS
        d = np.zeros((n_gt, n_pr))
        d[g_ids] = 1
        counts[g_ids] += 1
        d[:, p_ids] = 1
        counts[:, p_ids] += 1
        if len(g_ids):
            d[np.ix_(g_ids, p_ids)] = 1 - sim
            counts[np.ix_(g_ids, p_ids)] -= 1
        dist_sum[-1] += d
        if occlusion_levels:
            kpt_sim, kpt_vis = fr[3], fr[4]
            for lvl in range(3):
                dl = np.zeros((n_gt, n_pr))
                dl[g_ids] = 1
                dl[:, p_ids] = 1
                if len(g_ids):
                    # mask per-keypoint distances to this visibility level;
                    # the mean divides by the count of NONZERO distances
                    # (the toolkit quirk at ospa2.py:64 — exact-hit
                    # keypoints drop out of the denominator)
                    mask = (kpt_vis == lvl)[:, None, :]
                    dist_k = (1 - kpt_sim) * mask
                    denom_k = np.maximum(1, np.sum(dist_k > 0, axis=-1))
                    dl[np.ix_(g_ids, p_ids)] = np.sum(dist_k, -1) / denom_k
                dist_sum[lvl] += dl
    counts[counts == 0] = 1
    trk_dist = dist_sum[-1] / counts
    m, n = n_gt, n_pr
    denom = max(m, n, 1)
    if n_gt and n_pr:
        rows, cols = linear_sum_assignment(trk_dist)
    else:
        rows = cols = np.array([], int)
    out = {}
    names = {0: "OSPA_INVI", 1: "OSPA_OCCL", 2: "OSPA_VIS", 3: "OSPA"}
    for i, ds in enumerate(dist_sum):
        lvl = 3 if not occlusion_levels else i
        cost = float((ds / counts)[rows, cols].sum())
        out[names[lvl]] = (abs(m - n) + cost) / denom
        if lvl == 3:
            out["OSPA_CARD"] = abs(m - n) / denom
            out["OSPA_LOC"] = cost / denom
    return out


def evaluate_tracking(gt_data, pr_data) -> Dict[str, float]:
    """All tracking metrics for one sequence."""
    out = {}
    out.update(hota(gt_data, pr_data))
    out.update(clear(gt_data, pr_data))
    out.update(identity(gt_data, pr_data))
    out.update(ospa2(gt_data, pr_data))
    return out


def combine_sequences(per_seq: Dict[str, Dict[str, float]]
                      ) -> Dict[str, float]:
    """Dataset-level aggregation over per-sequence results — the toolkit's
    combine_sequences semantics (hota.py:157-169: sum per-alpha counters,
    TP-weighted AssA; clear.py:130-136 / identity.py:119-124: sum counters,
    recompute finals; ospa2.py combine: plain average)."""
    seqs = list(per_seq.values())
    out: Dict[str, float] = {}

    # HOTA: per-alpha counter sums + TP-weighted association average
    tp = np.sum([s["HOTA_TP"] for s in seqs], axis=0)
    fn = np.sum([s["HOTA_FN"] for s in seqs], axis=0)
    fp = np.sum([s["HOTA_FP"] for s in seqs], axis=0)
    ass = np.sum([np.asarray(s["AssA_arr"]) * np.asarray(s["HOTA_TP"])
                  for s in seqs], axis=0) / np.maximum(1e-10, tp)
    det = tp / np.maximum(1, tp + fn + fp)
    out["HOTA"] = float(np.mean(np.sqrt(det * ass)))
    out["DetA"] = float(np.mean(det))
    out["AssA"] = float(np.mean(ass))

    # CLEAR: summed counters -> finals
    c_tp = sum(s["CLR_TP"] for s in seqs)
    c_fn = sum(s["CLR_FN"] for s in seqs)
    c_fp = sum(s["CLR_FP"] for s in seqs)
    idsw = sum(s["IDSW"] for s in seqs)
    motp_sum = sum(s["MOTP_sum"] for s in seqs)
    out["MOTA"] = 1 - (c_fn + c_fp + idsw) / max(1, c_tp + c_fn)
    out["MOTP"] = motp_sum / max(1, c_tp)
    out["IDSW"] = idsw
    out["CLR_TP"], out["CLR_FN"], out["CLR_FP"] = c_tp, c_fn, c_fp

    # Identity: summed counters -> IDF1
    idtp = sum(s["IDTP"] for s in seqs)
    idfn = sum(s["IDFN"] for s in seqs)
    idfp = sum(s["IDFP"] for s in seqs)
    out["IDF1"] = idtp / max(1e-9, idtp + 0.5 * idfn + 0.5 * idfp)
    out["IDTP"], out["IDFN"], out["IDFP"] = idtp, idfn, idfp

    # OSPA2 family: sequence average (ospa2.py _combine_average)
    for k in ("OSPA", "OSPA_CARD", "OSPA_LOC", "OSPA_INVI", "OSPA_OCCL",
              "OSPA_VIS"):
        vals = [s[k] for s in seqs if k in s]
        if vals:
            out[k] = float(np.mean(vals))
    return out
