"""Offline pose-tracking evaluation CLI (counterpart of
vatl4pose_tpu/cli/pose_track_eval.py; host-only, no device).

    python -m vatl4pose_tpu_torch.cli.pose_track_eval --gt gt.json \
        --pred pred.json [--out metrics.json]

Parity: JRDB_toolkit/posetrack/eval_pose.py — the PoseEvaluator framework
run over one or many sequences: HOTA / CLEAR / Identity / OSPA2 (incl.
occlusion levels) per sequence, then the toolkit's combine_sequences
aggregation (the JAX package's metrics are cross-checked against the vendored
toolkit's classes in tests/test_tracking_toolkit.py, and the port's
against the JAX package's in tests/test_torch_tracking.py).

Single-sequence mode: --gt gt.json --pred pred.json.
Dataset mode: --gt gt_dir/ --pred pred_dir/ — sequences matched by file
name (the toolkit's tracker-folder layout), per-sequence table + COMBINED
row, optional --out json with everything.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["SUMMARY_KEYS", "main"]

SUMMARY_KEYS = ["HOTA", "DetA", "AssA", "MOTA", "MOTP", "IDSW", "IDF1",
                "OSPA", "OSPA_CARD", "OSPA_LOC", "OSPA_INVI", "OSPA_OCCL",
                "OSPA_VIS"]


def _pairs(gt, pred):
    if os.path.isdir(gt):
        gts = sorted(glob.glob(os.path.join(gt, "*.json")))
        out = []
        for g in gts:
            name = os.path.basename(g)
            p = os.path.join(pred, name)
            if not os.path.exists(p):
                print(f"[warn] no predictions for sequence {name} — "
                      "skipped")
                continue
            out.append((os.path.splitext(name)[0], g, p))
        if not out:
            raise FileNotFoundError(f"no matched sequences under {gt}")
        return out
    return [(os.path.splitext(os.path.basename(gt))[0], gt, pred)]


def _fmt_row(name, res):
    cells = [f"{name:24s}"]
    for k in SUMMARY_KEYS:
        v = res.get(k)
        cells.append("      -" if v is None else
                     (f"{v:7d}" if isinstance(v, (int,)) and k == "IDSW"
                      else f"{v:7.4f}"))
    return " ".join(cells)


def main(argv=None):
    from ..eval.tracking import combine_sequences, evaluate_tracking
    p = argparse.ArgumentParser()
    p.add_argument("--gt", required=True,
                   help="COCO-video GT json, or a directory of per-sequence "
                        "GT jsons")
    p.add_argument("--pred", required=True,
                   help="predictions json (list or COCO dict w/ track_id), "
                        "or a directory matched to --gt by file name")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    per_seq = {}
    for name, g, pr in _pairs(a.gt, a.pred):
        per_seq[name] = evaluate_tracking(g, pr)

    header = f"{'sequence':24s} " + " ".join(f"{k:>7s}"
                                             for k in SUMMARY_KEYS)
    print(header)
    for name, res in per_seq.items():
        print(_fmt_row(name, res))
    combined = combine_sequences(per_seq) if len(per_seq) > 1 \
        else next(iter(per_seq.values()))
    if len(per_seq) > 1:
        print(_fmt_row("COMBINED", combined))

    if a.out:
        def clean(d):
            return {k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in d.items()}
        payload = {"sequences": {k: clean(v) for k, v in per_seq.items()},
                   "combined": clean(combined)}
        with open(a.out, "w") as f:
            json.dump(payload, f, indent=2)
    return per_seq, combined


if __name__ == "__main__":
    main()
