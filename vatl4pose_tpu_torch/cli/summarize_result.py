"""Result summarization across videos and strategies (counterpart of
vatl4pose_tpu/cli/summarize_result.py; host-only, no device).

    python -m vatl4pose_tpu_torch.cli.summarize_result --exp_root exp

ALC is the port's numpy trapezoid (al/al_metric.compute_alc), so no
sklearn is needed.

Parity: scripts/summarize_result.py (ALC tables over per-video result.json
files) and the curve-interpolation core of scripts/detailed_result.py
(per-strategy learning curves resampled to a common percentage grid).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict

import numpy as np

__all__ = ["AP_HR", "load_result_json", "find_results", "interp_curve",
           "ap_series", "summarize", "sc_summary", "main"]

AP_HR = 0.62  # pre-trained HRNet AP anchor (detailed_result.py:18)


def load_result_json(path: str):
    with open(path) as f:
        return json.load(f)


def find_results(exp_root: str):
    """<exp_root>/AL_<memo>/<model>/<strategy>/<video>/<timestamp>/result.json"""
    out = defaultdict(dict)
    for p in sorted(glob.glob(os.path.join(
            exp_root, "*", "*", "*", "*", "*", "result.json"))):
        parts = p.split(os.sep)
        strategy, video = parts[-4], parts[-3]
        out[strategy][video] = p  # latest timestamp wins (sorted)
    return out


def interp_curve(percentages, values, grid=None):
    """Resample a learning curve onto a dense percentage grid
    (detailed_result.py interpolates to 1000 points)."""
    grid = np.linspace(0, 100, 1000) if grid is None else grid
    return grid, np.interp(grid, percentages, values)


def ap_series(result, key="AP", ann=True):
    perfs = result["performances_ann" if ann else "performances"]
    return [p[key] * 100 for p in perfs]


def summarize(exp_root: str, metric_key: str = "AP", ann: bool = True):
    from ..al.al_metric import compute_alc
    table = {}
    for strategy, videos in find_results(exp_root).items():
        alcs, finals = [], []
        for video, path in videos.items():
            r = load_result_json(path)
            perf = ap_series(r, metric_key, ann)
            alcs.append(compute_alc(r["percentages"], perf))
            finals.append(perf[-1])
        table[strategy] = {
            "videos": len(videos),
            "mean_ALC": float(np.mean(alcs)),
            "std_ALC": float(np.std(alcs)),
            "mean_final": float(np.mean(finals)),
        }
    return table


def sc_summary(exp_root: str):
    """Stopping-criteria behavior table (detailed_result.py SC summaries)."""
    rows = {}
    for strategy, videos in find_results(exp_root).items():
        af, me, osc = [], [], []
        for _, path in videos.items():
            r = load_result_json(path)
            af.append(r["actual_finish"])
            me.append(r["finished_minerror"])
            osc.append(r["finished_oursc"])
        rows[strategy] = {"actual_finish": float(np.mean(af)),
                          "minerror_sc": float(np.mean(me)),
                          "our_sc": float(np.mean(osc))}
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp_root", required=True)
    p.add_argument("--metric", default="AP")
    p.add_argument("--raw", action="store_true",
                   help="use raw performance instead of annotated")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    table = summarize(args.exp_root, args.metric, ann=not args.raw)
    sc = sc_summary(args.exp_root)
    print(f"{'strategy':42s} {'videos':>6s} {'ALC':>8s} {'±':>7s} "
          f"{'final':>7s}")
    for k, v in sorted(table.items(), key=lambda x: -x[1]["mean_ALC"]):
        print(f"{k:42s} {v['videos']:6d} {v['mean_ALC']:8.4f} "
              f"{v['std_ALC']:7.4f} {v['mean_final']:7.2f}")
    out = {"alc": table, "stopping": sc}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
