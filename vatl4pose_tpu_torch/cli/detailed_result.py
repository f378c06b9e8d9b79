"""Detailed per-video result analysis (counterpart of
vatl4pose_tpu/cli/detailed_result.py; parity: scripts/detailed_result.py;
host-only, no device).

    python -m vatl4pose_tpu_torch.cli.detailed_result --exp_root exp

The numeric artifacts (empty_dict.json, result_ann.json, sc_summary.json)
are written before the figures, which utils/figure.py draws (PNG and a
one-page raster PDF; no matplotlib).

Feature-complete against the reference's 392-line analyzer:
  - interpolates every learning curve to the 1001-point percentage grid
    (detailed_result.py:41 percent1000) for every requested metric, raw and
    annotation-substituted;
  - per-video and mean/std aggregation + ALC per metric (:131-140);
  - stopping-criteria behavior summary incl. the AP reached at the round
    nearest each SC firing point ("stopped_AP", :104-127);
  - normalized mean-uncertainty trajectories and the uncertainty-vs-AP
    figure (:226-247), per-strategy curve dumps and the combined
    comparison figure in png+pdf (:250-295), Spearman plot (:318-336);
  - empty-video accounting (empty_dict.json, :51-60, :146-151);
  - per-metric json artifacts (result_ann.json, :383-390).

Styling niceties of the paper figures (axis-break squiggle, Japanese font)
are intentionally not reproduced; every quantitative artifact is.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .summarize_result import AP_HR, find_results, load_result_json

__all__ = ["METRIC_KEYS", "DEFAULT_METRICS", "GRID", "QUERY_TICKS",
           "collect", "summarize_sc", "metric_json", "plot_strategy_curves",
           "plot_uncertainty_vs_ap", "plot_spearman", "main"]

METRIC_KEYS = ["AP", "AP .5", "AP .6", "AP .7", "AP .75", "AP .8",
               "AP .95", "AP (M)", "AP (L)", "AR"]
DEFAULT_METRICS = ["AP", "AP .5", "AP .6", "AP .75"]
GRID = np.linspace(0, 100, 1001)          # percent1000 (:41)
QUERY_TICKS = [0, 50, 100, 150, 200, 300, 400, 600, 800, 1000]  # (:20)


def _find_nearest(array, value):
    return int(np.abs(np.asarray(array) - value).argmin())


def collect(exp_root: str, metrics=None, video_ids=None, sc_thresh=None):
    """result_dict equivalent of load_result_json (detailed_result.py:27-152).

    Returns (result_dict, empty_dict): per strategy —
      {metric}/{metric}_ann: per-video 1001-pt curves,
      {metric}_ALC[_ann]: per-video ALC,
      {metric}_mean/_std[_ann], {metric}_ALC_mean[_ann],
      mean_uncertainty (normalized to round 0), spearmanr,
      actual_finish / finished_minerror / finished_oursc,
      stopped_AP_min / stopped_AP_oursc (when sc_thresh given).
    """
    from ..al.al_metric import compute_alc

    metrics = metrics or DEFAULT_METRICS
    result_dict = {}
    empty_dict = {}
    empty_union = []
    found = find_results(exp_root)
    for strategy, videos in found.items():
        d = {"Percentage": GRID.tolist(), "mean_uncertainty": {},
             "spearmanr": {}, "actual_finish": {}, "finished_minerror": {},
             "finished_oursc": {}, "stopped_AP_min": {},
             "stopped_AP_oursc": {}}
        for m in metrics:
            for suffix in ("", "_ann", "_ALC", "_ALC_ann"):
                d[m + suffix] = {}
        empties = []
        ids = video_ids if video_ids is not None else sorted(videos)
        for video in ids:
            if video not in videos:
                empties.append(video)
                if video not in empty_union:
                    empty_union.append(video)
                continue
            try:
                r = load_result_json(videos[video])
            except (OSError, json.JSONDecodeError):
                empties.append(video)
                continue
            pct = r["percentages"]
            for m in metrics:
                perf = np.array([p[m] for p in r["performances"]]) * 100
                perf_ann = np.array([p[m]
                                     for p in r["performances_ann"]]) * 100
                if -1 * 100 in perf or -100 in perf_ann:
                    continue
                d[m][video] = np.interp(GRID, pct, perf).tolist()
                d[m + "_ann"][video] = np.interp(GRID, pct,
                                                 perf_ann).tolist()
                d[m + "_ALC"][video] = compute_alc(pct, perf)
                d[m + "_ALC_ann"][video] = compute_alc(pct, perf_ann)
            unc = np.asarray(r["mean_uncertaity"], np.float64)
            if unc[0] == 0:
                unc = unc + 1       # (:215-218) keep the normalization finite
            d["mean_uncertainty"][video] = (unc / unc[0]).tolist()
            if r.get("spearmanr"):
                d["spearmanr"][video] = r["spearmanr"]
            d["actual_finish"][video] = r["actual_finish"]
            d["finished_minerror"][video] = r["finished_minerror"]
            d["finished_oursc"][video] = r["finished_oursc"]
            if sc_thresh is not None:
                i_min = _find_nearest(pct, r["finished_minerror"])
                i_ours = _find_nearest(pct, r["finished_oursc"])
                d["stopped_AP_min"][video] = \
                    r["performances_ann"][i_min][sc_thresh]
                d["stopped_AP_oursc"][video] = \
                    r["performances_ann"][i_ours][sc_thresh]
        # aggregates
        for m in metrics:
            for suffix in ("", "_ann"):
                curves = list(d[m + suffix].values())
                if curves:
                    d[m + "_mean" + suffix] = np.mean(curves, 0).tolist()
                    d[m + "_std" + suffix] = np.std(curves, 0).tolist()
                alcs = list(d[m + "_ALC" + suffix.replace("_ann", "")
                              + ("_ann" if suffix else "")].values())
                if alcs:
                    d[m + "_ALC_mean" + suffix] = float(np.mean(alcs))
        if d["mean_uncertainty"]:
            curves = [np.asarray(c) for c in d["mean_uncertainty"].values()]
            nmin = min(len(c) for c in curves)  # runs may differ in rounds
            d["mean_mean_uncertainty"] = np.mean(
                [c[:nmin] for c in curves], 0).tolist()
        result_dict[strategy] = d
        empty_dict[strategy] = empties
    empty_dict["union"] = empty_union
    return result_dict, empty_dict


def summarize_sc(result_dict):
    """SC behavior table (detailed_result.py:117-127)."""
    rows = {}
    for strategy, d in result_dict.items():
        row = {}
        for k in ("actual_finish", "finished_minerror", "finished_oursc",
                  "stopped_AP_min", "stopped_AP_oursc"):
            vals = list(d.get(k, {}).values())
            if vals:
                row[k] = float(np.mean(vals))
        rows[strategy] = row
    return rows


def plot_strategy_curves(result_dict, out_dir, metric, ann=True):
    """Per-strategy curve dumps + the combined comparison figure
    (summarize_result, detailed_result.py:155-295).  Saves png+pdf."""
    from ..utils import figure as plt

    prefix = "_ann" if ann else ""
    fig, ax = plt.subplots()
    ticks = np.array(QUERY_TICKS)
    for strategy, d in result_dict.items():
        key = metric + "_mean" + prefix
        if key not in d:
            continue
        y = np.asarray(d[key])[ticks]
        x = GRID[ticks]
        style = "-" if ("THC" in strategy or "WPU" in strategy) else "--"
        ax.plot(x, y, style, marker="o", markersize=4, label=strategy)
        sdir = os.path.join(out_dir, strategy)
        os.makedirs(sdir, exist_ok=True)
        f2, a2 = plt.subplots()
        a2.plot(x, y, marker="o")
        a2.set_xlabel("Labeled Samples (%)")
        a2.set_ylabel(f"{metric} (%)")
        a2.grid()
        f2.savefig(os.path.join(sdir, f"{strategy}_{metric}{prefix}.png"))
        plt.close(f2)
    ax.axhline(AP_HR * 100, ls=":", c="gray", label="AP_HR")
    ax.set_xlabel("Labeled Percentage (%)")
    ax.set_ylabel(f"{metric} (%)")
    ax.grid()
    ax.legend(fontsize=7)
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, f"{metric}{prefix}")
    fig.savefig(base + ".png", dpi=140)
    fig.savefig(base + ".pdf")
    plt.close(fig)
    return base + ".png"


def plot_uncertainty_vs_ap(result_dict, out_dir, metric="AP .6", ann=True):
    """Average-uncertainty vs AP trajectory figure (:226-247, :296-316)."""
    from ..utils import figure as plt

    prefix = "_ann" if ann else ""
    fig, ax = plt.subplots()
    for strategy, d in result_dict.items():
        if "mean_mean_uncertainty" not in d or metric + "_mean" + prefix \
                not in d:
            continue
        unc = np.asarray(d["mean_mean_uncertainty"]) * 100
        x = np.asarray(d[metric + "_mean" + prefix])[
            QUERY_TICKS][: len(unc)]
        if np.all(unc == 100):
            continue
        ax.plot(x[: len(unc)], unc[: len(x)], marker="o", markersize=4,
                label=strategy)
    ax.set_xlabel(f"{metric} (%)")
    ax.set_ylabel("Average Uncertainty (%)")
    ax.grid()
    ax.legend(fontsize=7)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "uncertainty.png")
    fig.savefig(path, dpi=140)
    fig.savefig(os.path.join(out_dir, "uncertainty.pdf"))
    plt.close(fig)
    return path


def plot_spearman(result_dict, out_dir):
    """Mean Spearman trajectory per strategy (:318-336)."""
    from ..utils import figure as plt

    fig, ax = plt.subplots()
    plotted = False
    for strategy, d in result_dict.items():
        curves = [np.asarray(c, np.float64)
                  for c in d.get("spearmanr", {}).values() if len(c)]
        if not curves:
            continue
        n = min(len(c) for c in curves)
        mean = np.mean([c[:n] for c in curves], axis=0)
        ax.plot(np.arange(n), mean, marker="o", label=strategy)
        plotted = True
    if not plotted:
        plt.close(fig)
        return None
    ax.set_xlabel("Round")
    ax.set_ylabel("Spearmanr")
    ax.grid()
    ax.legend(fontsize=7)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "spearmanr.png")
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def metric_json(result_dict, metric, ann=True):
    """Per-metric summary entries (detailed_result.py:300-316)."""
    prefix = "_ann" if ann else ""
    out = {}
    for strategy, d in result_dict.items():
        key = metric + "_mean" + prefix
        if key not in d:
            continue
        out[strategy] = {
            "mean_Percentage": QUERY_TICKS,
            metric + prefix: np.asarray(d[key])[QUERY_TICKS].tolist(),
            metric + "_ALC": d.get(metric + "_ALC_mean" + prefix),
            "mean_mean_uncertainty": d.get("mean_mean_uncertainty"),
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp_root", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--metrics", nargs="*", default=DEFAULT_METRICS)
    p.add_argument("--video_list", default=None,
                   help="restrict/account against this id list "
                        "(empty-video report)")
    p.add_argument("--sc_thresh", default=None,
                   help="metric key for stopped-AP SC evaluation "
                        "(e.g. 'AP .75')")
    p.add_argument("--raw", action="store_true",
                   help="also emit the RAW (non-annotated) summary")
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(args.exp_root, "analysis")
    video_ids = None
    if args.video_list:
        with open(args.video_list) as f:
            video_ids = f.read().splitlines()
    result_dict, empty_dict = collect(args.exp_root, args.metrics,
                                      video_ids, args.sc_thresh)
    os.makedirs(out_dir, exist_ok=True)
    # the numeric artifacts first
    with open(os.path.join(out_dir, "empty_dict.json"), "w") as f:
        json.dump(empty_dict, f, indent=4)
    result_ann_dict = {m: metric_json(result_dict, m, ann=True)
                       for m in args.metrics}
    with open(os.path.join(out_dir, "result_ann.json"), "w") as f:
        json.dump(result_ann_dict, f, indent=4)
    sc = summarize_sc(result_dict)
    with open(os.path.join(out_dir, "sc_summary.json"), "w") as f:
        json.dump(sc, f, indent=4)
    for strategy, row in sc.items():
        print(strategy, row)
    print(f"empty ids (union): {len(empty_dict['union'])}")
    variants = [("ANN", True)] + ([("RAW", False)] if args.raw else [])
    for sub, ann in variants:
        sdir = os.path.join(out_dir, sub)
        for m in args.metrics:
            plot_strategy_curves(result_dict, sdir, m, ann=ann)
        plot_uncertainty_vs_ap(result_dict, sdir, ann=ann)
    plot_spearman(result_dict, out_dir)
    return result_dict


if __name__ == "__main__":
    main()
