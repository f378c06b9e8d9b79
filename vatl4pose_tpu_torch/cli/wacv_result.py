"""Paper-figure generation (counterpart of vatl4pose_tpu/cli/
wacv_result.py; parity: scripts/wacv_result.py; host-only, no device).

    python -m vatl4pose_tpu_torch.cli.wacv_result --exp_root exp

The figures are drawn by utils/figure.py (no matplotlib); `latex_table`
needs nothing beyond the summary.

Builds the WACV-style comparison artifacts from accumulated runs: mean
learning curves per strategy (vs the AP_HR anchor), an ALC bar chart, and a
LaTeX-ready strategy table.
"""

from __future__ import annotations

import argparse
import os

from .detailed_result import (collect, plot_spearman, plot_strategy_curves,
                              plot_uncertainty_vs_ap)
from .summarize_result import summarize

__all__ = ["alc_bar_chart", "latex_table", "main"]


def alc_bar_chart(table: dict, out_dir: str):
    from ..utils import figure as plt
    names = list(table)
    vals = [table[k]["mean_ALC"] for k in names]
    errs = [table[k]["std_ALC"] for k in names]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(range(len(names)), vals, yerr=errs, capsize=3)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=30, ha="right", fontsize=7)
    ax.set_ylabel("ALC")
    fig.tight_layout()
    path = os.path.join(out_dir, "alc_bar.png")
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


def latex_table(table: dict) -> str:
    lines = [r"\begin{tabular}{lccc}", r"\toprule",
             r"Strategy & videos & ALC $\uparrow$ & final AP \\",
             r"\midrule"]
    for k, v in sorted(table.items(), key=lambda x: -x[1]["mean_ALC"]):
        name = k.replace("_", r"\_")
        lines.append(f"{name} & {v['videos']} & "
                     f"{v['mean_ALC']:.4f} $\\pm$ {v['std_ALC']:.4f} & "
                     f"{v['mean_final']:.2f} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp_root", required=True)
    p.add_argument("--out_dir", default=None)
    a = p.parse_args(argv)
    out_dir = a.out_dir or os.path.join(a.exp_root, "figures")
    os.makedirs(out_dir, exist_ok=True)
    table = summarize(a.exp_root)
    result_dict, _ = collect(a.exp_root)
    # the reference's wacv_result.py is near-identical to
    # detailed_result.py (same artifact set, paper strategy grouping) —
    # reuse its plotting layer, then add the ALC bar + LaTeX table
    for metric in ("AP", "AP .5", "AP .75"):
        plot_strategy_curves(result_dict, out_dir, metric, ann=True)
    plot_uncertainty_vs_ap(result_dict, out_dir)
    plot_spearman(result_dict, out_dir)
    alc_bar_chart(table, out_dir)
    tex = latex_table(table)
    with open(os.path.join(out_dir, "strategy_table.tex"), "w") as f:
        f.write(tex)
    print(tex)


if __name__ == "__main__":
    main()
