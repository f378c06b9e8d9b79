"""AL run metrics: ALC, the correlations between a criterion and OKS, and
the learning-curve figure (the port's own copy of
vatl4pose_tpu/al/al_metric.py).

compute_alc is active_learning/al_metric.py's sklearn `metrics.auc` on
0.01x scaled axes, written here as the same trapezoid rule in numpy so
that the port needs no sklearn.  plot_learning_curves draws through
utils/figure.py (no matplotlib).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

__all__ = ["auc", "compute_alc", "compute_spearmanr", "compute_corr",
           "plot_learning_curves"]


def auc(x, y) -> float:
    """Trapezoid area under y(x) for monotonic x: sklearn.metrics.auc's
    rule, including its sign for decreasing x."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if x.shape[0] < 2:
        raise ValueError("at least 2 points are needed to compute an area")
    dx = np.diff(x)
    direction = 1
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
        direction = -1
    return float(direction * np.add.reduce(dx * (y[1:] + y[:-1]) / 2.0))


def compute_alc(percentages: Sequence[float],
                performances: Sequence[float]) -> float:
    return auc(0.01 * np.asarray(percentages),
               0.01 * np.asarray(performances))


def _paired(unc_dict: Dict, oks_dict: Dict):
    unc = np.array([unc_dict[k] for k in unc_dict])
    oks = np.array([oks_dict[k] for k in unc_dict])
    return unc, oks


def compute_spearmanr(unc_dict: Dict, oks_dict: Dict) -> float:
    from scipy.stats import spearmanr
    unc, oks = _paired(unc_dict, oks_dict)
    corr, _ = spearmanr(unc, oks)
    return float(corr)


def compute_corr(unc_dict: Dict, oks_dict: Dict) -> float:
    unc, oks = _paired(unc_dict, oks_dict)
    return float(np.corrcoef(unc, oks)[0, 1])


def plot_learning_curves(savedir: str, video_id: str, strategy: str,
                         percentages, performances, ann: bool = False) -> str:
    from ..utils import figure as plt
    fig, ax = plt.subplots()
    ax.set_xlabel("Label Percentage (%)")
    ax.set_ylabel("AP Performance (%)")
    ax.set_title(f"Active Learning Result on {video_id}")
    ax.grid()
    ax.set_xlim(0, 100)
    ax.set_ylim(0, 100)
    ax.plot(percentages, performances, label=strategy, color="blue")
    ax.legend(loc=0)
    fig.tight_layout()
    suffix = "_ann" if ann else ""
    path = os.path.join(savedir,
                        f"learning_curve_{strategy}_{video_id}{suffix}.png")
    fig.savefig(path)
    plt.close(fig)
    return path
