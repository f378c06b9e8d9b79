"""AL run metrics: ALC and the correlations between a criterion and OKS
(the port's own copy of vatl4pose_tpu/al/al_metric.py).

compute_alc is active_learning/al_metric.py's sklearn `metrics.auc` on
0.01x scaled axes, written here as the same trapezoid rule in numpy so
that the port needs no sklearn.  The learning-curve plots wait for the
analysis CLIs (ROADMAP A13).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["auc", "compute_alc", "compute_spearmanr", "compute_corr"]


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
