"""A minimal hyperparameter search with optuna's surface (counterpart of
vatl4pose_tpu/al/optuna_lite.py; scripts/Run_active_learning.py:175-209).

The reference's `optimize_alc` runs an optuna study over VAL.UNC_LAMBDA that
maximises the mean ALC.  optuna is not a dependency, so this module holds
the part of its surface the CLI uses: `create_study`, `Study.optimize`,
`trial.suggest_float`, `best_value`/`best_params`, a Grid sampler and a TPE
sampler (Bergstra et al., NeurIPS 2011: the observed trials split into best
and rest at a gamma-quantile, Parzen windows l(x) and g(x), the candidate
with the largest l/g proposed).  numpy only; the two plots are drawn by
utils/figure.py.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np

__all__ = ["GridSampler", "TPESampler", "create_study"]


class Trial:
    def __init__(self, study, number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, float] = {}

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        v = self.study.sampler.sample(self.study, name, low, high, log)
        self.params[name] = float(v)
        return float(v)


class GridSampler:
    """Exhaustive cycle over a fixed per-parameter grid
    (optuna.samplers.GridSampler semantics for the 1-D case the reference
    uses — repeats the grid when n_trials exceeds its size)."""

    def __init__(self, search_space: Dict[str, List[float]]):
        self.search_space = {k: list(v) for k, v in search_space.items()}
        self._idx: Dict[str, int] = {}

    def sample(self, study, name, low, high, log):
        grid = self.search_space[name]
        i = self._idx.get(name, 0)
        self._idx[name] = i + 1
        return grid[i % len(grid)]


class TPESampler:
    """Tree-structured Parzen Estimator over float parameters."""

    def __init__(self, n_startup_trials: int = 10, n_candidates: int = 24,
                 gamma: float = 0.25, seed: Optional[int] = None):
        self.n_startup = n_startup_trials
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.rng = np.random.default_rng(seed)

    def sample(self, study, name, low, high, log):
        lo, hi = (math.log(low), math.log(high)) if log else (low, high)

        def to_space(x):
            return math.exp(x) if log else x

        hist = [(t.params[name], v) for t, v in study.records
                if name in t.params]
        if len(hist) < self.n_startup:
            return to_space(self.rng.uniform(lo, hi))

        xs = np.array([math.log(p) if log else p for p, _ in hist])
        vals = np.array([v for _, v in hist])
        order = np.argsort(-vals if study.direction == "maximize" else vals)
        n_best = max(1, int(np.ceil(self.gamma * len(hist))))
        best = xs[order[:n_best]]
        rest = xs[order[n_best:]]
        if len(rest) == 0:
            rest = xs

        def parzen(obs):
            obs = np.sort(obs)
            # bandwidths: neighbor spacing, floored to a fraction of range
            if len(obs) > 1:
                gaps = np.diff(obs)
                bw = np.maximum(np.concatenate([[gaps[0]], gaps]),
                                (hi - lo) / 100.0)
                bw = np.maximum.reduce([
                    bw, np.concatenate([gaps, [gaps[-1]]])])
            else:
                bw = np.array([(hi - lo) / 4.0])
            return obs, bw

        b_obs, b_bw = parzen(best)
        r_obs, r_bw = parzen(rest)

        def log_pdf(x, obs, bw):
            z = (x[:, None] - obs[None, :]) / bw[None, :]
            comp = -0.5 * z ** 2 - np.log(bw[None, :] * np.sqrt(2 * np.pi))
            m = comp.max(axis=1, keepdims=True)
            return (m[:, 0] + np.log(np.exp(comp - m).mean(axis=1)))

        # candidates drawn from l(x): pick a best-observation, jitter by bw
        ks = self.rng.integers(0, len(b_obs), self.n_candidates)
        cand = b_obs[ks] + self.rng.standard_normal(self.n_candidates) \
            * b_bw[ks]
        cand = np.clip(cand, lo, hi)
        score = log_pdf(cand, b_obs, b_bw) - log_pdf(cand, r_obs, r_bw)
        return to_space(float(cand[int(np.argmax(score))]))


class Study:
    def __init__(self, direction: str, sampler):
        assert direction in ("maximize", "minimize")
        self.direction = direction
        self.sampler = sampler
        self.records: List = []        # (trial, value)

    def optimize(self, objective: Callable, n_trials: int):
        for i in range(n_trials):
            t = Trial(self, i)
            value = float(objective(t))
            self.records.append((t, value))

    @property
    def best_trial(self):
        key = (max if self.direction == "maximize" else min)
        return key(self.records, key=lambda r: r[1])

    @property
    def best_value(self) -> float:
        return self.best_trial[1]

    @property
    def best_params(self) -> Dict[str, float]:
        return dict(self.best_trial[0].params)

    def history(self):
        return [(t.number, dict(t.params), v) for t, v in self.records]

    def plot_history(self, path: str):
        """Optimization-history figure (optuna.visualization equivalent)."""
        from ..utils import figure as plt
        vals = [v for _, v in self.records]
        best = np.maximum.accumulate(vals) if self.direction == "maximize" \
            else np.minimum.accumulate(vals)
        fig, ax = plt.subplots()
        ax.plot(vals, "o", label="trial value", alpha=0.6)
        ax.plot(best, "-", label="best so far")
        ax.set_xlabel("Trial")
        ax.set_ylabel("Objective")
        ax.grid()
        ax.legend()
        fig.savefig(path, dpi=140)
        plt.close(fig)
        return path

    def plot_slice(self, path: str):
        """Per-parameter slice figure (optuna.visualization.plot_slice
        equivalent, Run_active_learning.py:208-209): objective value vs
        each suggested parameter, trial number as the colour scale."""
        from ..utils import figure as plt
        names = sorted({n for t, _ in self.records for n in t.params})
        if not names:                      # no suggest_* calls (fixed study)
            names = [None]
        fig, axes = plt.subplots(1, len(names),
                                 figsize=(5 * len(names), 4), squeeze=False)
        for ax, name in zip(axes[0], names):
            if name is None:
                ax.plot([v for _, v in self.records], "o")
                ax.set_xlabel("Trial")
            else:
                pts = [(t.params[name], v, t.number)
                       for t, v in self.records if name in t.params]
                xs, vs, ns = zip(*pts)
                sc = ax.scatter(xs, vs, c=ns, cmap="viridis", alpha=0.8)
                fig.colorbar(sc, ax=ax, label="Trial")
                ax.set_xlabel(name)
                if min(xs) > 0 and max(xs) / max(min(xs), 1e-12) > 100:
                    ax.set_xscale("log")
            ax.set_ylabel("Objective")
            ax.grid()
        fig.tight_layout()
        fig.savefig(path, dpi=140)
        plt.close(fig)
        return path


def create_study(direction: str = "maximize", sampler=None) -> Study:
    return Study(direction, sampler or TPESampler())
