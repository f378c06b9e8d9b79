"""Faults planted underneath the timed path, for the check that the
comparison catches them (benchmark/tests and benchmark/calibrate.py).
Each takes a driver's cell after it is built and before it warms up."""

from __future__ import annotations

import torch


def answer_altered(cell):
    """Scoring: one sample's answers altered where stage 2 produces them
    (its THC doubled, its first joint moved 10 pixels)."""
    engine = cell.engine
    score_video = engine._score_video

    def altered(*a, **kw):
        out = score_video(*a, **kw)
        out["unc"] = out["unc"].clone()
        out["unc"][0] *= 2
        for key in ("coords", "kpts"):
            out[key] = out[key].clone()
        out["coords"][0, 0] += 10.0
        out["kpts"][0, :2] += 10.0
        return out

    engine._score_video = altered


def half_batch(cell):
    """Retraining: each step trains on the first half of its batch, the
    loss the mean over that half."""
    tr = cell.retrainer
    fit = tr._fit

    def half(crops, joints, vis, valid, sharded_step=None):
        n = crops.shape[0] // 2
        return fit(crops[:n], joints[:n], vis[:n], valid[:n], sharded_step)

    tr._fit = half


def all_valid(cell):
    """Retraining: the rows that cycle-pad an epoch's last batch count in
    the loss as real rows."""
    tr = cell.retrainer
    fit = tr._fit

    def every(crops, joints, vis, valid, sharded_step=None):
        return fit(crops, joints, vis, torch.ones_like(valid), sharded_step)

    tr._fit = every


def state_unchanged(cell):
    """Retraining: every optimizer step returns the state unchanged."""
    cell.retrainer.optimizer.step = lambda *a, **kw: None


FAULTS = {"score": (answer_altered,),
          "retrain": (half_batch, all_valid, state_unchanged)}

__all__ = ["FAULTS", "all_valid", "answer_altered", "half_batch",
           "state_unchanged"]
