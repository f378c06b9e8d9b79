"""Retrain traffic: back-to-back calls of the port's Retrainer over one
fixed labeled set, as each AL round retrains the estimator on every
labeled sample (`Retrainer.retrain`, AdamW, f32).  A unit of work is one
call of `epochs_per_call` epochs; each call draws its own augmentation on
the host, as a round does.  Only real rows are counted, never the rows
that cycle-pad an epoch's last batch.

Set-up makes the window's first call itself (every step of its epochs,
the cycle-padded batches and the second epoch's decayed learning rate
among them) and keeps what its steps produced (each step's loss, the
first gradient as the optimizer's state holds it, each leaf's change over
the call); the reference follows those steps from the same weights, rows
and seed once the window has closed.  The window then trains on from
that state.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark import port
from benchmark.reference import judge, training
from benchmark.weights import estimator_weights


def _rows(traffic, n, seed):
    """The labeled set (a seeded choice of `labeled` rows, in a seeded
    order) and the Retrainer's seed."""
    rng = np.random.default_rng((int(seed) * 7 + 11) % 2 ** 63)
    labeled = rng.permutation(n)[:traffic["labeled"]]
    return labeled, int(rng.integers(2 ** 31))


def _epoch_steps(cfg, traffic):
    """The steps of one epoch: whole batches, the last cycle-padded."""
    return -(-traffic["labeled"] // cfg["RETRAIN"]["BATCH_SIZE"])


class Cell:
    def __init__(self, cfg, traffic, video, seed, device, precision):
        self.cfg, self.traffic, self.video = cfg, traffic, video
        self.seed, self.device = seed, device
        self.labeled, self.rt_seed = _rows(traffic, len(video.frame_idx),
                                           seed)
        self.model, _ = port.build_models(cfg, seed, device, with_ae=False)
        self.w0 = {k: v.detach().clone()
                   for k, v in self.model.state_dict().items()}
        self.retrainer = port.retrainer(cfg, self.model, self.rt_seed,
                                        video.joint_pairs, device,
                                        bf16=precision == "bf16")
        self.img_wh = (video.width, video.height)
        self.epochs = traffic["epochs_per_call"]

    def warm(self):
        """The window's first call, recorded; it also meets every shape
        the window uses (a batch is always BATCH_SIZE rows)."""
        self.readings = self._checked_call()

    def _checked_call(self):
        tr, model = self.retrainer, self.model
        names = {id(p): n for n, p in model.named_parameters()}
        rec = {"loss": [], "grad": {}, "change": {}}
        train_step = tr.train_step

        def recorded(*a, **kw):
            out = train_step(*a, **kw)
            rec["loss"].append(float(out[0]))
            if len(rec["loss"]) == 1:
                for g in tr.optimizer.param_groups:
                    for p in g["params"]:
                        m = tr.optimizer.state.get(p, {}).get("exp_avg")
                        rec["grad"][names[id(p)]] = 0.0 if m is None else \
                            float(m.norm()) / (1 - g["betas"][0])
            return out

        tr.train_step = recorded
        try:
            self.unit()
        finally:
            del tr.train_step
        rec["change"] = {n: float((p.detach() - self.w0[n]).norm())
                         for n, p in model.named_parameters()}
        del self.w0
        return rec

    def unit(self):
        """One retraining call; returns the real rows trained."""
        self.retrainer.retrain(self.video, self.video.frames, self.labeled,
                               self.epochs, self.img_wh)
        return len(self.labeled) * self.epochs

    def release(self):
        del self.retrainer, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, log):
        refr = _follow(self.cfg, self.traffic, self.video, self.seed,
                       self.device)
        log(f"loss_err_by_step {judge.loss_errors(self.readings, refr)}")
        return judge.judge_training(self.readings, refr,
                                    _epoch_steps(self.cfg, self.traffic))


def _follow(cfg, traffic, video, seed, device, tf32=False):
    labeled, rt_seed = _rows(traffic, len(video.frame_idx), seed)
    return training.follow_steps(
        cfg, estimator_weights(cfg, seed, device), video, labeled, rt_seed,
        _epoch_steps(cfg, traffic) * traffic["epochs_per_call"], device,
        tf32=tf32)


def control(cfg, traffic, video, seed, device):
    """The control's readings: the reference's steps in emulated TF32 in
    the program's place (and, for a look, each step's loss error)."""
    got = _follow(cfg, traffic, video, seed, device, tf32=True)
    want = _follow(cfg, traffic, video, seed, device)
    return {**judge.judge_training(got, want, _epoch_steps(cfg, traffic)),
            "loss_err_by_step": judge.loss_errors(got, want)}
