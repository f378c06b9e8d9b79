"""The numbers that decide `correct`: each compares what the timed path
produced with the plain reference, and each is held to a limit of its own
(benchmark/limits/<workload>.json).  Every number is a worst case over the
answers it covers, scaled to the reference's own magnitude.

Scoring (every answer of every pass in the window):
  emb_err     max |emb - emb_ref| / max |emb_ref|: crop and backbone;
  score_err   max |maxval - maxval_ref| / max |hm_ref|: the head and the
              maximum of the decode;
  decode_gap  the widest gap by which the reference's own heatmap
              disagrees with the decoded keypoint: the program's image
              coordinates are mapped back through the reference's crop
              box; where they land on another cell than the reference's
              argmax, the gap is the reference's maximum less its value
              there; where they land on the same cell with another
              sub-pixel shift, the neighbour difference that decided the
              shift; over max |hm_ref|.  A decode near a tie moves on
              rounding alone, so this is the widest of such gaps;
  thc_err     max |THC - THC_ref| / max |THC_ref|;
  stage2_err  the larger of max |OKS - OKS_ref| and max |WPU - WPU_ref| /
              max |WPU_ref|, the reference's OKS and WPU taken of the
              program's own keypoints, so that a moved decode (judged by
              decode_gap) does not count twice.

Retraining (every step of the window's first call, which set-up makes:
its epochs, their cycle-padded last batches, the decayed learning rate
of the second; the reference follows them from the same weights, rows
and seed):
  loss_err    the first step's |loss - loss_ref| / |loss_ref|;
  loss_err_pad  the same at the first epoch's last step, whose batch is
              cycle-padded: the replicas count in the loss only if the
              mask is lost.  The losses drift apart step by step in f32
              alone (AdamW's first update is the sign of every gradient
              element, and elements whose gradient is at round-off take
              either sign), and a mean over the few real rows of a padded
              batch reads that drift larger; every step's error is logged,
              and the steps after are held by change_gap;
  grad_gap    the worst leaf's | |g| - |g_ref| | / max(|g_ref|, median
              leaf |g_ref|), g the first step's gradient as the optimizer
              holds it;
  change_gap  the same of each leaf's parameter change over the call.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move under AdamW by round-off alone and are left out of both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import scoring as ref

__all__ = ["judge_scoring", "judge_training", "leaf_gaps", "loss_errors"]


def _rel(a, b, scale):
    return float((a - b).abs().max() / scale) if a.numel() else 0.0


def decode_gap(coords, hms, crop_boxes, maxv, cells, shift, diff):
    """The widest decode gap of program coordinates (N, K, 2) against the
    reference's heatmaps and decode (see the module's docstring)."""
    N, K, H, W = hms.shape
    b = crop_boxes[:, None, :]
    s = (b[..., 2] - b[..., 0]) / W
    ox = b[..., 0] + (b[..., 2] - b[..., 0]) * 0.5 - s * W * 0.5
    oy = b[..., 1] + (b[..., 3] - b[..., 1]) * 0.5 - s * H * 0.5
    hx, hy = (coords[..., 0] - ox) / s, (coords[..., 1] - oy) / s
    if not (torch.isfinite(hx).all() and torch.isfinite(hy).all()):
        return math.inf
    cx, cy = torch.round(hx).long(), torch.round(hy).long()
    inside = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    flat = hms.reshape(N, K, -1)
    val = torch.gather(flat, -1, (cy.clamp(0, H - 1) * W
                                  + cx.clamp(0, W - 1))[..., None])[..., 0]
    lo = flat.amin(-1)
    same = (cx == cells[..., 0]) & (cy == cells[..., 1])
    cell_gap = torch.where(maxv > 0, maxv - val, maxv.abs())
    cell_gap = torch.where(inside, cell_gap, maxv - lo)
    sub = torch.stack([hx - cx, hy - cy], -1)
    wrong_shift = (sub - shift).abs() > 0.05
    shift_gap = (diff.abs() * wrong_shift).amax(-1)
    gap = torch.where(same, shift_gap, cell_gap)
    return float(gap.max() / hms.abs().max())


@torch.no_grad()
def judge_scoring(passes, r, ae):
    """`passes`: the program's outputs (dicts of numpy arrays) of every
    pass judged; `r`: the reference's pass (hms, emb, coords, maxv, cells,
    shift, diff, crop_boxes, gt, box_ann, thc); `ae`: the reference
    autoencoder.  Returns {name: worst reading over the passes}."""
    dev = r["hms"].device
    hm_scale = r["hms"].abs().max()
    out = {"emb_err": 0.0, "score_err": 0.0, "decode_gap": 0.0,
           "thc_err": 0.0, "stage2_err": 0.0}
    for p in passes:
        t = {k: torch.as_tensor(p[k], device=dev)
             for k in ("embeddings", "scores", "coords", "unc", "kpts",
                       "oks", "unc2")}
        kp = t["kpts"].float()
        wpu_ref = ref.wpu(ae, r["crop_boxes"], kp)
        oks_ref = ref.oks(kp, r["gt"], r["box_ann"])
        got = {
            "emb_err": _rel(t["embeddings"], r["emb"], r["emb"].abs().max()),
            "score_err": _rel(t["scores"], r["maxv"], hm_scale),
            "decode_gap": decode_gap(t["coords"], r["hms"], r["crop_boxes"],
                                     r["maxv"], r["cells"], r["shift"],
                                     r["diff"]),
            "thc_err": _rel(t["unc"], r["thc"], r["thc"].abs().max()),
            "stage2_err": max(float((t["oks"] - oks_ref).abs().max()),
                              _rel(t["unc2"], wpu_ref,
                                   wpu_ref.abs().max())),
        }
        for k, v in got.items():
            out[k] = max(out[k], v) if not math.isnan(v) else math.inf
    return out


def leaf_gaps(got, want, keep):
    """Worst | |a| - |b| | / max(|b|, median |b|) over the leaves named in
    `keep`; `got`, `want`: {leaf: norm}."""
    med = float(np.median([want[k] for k in keep]))
    worst = 0.0
    for k in keep:
        g = got.get(k, 0.0)
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - want[k]) / max(want[k], med))
    return worst


def loss_errors(prog, refr):
    """Each step's |loss - loss_ref| / |loss_ref|; inf where the program
    ran another number of steps or read no finite loss."""
    if len(prog["loss"]) != len(refr["loss"]):
        return [math.inf] * len(refr["loss"])
    return [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
            for a, b in zip(prog["loss"], refr["loss"])]


def judge_training(prog, refr, epoch_steps):
    """`prog`, `refr`: {"loss": [per step], "grad": {leaf: norm}, "change":
    {leaf: norm}}; `epoch_steps`: the steps of one epoch.  Returns {name:
    reading}."""
    med = float(np.median(list(refr["grad"].values())))
    keep = [k for k, v in refr["grad"].items() if v >= 1e-3 * med]
    losses = loss_errors(prog, refr)
    return {"loss_err": losses[0], "loss_err_pad": losses[epoch_steps - 1],
            "grad_gap": leaf_gaps(prog["grad"], refr["grad"], keep),
            "change_gap": leaf_gaps(prog["change"], refr["change"], keep)}
