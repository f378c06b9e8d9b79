"""Score traffic: back-to-back uncertainty passes of the port's scoring
engine over the whole video, as every AL round and the final evaluation
run them (`ScoringEngine.score` with THC+WPU and the embedding, heatmaps
not kept).  A unit of work is one pass; every answer of every pass in the
window is judged against the plain reference once the window has closed.
"""

from __future__ import annotations

import gc

import torch

from benchmark import port
from benchmark.reference import judge, scoring as ref
from benchmark.reference.layers import set_tf32
from benchmark.reference.models import build_ae, build_estimator
from benchmark.weights import ae_weights, estimator_weights


class Cell:
    def __init__(self, cfg, traffic, video, seed, device, precision):
        self.cfg, self.video, self.seed = cfg, video, seed
        self.device = device
        self.model, self.ae = port.build_models(cfg, seed, device,
                                                with_ae=True)
        self.engine = port.scoring_engine(cfg, self.model, self.ae,
                                          len(video.frame_idx), device,
                                          bf16=precision == "bf16")
        v = video
        self.args = (v.frames, v.frame_idx, v.bboxes, v.gt_keypoints,
                     v.bbox_ann_xywh, v.is_prev, v.is_next)
        self.n = len(v.frame_idx)
        self.chunks = [min(self.engine.chunk, self.n - s)
                       for s in range(0, self.n, self.engine.chunk)]
        self.passes = []

    def warm(self):
        """The window's own call, twice: the first loads the kernels and
        meets every shape, the second finds them warm."""
        for _ in range(2):
            self.engine.score(*self.args, keep_heatmaps=False)

    def unit(self):
        """One pass over the video; returns the samples scored."""
        self.passes.append(self.engine.score(*self.args,
                                             keep_heatmaps=False))
        return self.n

    def release(self):
        """Free the program's state before the reference runs."""
        del self.engine, self.model, self.ae
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, log):
        """The numbers of reference.judge over every pass kept."""
        r = reference_pass(self.cfg, self.video, self.seed, self.device)
        return judge.judge_scoring(self.passes, r, r["ae"])


def _models(cfg, seed, device, tf32=False):
    """The reference estimator and autoencoder with the run's weights."""
    est = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"]).to(device)
    est.load_state_dict(estimator_weights(cfg, seed, device))
    ae = build_ae(cfg["AE"]).to(device)
    ae.load_state_dict(ae_weights(cfg, seed, device))
    for m in (est, ae):
        set_tf32(m.eval(), tf32)
    return est, ae


@torch.no_grad()
def reference_pass(cfg, video, seed, device, tf32=False, block=128):
    """The plain pass over the whole video, in blocks of rows."""
    est, ae = _models(cfg, seed, device, tf32)
    size = tuple(cfg["DATA_PRESET"]["IMAGE_SIZE"])
    boxes = torch.as_tensor(video.bboxes, device=device)
    mats, crop_boxes = ref.crop_geometry(boxes, size)
    fi = torch.as_tensor(video.frame_idx, device=device)
    hms, embs = [], []
    for s in range(0, len(boxes), block):
        x = ref.crops(video.frames, fi[s:s + block], mats[s:s + block], size)
        hm, emb = est(x.permute(0, 3, 1, 2), return_embedding=True)
        hms.append(hm)
        embs.append(emb)
    hms, emb = torch.cat(hms), torch.cat(embs)
    coords, maxv, cells, shift, diff = ref.decode(hms, crop_boxes)
    gt = torch.as_tensor(video.gt_keypoints, device=device)
    box_ann = torch.as_tensor(video.bbox_ann_xywh, device=device)
    thc = ref.thc(hms, torch.as_tensor(video.is_prev, device=device),
                  torch.as_tensor(video.is_next, device=device))
    kpts = torch.cat([coords, maxv[..., None]], -1).reshape(len(boxes), -1)
    return {"hms": hms, "emb": emb, "coords": coords, "maxv": maxv,
            "cells": cells, "shift": shift, "diff": diff,
            "crop_boxes": crop_boxes, "gt": gt, "box_ann": box_ann,
            "thc": thc, "kpts": kpts, "ae": ae,
            "oks": ref.oks(kpts, gt, box_ann),
            "wpu": ref.wpu(ae, crop_boxes, kpts)}


def control(cfg, traffic, video, seed, device):
    """The control's readings: the reference in emulated TF32, in the
    program's place, judged as one pass of the program's."""
    c = reference_pass(cfg, video, seed, device, tf32=True)
    r = reference_pass(cfg, video, seed, device)
    return judge.judge_scoring([{
        "embeddings": c["emb"], "scores": c["maxv"], "coords": c["coords"],
        "unc": c["thc"], "kpts": c["kpts"], "oks": c["oks"],
        "unc2": c["wpu"]}], r, r["ae"])
