#!/usr/bin/env python3
"""What the pre-training of SimplePose-R50 at full width reaches on the
card, per epoch, for the choices chip_smoke.py makes about it:

    python3 scripts/pretrain_probe.py

  phase 7's pre-training (chip_smoke.stream_pretrain's settings:
  posetrack_train.train on the second JRDB-wide video, batch 180, Adam at
  1e-3, STREAM_PRETRAIN_WARMUP, no flips, rotations or scalings, on
  deterministic algorithms), once
  with the model's own head init (the reference's N(0, 1e-3)
  deconvolution and final kernels) and once with those layers put back to
  torch's default init (reset_parameters), as the port built them before;
  then phase 11's (PRETRAIN_CFG on phase 3's video: batch 180, Adam at
  1e-3, flips, rotation 40, scale 0.3), with the schedule cut to 8
  epochs (LR_STEP [3, 5], DPG at 7) and to 40 (PRETRAIN_TRAIN), each from
  the model's own init and from the first run's weights.

Each run prints one line `PROBE <label> <json>`: the wall and every
epoch's rate, loss, training accuracy and, where it validated,
validate_gt's AP.  Needs one CUDA card; the kernels are built as
chip_smoke.py builds them.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train(label, cfg, snapshot, work_dir, reset_head=False):
    """posetrack_train.train on `cfg`; prints the PROBE line and returns
    the trained model's state_dict."""
    import torch
    from vatl4pose_tpu_torch.cli import posetrack_train as pt
    build = pt.build_trainer

    def torch_default_head(*a, **kw):
        model, trainer = build(*a, **kw)
        with torch.no_grad():
            for m in (*model.deconv_layers, model.final_layer):
                if isinstance(m, (torch.nn.ConvTranspose2d,
                                  torch.nn.Conv2d)):
                    m.reset_parameters()
        return model, trainer
    if reset_head:
        pt.build_trainer = torch_default_head
    try:
        opt = argparse.Namespace(seed=0, snapshot=snapshot,
                                 epochs_override=None, work_dir=work_dir,
                                 stream=False, launcher="none", device=None)
        t0 = time.perf_counter()
        model, history = pt.train(cfg, opt)
        wall = time.perf_counter() - t0
    finally:
        pt.build_trainer = build
    print("PROBE " + label + " " + json.dumps({
        "wall_s": wall,
        "epochs": [[h["epoch"], h["lr"], h["loss"], h["acc"], h.get("ap")]
                   for h in history]}), flush=True)
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import torch
    import chip_smoke as cs
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.data import make_synthetic_video
    from vatl4pose_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("pretrain_probe: CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root, ann = cs.make_wide_video(f"{tmp}/wide", 1)
        cfg = Cfg(copy.deepcopy(cs.PRETRAIN_CFG))
        cfg.DATASET.TRAIN.update(TYPE="JRDB2022", ROOT=root, ANN=ann)
        cfg.DATASET.TRAIN.AUG.update(FLIP=False, ROT_FACTOR=0,
                                     SCALE_FACTOR=0.0)
        cfg.TRAIN.update(END_EPOCH=cs.STREAM_PRETRAIN_EPOCHS,
                         LR_STEP=list(cs.STREAM_PRETRAIN_LR_STEP),
                         WARMUP_EPOCHS=cs.STREAM_PRETRAIN_WARMUP)
        cfg.TRAIN.pop("DPG_MILESTONE")
        with cs.deterministic():          # as phase 7 trains
            wide = train("wide, head N(0, 1e-3)", copy.deepcopy(cfg),
                         cs.STREAM_PRETRAIN_EPOCHS, f"{tmp}/w0")
            train("wide, head torch default", copy.deepcopy(cfg),
                  cs.STREAM_PRETRAIN_EPOCHS, f"{tmp}/w1", reset_head=True)
        torch.save(wide, f"{tmp}/wide.pth")
        root, ann = make_synthetic_video(f"{tmp}/video", seed=0, **cs.VIDEO)
        cfg = Cfg(copy.deepcopy(cs.PRETRAIN_CFG))
        for split in ("TRAIN", "TEST"):
            cfg.DATASET[split].update(ROOT=root, ANN=ann)
        eight = copy.deepcopy(cfg)
        eight.TRAIN.update(END_EPOCH=8, LR_STEP=[3, 5], DPG_MILESTONE=7,
                           DPG_STEP=[])
        n = cs.PRETRAIN_TRAIN["END_EPOCH"]
        for init in ("", f"{tmp}/wide.pth"):
            for label, c in (("8 epochs", eight), (f"{n} epochs", cfg)):
                c = copy.deepcopy(c)
                c.MODEL.PRETRAINED = init
                train(f"video, {label}, from "
                      f"{'the wide weights' if init else 'its own init'}",
                      c, cs.PRETRAIN_SNAPSHOT, f"{tmp}/v")
    return 0


if __name__ == "__main__":
    sys.exit(main())
