"""Estimator pre-training (counterpart of vatl4pose_tpu/cli/
posetrack_train.py; scripts/posetrack_train.py).

    python -m vatl4pose_tpu_torch.cli.posetrack_train \\
        --cfg configs/posetrack21/simplebaseline_posetrack21.yaml

From-scratch heatmap training: masked 0.5 x MSE, Adam (or SGD) with
MultiStepLR and an optional linear warmup (TRAIN.WARMUP_EPOCHS), the DPG
second stage at TRAIN.DPG_MILESTONE (DPG box augmentation on, the schedule
restarted on TRAIN.DPG_STEP), a snapshot every --snapshot epochs and at
the last one, validate_gt's COCO mAP on the training set's ground-truth
boxes, and model_best tracking (posetrack_train.py:30-212).

One model, built with fused_eval=True as the AL loop builds it, is
trained in place (train/retrain.Retrainer: the crops through K3 on the
card) and served in eval mode (the bottleneck tails through K1, the
decode through K2).  A single-resolution set keeps its frames on the
card; a set of mixed frame sizes, or --stream, keeps them in host RAM
and trains on the host warp's crops (data/stream.CropStreamer).
Checkpoints are the reference's layout: the model's state_dict as
model_{epoch}.pth and model_best.pth, which the AL loop loads as
MODEL.PRETRAINED.  MODEL.PRETRAINED may be a .pth or a .pkl of the JAX
package's Flax variables.  --device cpu runs on the CPU with the kernels'
plain versions; otherwise CUDA is required.  The distributed-launch flags
(--rank, --dist-url, --dist-backend, --launcher, --sync) are parsed and
not read, as in the JAX CLI: pre-training runs on one device (data
parallel is the AL loop's, cli/run_active_learning.py --data_parallel).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

__all__ = ["parse_args", "build_trainer", "train", "validate_gt", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PoseTrack21 training (H100)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--exp-id", default="default", dest="exp_id")
    p.add_argument("--work_dir", default="./exp")
    p.add_argument("--seed", type=int, default=123123)
    p.add_argument("--snapshot", type=int, default=2)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synth_videos", type=int, default=1,
                   help="with --synthetic: number of videos in the combined "
                        "training annotation (mixed resolutions)")
    p.add_argument("--epochs_override", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="host-RAM frames and prefetched host-warp crops "
                        "(forced for mixed-resolution annotation files)")
    # distributed-launch surface (parity: alphapose/opt.py:28-39)
    p.add_argument("--rank", type=int, default=-1)
    p.add_argument("--dist-url", dest="dist_url",
                   default="tcp://127.0.0.1:23456")
    p.add_argument("--dist-backend", dest="dist_backend", default="nccl")
    p.add_argument("--launcher", choices=["none", "pytorch", "slurm", "mpi"],
                   default="none")
    p.add_argument("--sync", action="store_true",
                   help="parsed and not read: pre-training runs on one "
                        "device")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; CUDA when not given")
    return p.parse_args(argv)


def _retrain_cfg(cfg):
    """The TRAIN section as the Retrainer's config (the rate is set every
    epoch, so LR_GAMMA is 1)."""
    name = str(cfg.TRAIN.OPTIMIZER)
    return {"OPTIMIZER": {"adam": "Adam", "sgd": "SGD"}.get(name.lower(),
                                                            name),
            "LR": cfg.TRAIN.LR, "LR_GAMMA": 1.0,
            "BATCH_SIZE": cfg.TRAIN.BATCH_SIZE}


def build_trainer(cfg, dataset, seed: int, device):
    """The estimator (fused_eval=True, torch's init under `seed`, then
    MODEL.PRETRAINED if set) on `device` (None means CUDA) and its
    Retrainer over the TRAIN section with DATASET.TRAIN.AUG."""
    import torch
    from ..data.pipeline import AugCfg
    from ..device import resolve_device
    from ..models import build_sppe
    from ..models.convert import load_weights, read_weights
    from ..train.retrain import Retrainer

    device = resolve_device(device)
    torch.manual_seed(seed)
    model = build_sppe(cfg.MODEL, cfg.DATA_PRESET, fused_eval=True,
                       device="cpu")
    path = cfg.MODEL.get("PRETRAINED", "")
    if path:
        load_weights(model, read_weights(path, cfg.MODEL.TYPE),
                     f"MODEL.PRETRAINED {path}")
    model.to(device)
    aug = cfg.DATASET.TRAIN.get("AUG", {})
    trainer = Retrainer(
        model, _retrain_cfg(cfg), cfg.MODEL.TYPE,
        input_size=tuple(cfg.DATA_PRESET.IMAGE_SIZE),
        hm_size=tuple(cfg.DATA_PRESET.HEATMAP_SIZE),
        sigma=cfg.DATA_PRESET.SIGMA,
        aug=AugCfg(scale_factor=aug.get("SCALE_FACTOR", 0.3),
                   rot_factor=aug.get("ROT_FACTOR", 40),
                   flip=aug.get("FLIP", True),
                   num_joints_half_body=aug.get("NUM_JOINTS_HALF_BODY", 8),
                   prob_half_body=aug.get("PROB_HALF_BODY", -1)),
        joint_pairs=dataset.joint_pairs, seed=seed, device=device)
    return model, trainer


def train(cfg, opt, device=None):
    """Trains the estimator of `cfg` on DATASET.TRAIN for TRAIN.BEGIN_EPOCH
    .. END_EPOCH (or --epochs_override) epochs, writing checkpoints under
    opt.work_dir.  device=None means opt.device, and then CUDA.  Returns
    (model, history): history has one dict an epoch with its lr, loss,
    acc, wall_s and, where it validated, ap."""
    import torch
    from ..data.dataset import build_dataset
    from ..data.stream import CropStreamer
    from ..device import resolve_device
    from ..train.optim import multistep_lr, with_warmup

    if getattr(opt, "launcher", "none") != "none":
        print(f"--launcher {opt.launcher}: pre-training runs on one device, "
              "as in the JAX CLI (the launch flags are not read)",
              flush=True)
    device = resolve_device(device if device is not None
                            else getattr(opt, "device", None))
    dataset = build_dataset(cfg.DATASET.TRAIN)
    model, trainer = build_trainer(cfg, dataset, opt.seed, device)
    d = dataset.data
    # a combined annotation over videos of several frame sizes (or
    # --stream) takes the streaming path; one video stays on the card
    use_stream = bool(getattr(opt, "stream", False)) or d.mixed_sizes
    store = frames = streamer = None
    if use_stream:
        store = dataset.frame_store()
        streamer = CropStreamer(d, store, trainer.input_size, trainer.aug,
                                dataset.joint_pairs, trainer.batch_size,
                                seed=opt.seed)
        print(f"[stream] {len(store)} frames, "
              f"{store.total_bytes / 2**20:.1f} MiB host-resident")
    else:
        frames = torch.from_numpy(dataset.load_frames()).to(device)
    factor = cfg.TRAIN.get("LR_FACTOR", 0.1)
    lr_fn = with_warmup(multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.LR_STEP,
                                     factor),
                        cfg.TRAIN.get("WARMUP_EPOCHS", 0))
    begin = cfg.TRAIN.BEGIN_EPOCH
    end = opt.epochs_override or cfg.TRAIN.END_EPOCH
    os.makedirs(opt.work_dir, exist_ok=True)
    best_ap = 0.0
    idx_all = np.arange(len(d))
    dpg_milestone = cfg.TRAIN.get("DPG_MILESTONE")
    history = []
    for epoch in range(begin, end):
        if dpg_milestone is not None and epoch == dpg_milestone:
            # the DPG second stage (posetrack_train.py:201-210): DPG box
            # augmentation, and the schedule restarted on DPG_STEP
            trainer.aug.add_dpg = True
            lr_fn = multistep_lr(cfg.TRAIN.LR, cfg.TRAIN.get("DPG_STEP", []),
                                 factor)
            print(f"DPG stage enabled at epoch {epoch}")
        lr = lr_fn(epoch)
        # one epoch at this rate: the trainer's own schedule is held flat
        trainer.lr_of = lambda _epoch, lr=lr: lr
        trainer.reset_schedule()
        t0 = time.perf_counter()
        if use_stream:
            loss, acc = trainer.retrain_streaming(streamer, idx_all, 1)
        else:
            loss, acc = trainer.retrain(d, frames, idx_all, 1,
                                        (d.width, d.height))
        rec = {"epoch": epoch, "lr": lr, "loss": loss, "acc": acc,
               "wall_s": time.perf_counter() - t0}
        print(f"epoch {epoch} | loss {loss:.6f} | acc {acc:.4f} "
              f"| lr {lr:.2e}", flush=True)
        if (epoch + 1) % opt.snapshot == 0 or epoch == end - 1:
            torch.save(_cpu_state(model),
                       os.path.join(opt.work_dir, f"model_{epoch}.pth"))
            ap = validate_gt(cfg, model, dataset, frames, store=store,
                             device=device)
            rec["ap"] = ap
            print(f"epoch {epoch} | validate AP {ap:.4f}", flush=True)
            if ap > best_ap:
                best_ap = ap
                torch.save(_cpu_state(model),
                           os.path.join(opt.work_dir, "model_best.pth"))
        history.append(rec)
    return model, history


def _cpu_state(model):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def validate_gt(cfg, model, dataset, frames, store=None, device=None):
    """COCO mAP of `model` on the ground-truth boxes of `dataset`
    (posetrack_train.py:89-133): one "None" scoring pass, resident on
    `frames` (uint8, best on the card) or, with frames None, streamed from
    the host `store`, then evaluate_map against the set's own keypoints."""
    from ..al.scoring import ScoringConfig, ScoringEngine
    from ..data.coco_json import CocoJson
    from ..eval.cocoeval import evaluate_map

    d = dataset.data
    engine = ScoringEngine(model, ScoringConfig(
        uncertainty="None", need_embedding=False,
        input_size=tuple(cfg.DATA_PRESET.IMAGE_SIZE),
        eval_joints=tuple(dataset.EVAL_JOINTS)), device=device)
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    args = (d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann, d.is_prev,
            d.is_next)
    if frames is None:
        res = engine.score_streaming(store, *args, keep_heatmaps=False)
    else:
        res = engine.score(frames, *args, keep_heatmaps=False)
    kpt_json, gt_json = [], []
    for j in range(len(d)):
        e = {"bbox": bbox_ann[j].tolist(), "image_id": int(d.img_ids[j]),
             "id": int(d.ann_ids[j]), "score": float(res["det_score"][j]),
             "category_id": 1, "keypoints": res["kpts"][j].tolist()}
        kpt_json.append(e)
        g = dict(e)
        g["keypoints"] = d.gt_keypoints[j].tolist()
        gt_json.append(g)
    src = CocoJson(os.path.join(cfg.DATASET.TRAIN.ROOT,
                                cfg.DATASET.TRAIN.ANN)).dataset
    gt = {"images": src["images"], "categories": src["categories"],
          "annotations": gt_json}
    return evaluate_map(kpt_json, gt)["AP"]


def synthetic_train_set(cfg, opt, prefix="vatl_pretrain_", track_digits=2):
    """--synthetic: a generated video (or, with --synth_videos > 1, a
    mixed-resolution multi-video set) as DATASET.TRAIN, under a new
    temporary directory."""
    import tempfile
    from ..data.synthetic import (make_synthetic_multivideo,
                                  make_synthetic_video)
    root = tempfile.mkdtemp(prefix=prefix)
    if opt.synth_videos > 1:
        _, ann = make_synthetic_multivideo(
            root, num_videos=opt.synth_videos, num_frames=8, num_persons=3,
            seed=opt.seed, appearance_jitter=True, track_digits=track_digits)
    else:
        _, ann = make_synthetic_video(root, num_frames=6, seed=opt.seed,
                                      track_digits=track_digits)
    cfg.DATASET.TRAIN.ROOT = root
    cfg.DATASET.TRAIN.ANN = ann
    return cfg


def main(argv=None):
    from ..config import update_config
    from ..device import resolve_device
    opt = parse_args(argv)
    resolve_device(opt.device)
    cfg = update_config(opt.cfg)
    np.random.seed(opt.seed)
    if opt.synthetic:
        cfg = synthetic_train_set(cfg, opt)
    return train(cfg, opt)


if __name__ == "__main__":
    main()
