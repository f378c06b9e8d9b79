"""Offline estimator evaluation (counterpart of vatl4pose_tpu/cli/
poseestimator_eval.py; scripts/poseestimator_eval.py).

    python -m vatl4pose_tpu_torch.cli.poseestimator_eval \\
        --cfg configs/posetrack21/simplebaseline_posetrack21.yaml \\
        --checkpoint exp/model_best.pth --splits TEST

One "None" scoring pass over each split's ground-truth boxes (the crop
through K3, the backbone tails through K1, the decode through K2 on the
card), per-sample OKS, and the COCO keypoint mAP; writes
predicted_kpt_{split}.json (one entry a sample, with its OKS) under
--work_dir.  The weights are a reference .pth, a .pkl of the JAX package's
Flax variables, or, with neither --checkpoint nor MODEL.PRETRAINED,
torch's init under seed 0.  --device cpu runs on the CPU with the
kernels' plain versions; otherwise CUDA is required.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["parse_args", "load_model", "validate", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pose estimator eval (H100)")
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--splits", nargs="+", default=["TEST"])
    p.add_argument("--work_dir", default="./exp/eval")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; CUDA when not given")
    return p.parse_args(argv)


def load_model(cfg, checkpoint: str = "", device=None):
    """The estimator of `cfg` (fused_eval=True) with the weights of
    `checkpoint` or MODEL.PRETRAINED (.pth or .pkl), or torch's init under
    seed 0 when both are empty; on `device` (None means CUDA)."""
    import torch
    from ..device import resolve_device
    from ..models import build_sppe
    from ..models.convert import load_weights, read_weights

    device = resolve_device(device)
    ckpt = checkpoint or cfg.MODEL.get("PRETRAINED", "")
    if not ckpt:
        torch.manual_seed(0)
    model = build_sppe(cfg.MODEL, cfg.DATA_PRESET, fused_eval=True,
                       device="cpu")
    if ckpt:
        load_weights(model, read_weights(ckpt, cfg.MODEL.TYPE), ckpt)
    return model.to(device).eval()


def validate(cfg, model, split: str, device=None):
    """COCO mAP of `model` on DATASET[split]'s ground-truth boxes, its
    frames on the device.  Returns (evaluate_map's stats, the per-sample
    prediction entries with their OKS)."""
    import torch
    from ..al.scoring import ScoringConfig, ScoringEngine
    from ..data.coco_json import CocoJson
    from ..data.dataset import build_dataset
    from ..device import resolve_device
    from ..eval.cocoeval import evaluate_map

    device = resolve_device(device)
    ds_cfg = cfg.DATASET[split]
    dataset = build_dataset(ds_cfg)
    d = dataset.data
    frames = torch.from_numpy(dataset.load_frames()).to(device)
    engine = ScoringEngine(model, ScoringConfig(
        uncertainty="None", need_embedding=False,
        input_size=tuple(cfg.DATA_PRESET.IMAGE_SIZE),
        eval_joints=tuple(dataset.EVAL_JOINTS)), device=device)
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    res = engine.score(frames, d.frame_idx, d.bboxes, d.gt_keypoints,
                       bbox_ann, d.is_prev, d.is_next, keep_heatmaps=False)
    kpt_json, gt_json = [], []
    for j in range(len(d)):
        e = {"bbox": bbox_ann[j].tolist(), "image_id": int(d.img_ids[j]),
             "id": int(d.ann_ids[j]), "score": float(res["det_score"][j]),
             "category_id": 1, "keypoints": res["kpts"][j].tolist(),
             "OKS": float(res["oks"][j])}
        kpt_json.append(e)
        g = dict(e)
        g["keypoints"] = d.gt_keypoints[j].tolist()
        gt_json.append(g)
    src = CocoJson(os.path.join(ds_cfg.ROOT, ds_cfg.ANN)).dataset
    gt = {"images": src["images"], "categories": src["categories"],
          "annotations": gt_json}
    return evaluate_map(kpt_json, gt), kpt_json


def main(argv=None):
    from ..config import update_config
    from ..device import resolve_device
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    cfg = update_config(opt.cfg)
    if opt.synthetic:
        import tempfile
        from ..data.synthetic import make_synthetic_video
        root = tempfile.mkdtemp(prefix="vatl_eval_")
        _, ann = make_synthetic_video(root)
        for s in opt.splits:
            cfg.DATASET.setdefault(s, dict(cfg.DATASET.EVAL))
            cfg.DATASET[s].ROOT = root
            cfg.DATASET[s].ANN = ann
    model = load_model(cfg, opt.checkpoint, device)
    os.makedirs(opt.work_dir, exist_ok=True)
    for split in opt.splits:
        res, kpt_json = validate(cfg, model, split, device)
        print(f"##### {split} | AP: {res['AP'] * 100:.2f} "
              f"AP.5: {res['AP .5'] * 100:.2f} #####")
        with open(os.path.join(opt.work_dir,
                               f"predicted_kpt_{split}.json"), "w") as f:
            json.dump(kpt_json, f)


if __name__ == "__main__":
    main()
