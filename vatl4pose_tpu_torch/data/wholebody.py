"""Whole-body hybrid-feature dataset for WPU autoencoder training
(counterpart of vatl4pose_tpu/data/wholebody.py).

Parity: active_learning/Whole_body_AE/Whole_body_hybrid.py:12-85: hybrid
features computed from a COCO-format annotation json, filtered to bodies
with at least one visible keypoint, sorted by the composite id (the
annotation id's last 2 digits for PoseTrack21, 3 for JRDB, then the image
id), optionally cached to a .npy file.  The feature is the 38-d ear-dropped
one (ops/hybrid.py), computed for all bodies in one batched call on the
host.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..ops.hybrid import compute_hybrid

__all__ = ["Wholebody"]


class Wholebody:
    """`features` (n, 38) float32 (or the raw (n, 51) keypoints with
    `kp_direct`) and `ann_ids` (n,) composite ids, in composite-id order.
    With `cache_dir`, the arrays are read from (or written to)
    cache_dir/<annotation file name>.npy."""

    def __init__(self, ann_path: str, dataset_type: str = "Posetrack21",
                 kp_direct: bool = False, cache_dir: Optional[str] = None):
        self.kp_direct = kp_direct
        digits = 2 if dataset_type == "Posetrack21" else 3
        cache_path = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(
                cache_dir, os.path.basename(ann_path) + ".npy")
            if os.path.exists(cache_path):
                blob = np.load(cache_path, allow_pickle=True).item()
                self.features = blob["features"]
                self.ann_ids = blob["ann_ids"]
                return
        with open(ann_path) as f:
            data = json.load(f)
        ids, boxes, kpts = [], [], []
        for ann in data["annotations"]:
            kps = np.asarray(ann["keypoints"], np.float32)
            if kps[2::3].sum() == 0:
                continue
            ids.append(int(str(int(ann["id"]))[-digits:]
                           + str(ann["image_id"])))
            boxes.append(np.asarray(ann["bbox"], np.float32))
            kpts.append(kps)
        order = sorted(range(len(ids)), key=lambda i: ids[i])
        self.ann_ids = np.array([ids[i] for i in order], np.int64)
        kpts = np.stack([kpts[i] for i in order])
        if kp_direct:
            self.features = kpts.astype(np.float32)
        else:
            boxes = np.stack([boxes[i] for i in order])
            self.features = compute_hybrid(
                torch.from_numpy(boxes), torch.from_numpy(kpts)
            ).numpy().astype(np.float32)
        if cache_path is not None:
            np.save(cache_path, {"features": self.features,
                                 "ann_ids": self.ann_ids})

    def __len__(self):
        return len(self.ann_ids)

    def __getitem__(self, i):
        return self.features[i]
