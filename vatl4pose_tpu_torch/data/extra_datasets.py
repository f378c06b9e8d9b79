"""Additional dataset loaders: MSCOCO keypoints, MPII, detection boxes
and concatenation (counterpart of vatl4pose_tpu/data/extra_datasets.py).

Parity: alphapose/datasets/mscoco.py, mpii.py, coco_det.py and
concat_dataset.py: AlphaPose's datasets, which the shipped VATL configs do
not use.  Mscoco and Mpii are single-image person-crop items from
COCO-format jsons with no temporal linkage; Mscoco_det pairs a person
detector's boxes with an annotation file's images; ConcatDataset lifts
each subset's joints into one combined label space.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..registry import DATASET
from .coco_json import CocoJson
from .dataset import (VideoPoseData, VideoPoseDataset, bbox_clip_xyxy,
                      bbox_xywh_to_xyxy, build_dataset, decode_frames)

__all__ = ["Mscoco", "Mpii", "Mscoco_det", "ConcatDataset"]


@DATASET.register_module
class Mscoco(VideoPoseDataset):
    """COCO val2017-style keypoint dataset: every item is its own track, so
    the temporal flags are always False."""
    num_joints = 17
    joint_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]
    track_suffix_digits = 2
    EVAL_JOINTS = list(range(17))

    def _parse_obj(self, obj, frame, width, height):
        parsed = super()._parse_obj(obj, frame, width, height)
        if parsed is not None:
            parsed["track_key"] = f"coco{parsed['ann_id']}"
        return parsed


@DATASET.register_module
class Mpii(VideoPoseDataset):
    """MPII 16-joint single-person dataset (a COCO-format json export)."""
    num_joints = 16
    joint_pairs = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
    track_suffix_digits = 2
    EVAL_JOINTS = list(range(16))

    def _parse_obj(self, obj, frame, width, height):
        parsed = super()._parse_obj(obj, frame, width, height)
        if parsed is not None:
            parsed["track_key"] = f"mpii{parsed['ann_id']}"
        return parsed


@DATASET.register_module
class Mscoco_det:
    """Detection boxes (a detector's results json: image_id, bbox xywh,
    score) paired with the image table of a COCO annotation file: the
    estimator's input where ground-truth boxes are missing.  The
    reference's lazy detector path is not ported; this loader reads an
    existing det_file.  Exposes whole-video-style arrays (frame_idx,
    clipped xyxy boxes, detection scores) that the scoring engine crops
    from."""

    num_joints = 17
    joint_pairs = Mscoco.joint_pairs
    EVAL_JOINTS = list(range(17))

    def __init__(self, root: str, ann_file: str, det_file: str,
                 check_files: bool = True):
        coco = CocoJson(os.path.join(root, ann_file))
        img_of = {im["id"]: im for im in coco.dataset["images"]}
        with open(os.path.join(root, det_file)) as f:
            dets = json.load(f)
        frame_paths, frame_of, frame_sizes, rows = [], {}, [], []
        for d in dets:
            iid = d["image_id"]
            if not isinstance(iid, int):
                iid = int(os.path.splitext(os.path.basename(iid))[0])
            im = img_of[iid]
            path = os.path.join(root, im["file_name"])
            if check_files and not os.path.exists(path):
                raise IOError(f"Image: {path} not exists.")
            if path not in frame_of:
                frame_of[path] = len(frame_paths)
                frame_paths.append(path)
                frame_sizes.append([int(im["width"]), int(im["height"])])
            xyxy = bbox_clip_xyxy(
                bbox_xywh_to_xyxy(np.asarray(d["bbox"], np.float64)),
                im["width"], im["height"])
            rows.append((frame_of[path], xyxy, d["bbox"],
                         float(d.get("score", 1.0)), iid))
        self.frame_paths = frame_paths
        self.frame_sizes = np.asarray(frame_sizes, np.int32).reshape(-1, 2)
        self.frame_idx = np.array([r[0] for r in rows], np.int32)
        self.bboxes = np.array([r[1] for r in rows], np.float32)
        self.raw_bbox_xywh = np.array([r[2] for r in rows], np.float32)
        self.det_scores = np.array([r[3] for r in rows], np.float32)
        self.img_ids = np.array([r[4] for r in rows], np.int64)

    def __len__(self):
        return len(self.frame_idx)

    def load_frames(self):
        frames = decode_frames(self.frame_paths)
        if len({f.shape for f in frames}) != 1:
            raise ValueError("mixed frame sizes: use a FrameStore")
        return np.stack(frames).astype(np.uint8)


@DATASET.register_module
class ConcatDataset:
    """Several datasets as one: each subset's K joints occupy
    [MASK_ID, MASK_ID + K) of the combined NUM_JOINTS label space, and the
    joints outside that slice have zero visibility, so the masked loss
    ignores them (concat_dataset.py:60-66)."""

    def __init__(self, set_list, num_joints: int, check_files: bool = True):
        self.num_joints = int(num_joints)
        self.subsets, datas, offsets = [], [], []
        for sub_cfg in set_list:
            sub = build_dataset(sub_cfg, check_files=check_files)
            self.subsets.append(sub)
            datas.append(sub.data)
            offsets.append(int(sub_cfg.get("MASK_ID", 0)))
        self.joint_pairs = self.subsets[0].joint_pairs
        self.EVAL_JOINTS = list(range(self.num_joints))

        def lift_kpts(flat, K, off):
            out = np.zeros((flat.shape[0], 3 * self.num_joints), np.float32)
            out[:, 3 * off:3 * (off + K)] = flat
            return out

        def lift_xy(a, K, off):
            out = np.zeros((a.shape[0], self.num_joints) + a.shape[2:],
                           a.dtype)
            out[:, off:off + K] = a
            return out

        frame_paths, frame_sizes = [], []
        parts = {f.name: [] for f in dataclasses.fields(VideoPoseData)}
        for si, (d, off) in enumerate(zip(datas, offsets)):
            K = d.joints_xy.shape[1]
            base = len(frame_paths)
            frame_paths += list(d.frame_paths)
            frame_sizes += list(np.asarray(d.frame_sizes).reshape(-1, 2))
            parts["paths"].append(d.paths)
            parts["frame_idx"].append(d.frame_idx + base)
            parts["img_ids"].append(d.img_ids)
            parts["ann_ids"].append(d.ann_ids)
            parts["track_keys"].append([f"s{si}:{t}" for t in d.track_keys])
            parts["bboxes"].append(d.bboxes)
            parts["raw_bbox_xywh"].append(d.raw_bbox_xywh)
            parts["gt_keypoints"].append(lift_kpts(d.gt_keypoints, K, off))
            parts["joints_xy"].append(lift_xy(d.joints_xy, K, off))
            parts["joints_vis"].append(lift_xy(d.joints_vis, K, off))
            parts["is_prev"].append(d.is_prev)
            parts["is_next"].append(d.is_next)
        cat = {k: np.concatenate(parts[k]) for k in (
            "frame_idx", "img_ids", "ann_ids", "bboxes", "raw_bbox_xywh",
            "gt_keypoints", "joints_xy", "joints_vis", "is_prev", "is_next")}
        self.data = VideoPoseData(
            paths=sum(parts["paths"], []),
            frame_paths=frame_paths,
            track_keys=sum(parts["track_keys"], []),
            width=int(frame_sizes[0][0]), height=int(frame_sizes[0][1]),
            frame_sizes=np.asarray(frame_sizes, np.int32).reshape(-1, 2),
            **cat)

    def __len__(self):
        return len(self.data)

    def frame_store(self, cache_bytes: int = 2 << 30):
        from .stream import FrameStore
        return FrameStore(self.data.frame_paths, self.data.frame_sizes,
                          cache_bytes=cache_bytes)
