"""Video pose datasets (PoseTrack21 / JRDB-Pose) — array-oriented.

The port's own copy of vatl4pose_tpu/data/dataset.py (the in-memory path
only; the streaming frame store is not ported yet).  Per-person items from
COCO-format jsons are filtered (non-degenerate clipped bbox, non-zero
keypoints, >=1 visible) and sorted by the composite id
int(str(ann_id)[-D:] + str(image_id)) (D=2 PoseTrack, 3 JRDB), so that
index±1 is the same track in the adjacent frame.  THC's shifted gather
along the sample axis (ops/temporal.py) is only correct on that order;
`is_prev`/`is_next` come from track equality of the neighbours.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np

from .coco_json import CocoJson

__all__ = ["VideoPoseData", "VideoPoseDataset", "Posetrack21", "JRDB2022",
           "build_dataset", "decode_frame"]

POSETRACK_JOINT_PAIRS = [[5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
JRDB_JOINT_PAIRS = [[1, 2], [0, 4], [3, 4], [8, 10], [5, 7], [10, 13],
                    [14, 16], [4, 5], [7, 12], [4, 8], [3, 6], [13, 15],
                    [11, 14], [6, 9], [8, 11]]


def decode_frame(path: str) -> np.ndarray:
    """Decode one frame → (H, W, 3) uint8 RGB."""
    if path.endswith(".npy"):
        return np.load(path)
    import cv2
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def bbox_clip_xyxy(xyxy, width, height):
    """Clip to image bounds (alphapose/utils/bbox.py bbox_clip_xyxy)."""
    x1 = np.minimum(width - 1, np.maximum(0, xyxy[0]))
    y1 = np.minimum(height - 1, np.maximum(0, xyxy[1]))
    x2 = np.minimum(width - 1, np.maximum(0, xyxy[2]))
    y2 = np.minimum(height - 1, np.maximum(0, xyxy[3]))
    return (x1, y1, x2, y2)


def bbox_xywh_to_xyxy(xywh):
    """alphapose/utils/bbox.py:40-74: x2 = x1 + max(0, w - 1), likewise y."""
    x1, y1, w, h = xywh[0], xywh[1], xywh[2], xywh[3]
    return (x1, y1, x1 + np.maximum(0, w - 1), y1 + np.maximum(0, h - 1))


@dataclasses.dataclass
class VideoPoseData:
    """All per-person arrays of one video, dataset-order (composite-id sort)."""
    paths: List[str]                 # image path per item
    frame_idx: np.ndarray            # (N,) index into unique frame list
    frame_paths: List[str]           # unique frame paths (decode once each)
    img_ids: np.ndarray              # (N,)
    ann_ids: np.ndarray              # (N,) original annotation ids
    track_keys: List[str]            # vid_id+track_id strings
    bboxes: np.ndarray               # (N, 4) clipped xyxy (crop source box)
    raw_bbox_xywh: np.ndarray        # (N, 4) raw annotation bbox (xywh)
    gt_keypoints: np.ndarray         # (N, 3K) raw annotation keypoints
    joints_xy: np.ndarray            # (N, K, 2) keypoint positions
    joints_vis: np.ndarray           # (N, K) 0/1 visibility (min(1, v))
    is_prev: np.ndarray              # (N,) neighbor-validity flags
    is_next: np.ndarray
    width: int                       # first frame's size
    height: int
    frame_sizes: np.ndarray = None   # (F, 2) per unique frame (w, h)

    def __len__(self):
        return len(self.paths)


class VideoPoseDataset:
    """Base loader for COCO-format per-video pose annotations."""

    num_joints = 17
    joint_pairs = POSETRACK_JOINT_PAIRS
    track_suffix_digits = 2
    EVAL_JOINTS = list(range(17))

    def __init__(self, root: str, ann_file: str, check_files: bool = True):
        self._root = root
        self._ann_path = os.path.join(root, ann_file)
        self._check_files = check_files
        self.data = self._load()

    # -- json loading ------------------------------------------------------
    def _load(self) -> VideoPoseData:
        coco = CocoJson(self._ann_path)
        assert coco.cat_names() == ["person"], "incompatible categories"
        entries = []
        for iid in coco.img_ids():
            frame = coco.load_img(iid)
            abs_path = os.path.join(self._root, frame["file_name"])
            if self._check_files and not os.path.exists(abs_path):
                raise IOError(f"Image: {abs_path} not exists.")
            width = int(frame["width"])
            height = int(frame["height"])
            for obj in coco.anns_of(iid):
                parsed = self._parse_obj(obj, frame, width, height)
                if parsed is not None:
                    parsed["path"] = abs_path
                    entries.append(parsed)
        entries.sort(key=lambda e: e["id"])

        n = len(entries)
        frame_paths: List[str] = []
        frame_sizes: List[List[int]] = []
        frame_of: Dict[str, int] = {}
        frame_idx = np.zeros(n, np.int32)
        for i, e in enumerate(entries):
            if e["path"] not in frame_of:
                frame_of[e["path"]] = len(frame_paths)
                frame_paths.append(e["path"])
                frame_sizes.append([e["img_w"], e["img_h"]])
            frame_idx[i] = frame_of[e["path"]]

        track_keys = [e["track_key"] for e in entries]
        is_prev = np.zeros(n, bool)
        is_next = np.zeros(n, bool)
        for i in range(n):
            if i > 0 and track_keys[i - 1] == track_keys[i]:
                is_prev[i] = True
            if i < n - 1 and track_keys[i + 1] == track_keys[i]:
                is_next[i] = True

        return VideoPoseData(
            paths=[e["path"] for e in entries],
            frame_idx=frame_idx,
            frame_paths=frame_paths,
            img_ids=np.array([e["img_id"] for e in entries], np.int64),
            ann_ids=np.array([e["ann_id"] for e in entries], np.int64),
            track_keys=track_keys,
            bboxes=np.array([e["bbox"] for e in entries], np.float32),
            raw_bbox_xywh=np.array([e["raw_bbox"] for e in entries],
                                   np.float32),
            gt_keypoints=np.array([e["keypoint"] for e in entries],
                                  np.float32),
            joints_xy=np.stack([e["joints_xy"] for e in entries]),
            joints_vis=np.stack([e["joints_vis"] for e in entries]),
            is_prev=is_prev,
            is_next=is_next,
            width=int(frame_sizes[0][0]) if frame_sizes else 0,
            height=int(frame_sizes[0][1]) if frame_sizes else 0,
            frame_sizes=np.asarray(frame_sizes, np.int32).reshape(-1, 2),
        )

    def _parse_obj(self, obj, frame, width, height):
        """Validity filter (posetrack21.py:75-129 / jrdb2022.py)."""
        xyxy = bbox_clip_xyxy(bbox_xywh_to_xyxy(np.asarray(obj["bbox"],
                                                           np.float64)),
                              width, height)
        if xyxy[2] <= xyxy[0] or xyxy[3] <= xyxy[1]:
            return None
        kps = np.asarray(obj["keypoints"], np.float32)
        if kps.max() == 0:
            return None
        joints_xy = np.stack([kps[0::3], kps[1::3]], axis=-1)
        joints_vis = np.minimum(1, kps[2::3]).astype(np.float32)
        if joints_vis.sum() < 1:
            return None
        ann_id = int(obj["id"])
        d = self.track_suffix_digits
        comp_id = int(str(ann_id)[-d:] + str(frame["image_id"]))
        track_key = str(frame.get("vid_id", "")) + str(obj.get("track_id", ""))
        return {
            "bbox": xyxy,
            "img_w": width,
            "img_h": height,
            "raw_bbox": np.asarray(obj["bbox"], np.float32),
            "joints_xy": joints_xy,
            "joints_vis": joints_vis,
            "keypoint": kps,
            "id": comp_id,
            "ann_id": ann_id,
            "img_id": int(frame["image_id"]),
            "track_key": track_key,
        }

    # -- frame IO ----------------------------------------------------------
    def load_frames(self) -> np.ndarray:
        """Decode every unique frame once → (F, H, W, 3) uint8 RGB (single
        video, uniform frame size)."""
        frames = [decode_frame(p) for p in self.data.frame_paths]
        shapes = {f.shape for f in frames}
        if len(shapes) != 1:
            raise ValueError(f"mixed frame sizes {shapes}: the port has no "
                             "streaming frame store yet")
        return np.stack(frames).astype(np.uint8)

    def __len__(self):
        return len(self.data)


class Posetrack21(VideoPoseDataset):
    joint_pairs = POSETRACK_JOINT_PAIRS
    track_suffix_digits = 2


class JRDB2022(VideoPoseDataset):
    joint_pairs = JRDB_JOINT_PAIRS
    track_suffix_digits = 3


_DATASETS = {"Posetrack21": Posetrack21, "JRDB2022": JRDB2022}


def build_dataset(dataset_cfg: dict, check_files: bool = True):
    """`dataset_cfg` is a plain dict with TYPE, ROOT and ANN."""
    cls = _DATASETS[dataset_cfg["TYPE"]]
    return cls(root=dataset_cfg["ROOT"], ann_file=dataset_cfg["ANN"],
               check_files=check_files)
