"""Synthetic video fixture: COCO-format annotations + generated frames.

The port's own copy of `make_synthetic_video` from vatl4pose_tpu/data/
synthetic.py; for a given seed it writes bit-identical files.  A video of
F frames with P tracked "persons" (gaussian-blob bodies whose keypoints
follow a smooth trajectory), written as .npy frames plus a PoseTrack-style
annotation json.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

__all__ = ["make_synthetic_video"]

# a rough 17-keypoint human template in a unit box (x, y) in [0,1]
_TEMPLATE = np.array([
    [0.50, 0.08], [0.46, 0.05], [0.54, 0.05], [0.40, 0.07], [0.60, 0.07],
    [0.35, 0.22], [0.65, 0.22], [0.28, 0.38], [0.72, 0.38], [0.24, 0.52],
    [0.76, 0.52], [0.40, 0.55], [0.60, 0.55], [0.38, 0.75], [0.62, 0.75],
    [0.37, 0.95], [0.63, 0.95]], dtype=np.float32)


def make_synthetic_video(out_dir: str, num_frames: int = 8,
                         num_persons: int = 3, width: int = 320,
                         height: int = 240, seed: int = 166,
                         video_id: str = "000001",
                         img_format: str = "npy",
                         layout: str = "flat",
                         blob_sigma: float = 3.0,
                         blob_amp: float = 140.0,
                         channel_shift: int = 0,
                         bg_level: float = 40.0,
                         track_digits: int = 2,
                         vis_prob: float = 0.9) -> Tuple[str, str]:
    """Write frames + annotation json. Returns (root_dir, ann_relpath).

    img_format: "npy" or "png".  layout: "flat" (images/{video_id}/,
    annotations/) or "posetrack" (images/val/{video_id}_mpii_test/ and
    activelearning/val/{video_id}_mpii_test.json).  The appearance knobs
    (blob_sigma, blob_amp, channel_shift, bg_level) create domain gaps
    between videos; vis_prob is P(joint visible) and never shifts the rng
    stream.
    """
    rng = np.random.default_rng(seed)
    if layout == "posetrack":
        img_rel = f"images/val/{video_id}_mpii_test"
        ann_rel = f"activelearning/val/{video_id}_mpii_test.json"
    else:
        img_rel = f"images/{video_id}"
        ann_rel = f"annotations/{video_id}.json"
    img_dir = os.path.join(out_dir, img_rel)
    ann_dir = os.path.dirname(os.path.join(out_dir, ann_rel))
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    # person size/position scale with the frame so tiny fixtures stay valid
    w_lo, w_hi = 0.12 * width, 0.22 * width
    h_lo, h_hi = 0.45 * height, 0.7 * height
    sizes = rng.uniform([w_lo, h_lo], [w_hi, h_hi], size=(num_persons, 2))
    base_xy = rng.uniform(
        [10, 10], [max(11, width - w_hi - 20), max(11, height - h_hi - 15)],
        size=(num_persons, 2))
    vel = rng.uniform(-4, 4, size=(num_persons, 2))

    images, annotations = [], []
    for f in range(num_frames):
        img = (rng.uniform(0, bg_level,
                           size=(height, width, 3))).astype(np.float32)
        image_id = 10000 + f
        fname = f"{img_rel}/{f:06d}.{img_format}"
        for p in range(num_persons):
            xy = base_xy[p] + vel[p] * f
            w, h = sizes[p]
            kps = _TEMPLATE * np.array([w, h]) + xy
            kps = np.clip(kps, 0, [width - 1, height - 1])
            # draw blobs so heatmap models see structure
            yy, xx = np.mgrid[0:height, 0:width]
            for kx, ky in kps:
                img[..., (p + channel_shift) % 3] += blob_amp * np.exp(
                    -((yy - ky) ** 2 + (xx - kx) ** 2)
                    / (2 * blob_sigma ** 2))
            vis = (rng.uniform(size=17) > 1.0 - vis_prob).astype(np.float32)
            flat = np.stack([kps[:, 0], kps[:, 1], vis], axis=1).reshape(-1)
            x0, y0 = max(0.0, xy[0] - 5), max(0.0, xy[1] - 5)
            bw = min(w + 10, width - x0)
            bh = min(h + 10, height - y0)
            # the person sits in the last track_digits digits of the
            # annotation id, so the composite-id sort groups tracks
            ann_id = int(f"{f + 1}{p:0{track_digits}d}")
            annotations.append({
                "id": ann_id,
                "image_id": image_id,
                "category_id": 1,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "area": float(bw * bh),
                "iscrowd": 0,
                "keypoints": [float(v) for v in flat],
                "track_id": p,
            })
        img_u8 = np.clip(img, 0, 255).astype(np.uint8)
        if img_format == "npy":
            np.save(os.path.join(out_dir, fname), img_u8)
        else:
            import cv2
            cv2.imwrite(os.path.join(out_dir, fname),
                        cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
        images.append({"id": image_id, "image_id": image_id,
                       "file_name": fname, "width": width, "height": height,
                       "vid_id": video_id, "frame_id": f})
    cats = [{"id": 1, "name": "person",
             "keypoints": [f"kp{i}" for i in range(17)], "skeleton": []}]
    ann = {"images": images, "annotations": annotations, "categories": cats}
    with open(os.path.join(out_dir, ann_rel), "w") as fjson:
        json.dump(ann, fjson)
    return out_dir, ann_rel
