"""Synthetic video fixture: COCO-format annotations + generated frames.

The port's own copy of `make_synthetic_video` and
`make_synthetic_multivideo` from vatl4pose_tpu/data/synthetic.py; for a
given seed they write bit-identical files.  A video of F frames with P
tracked "persons" (gaussian-blob bodies whose keypoints follow a smooth
trajectory), written as .npy, PNG, JPEG or BMP frames (IMG_FORMATS; the
JPEG and BMP files byte for byte cv2.imwrite's) plus a PoseTrack-style
annotation json; the multi-video set combines several such videos of different frame
sizes in one annotation, as a pre-training set does.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from .image_io import write_bmp, write_jpeg, write_png

__all__ = ["make_synthetic_video", "make_synthetic_multivideo",
           "IMG_FORMATS"]

# the frame formats the port writes, each without cv2: .npy, an 8-bit RGB
# PNG (the pixels cv2.imwrite stores, not its bytes), and cv2.imwrite's
# own bytes for a JPEG (quality 95, 4:2:0) and a BMP (24-bit)
IMG_FORMATS = ("npy", "png", "jpg", "jpeg", "bmp")

# a rough 17-keypoint human template in a unit box (x, y) in [0,1]
_TEMPLATE = np.array([
    [0.50, 0.08], [0.46, 0.05], [0.54, 0.05], [0.40, 0.07], [0.60, 0.07],
    [0.35, 0.22], [0.65, 0.22], [0.28, 0.38], [0.72, 0.38], [0.24, 0.52],
    [0.76, 0.52], [0.40, 0.55], [0.60, 0.55], [0.38, 0.75], [0.62, 0.75],
    [0.37, 0.95], [0.63, 0.95]], dtype=np.float32)


def make_synthetic_multivideo(out_dir: str, num_videos: int = 2,
                              num_frames: int = 4, num_persons: int = 2,
                              sizes=None, seed: int = 166,
                              img_format: str = "npy",
                              appearance_jitter: bool = False,
                              track_digits: int = 2) -> Tuple[str, str]:
    """A combined training annotation over `num_videos` synthetic videos of
    MIXED frame sizes (`sizes`, cycled), the synthetic analog of the
    integrated PoseTrack21 pre-training json
    (integrate_new_annotation.py:6-53); such a set takes the streaming
    path.  Video v is `make_synthetic_video` at seed + v; with
    `appearance_jitter` each video draws its blob size, amplitude,
    background level and colour channel from one Generator at seed + 7777.
    Image ids become 10000 * (v + 1) + frame, annotation ids
    f"{v + 1}{frame + 1:02d}{person:0{track_digits}d}", so the composite-id
    sort still groups tracks.  Returns (root_dir, combined_ann_relpath)."""
    if sizes is None:
        sizes = [(320, 240), (480, 360), (256, 192)]
    images, annotations = [], []
    jit_rng = np.random.default_rng(seed + 7777)
    for v in range(num_videos):
        w, h = sizes[v % len(sizes)]
        extra = {}
        if appearance_jitter:
            extra = dict(blob_sigma=float(jit_rng.uniform(2.5, 6.0)),
                         blob_amp=float(jit_rng.uniform(90.0, 170.0)),
                         bg_level=float(jit_rng.uniform(15.0, 70.0)),
                         channel_shift=int(jit_rng.integers(0, 3)))
        _, ann_rel = make_synthetic_video(
            out_dir, num_frames=num_frames, num_persons=num_persons,
            width=w, height=h, seed=seed + v, video_id=f"{v + 1:06d}",
            img_format=img_format, track_digits=track_digits, **extra)
        with open(os.path.join(out_dir, ann_rel)) as f:
            ann = json.load(f)
        for img in ann["images"]:
            img = dict(img)
            img["id"] = img["image_id"] = 10000 * (v + 1) + img["frame_id"]
            images.append(img)
        for a in ann["annotations"]:
            a = dict(a)
            frame = a["image_id"] - 10000
            a["id"] = int(f"{v + 1}{frame + 1:02d}"
                          f"{a['id'] % 10**track_digits:0{track_digits}d}")
            a["image_id"] = 10000 * (v + 1) + frame
            annotations.append(a)
    cats = [{"id": 1, "name": "person",
             "keypoints": [f"kp{i}" for i in range(17)], "skeleton": []}]
    rel = "annotations/combined_train.json"
    os.makedirs(os.path.join(out_dir, "annotations"), exist_ok=True)
    with open(os.path.join(out_dir, rel), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    return out_dir, rel


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

    img_format: one of IMG_FORMATS: "npy", "png" (8-bit RGB through
    image_io.write_png: the pixels cv2.imwrite would store, not its
    bytes), "jpg"/"jpeg" and "bmp" (image_io.write_jpeg and write_bmp:
    cv2.imwrite's bytes at its defaults); another extension raises
    ValueError.  layout: "flat" (images/{video_id}/,
    annotations/) or "posetrack" (images/val/{video_id}_mpii_test/ and
    activelearning/val/{video_id}_mpii_test.json).  The appearance knobs
    (blob_sigma, blob_amp, channel_shift, bg_level) create domain gaps
    between videos; vis_prob is P(joint visible) and never shifts the rng
    stream.
    """
    if img_format not in IMG_FORMATS:
        raise ValueError(f"img_format {img_format!r}: the port writes "
                         f"{', '.join(IMG_FORMATS)}")
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
        elif img_format == "png":
            write_png(os.path.join(out_dir, fname), img_u8)
        elif img_format == "bmp":
            write_bmp(os.path.join(out_dir, fname), img_u8)
        else:
            write_jpeg(os.path.join(out_dir, fname), img_u8)
        images.append({"id": image_id, "image_id": image_id,
                       "file_name": fname, "width": width, "height": height,
                       "vid_id": video_id, "frame_id": f})
    cats = [{"id": 1, "name": "person",
             "keypoints": [f"kp{i}" for i in range(17)], "skeleton": []}]
    ann = {"images": images, "annotations": annotations, "categories": cats}
    with open(os.path.join(out_dir, ann_rel), "w") as fjson:
        json.dump(ann, fjson)
    return out_dir, ann_rel
