"""Per-round pose/heatmap visualization (counterpart of
vatl4pose_tpu/cli/visualize_result.py; parity:
scripts/visualize_result.py; host-only, no device).

    python -m vatl4pose_tpu_torch.cli.visualize_result --work_dir RUN \
        --dataset_root ROOT --ann_file ANN [--heatmaps --round R]

Frames are read by data/image_io.py and the PNGs written by its
write_png; skeletons are drawn by utils/raster.py (cv2.line and
cv2.circle to the pixel), heatmap grids by utils/figure.py: no cv2 or
matplotlib.

Renders predicted skeletons per AL round from a run's predicted_kpt.json and
the video frames; optionally renders labeled/queried status overlays.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["render_round", "render_heatmaps", "main"]


def render_round(work_dir: str, dataset_root: str, ann_file: str,
                 out_dir: str, kp_thresh: float = 0.3):
    from ..data.coco_json import CocoJson
    from ..data.image_io import read_images, write_png
    from ..utils.vis import vis_frame_fast
    with open(os.path.join(work_dir, "predicted_kpt.json")) as f:
        preds = json.load(f)
    coco = CocoJson(os.path.join(dataset_root, ann_file))
    by_img = {}
    for p in preds:
        by_img.setdefault(p["image_id"], []).append(p)
    os.makedirs(out_dir, exist_ok=True)
    for iid, plist in by_img.items():
        img_info = coco.load_img(iid)
        path = os.path.join(dataset_root, img_info["file_name"])
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            img = read_images([path])[0]
        for p in plist:
            kpts = np.asarray(p["keypoints"], np.float32).reshape(-1, 3)
            img = vis_frame_fast(img, kpts, kp_thresh)
        write_png(os.path.join(out_dir, f"{iid}.png"), img)
    return out_dir


def render_heatmaps(work_dir: str, out_dir: str, round_idx: int = 0,
                    max_samples: int = 8):
    """Per-sample joint-heatmap grids from a --vis run's dumps
    (save_batch_heatmaps parity, scripts/visualize_result.py:100-150:
    one row per sample, one colored panel per joint with the peak marked).
    """
    from ..utils import figure as plt
    hm_dir = os.path.join(work_dir, "heatmap", f"Round{round_idx}")
    hms = np.load(os.path.join(hm_dir, "heatmaps.npy")).astype(np.float32)
    ann_ids = np.load(os.path.join(hm_dir, "ann_ids.npy"))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for j in range(min(max_samples, len(hms))):
        K = hms.shape[1]
        fig, axes = plt.subplots(1, K, figsize=(1.4 * K, 1.8))
        for k in range(K):
            ax = axes[k] if K > 1 else axes
            ax.imshow(hms[j, k], cmap="magma")
            y, x = np.unravel_index(np.argmax(hms[j, k]), hms[j, k].shape)
            ax.plot(x, y, "c+", markersize=6)
            ax.axis("off")
        fig.suptitle(f"ann {int(ann_ids[j])} round {round_idx}")
        path = os.path.join(out_dir, f"hm_{int(ann_ids[j])}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--work_dir", required=True,
                   help="AL run dir containing predicted_kpt.json")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--ann_file", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--heatmaps", action="store_true",
                   help="also render per-joint heatmap grids from the "
                        "--vis dumps (heatmap/Round*/heatmaps.npy)")
    p.add_argument("--round", type=int, default=0)
    a = p.parse_args(argv)
    out = a.out_dir or os.path.join(a.work_dir, "vis")
    print(render_round(a.work_dir, a.dataset_root, a.ann_file, out))
    if a.heatmaps:
        for pth in render_heatmaps(a.work_dir, os.path.join(out, "heatmaps"),
                                   a.round):
            print(pth)


if __name__ == "__main__":
    main()
