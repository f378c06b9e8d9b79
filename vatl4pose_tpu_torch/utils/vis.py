"""Visualization: skeleton rendering, THC/WPU diagnostics, embedding
selections (counterpart of vatl4pose_tpu/utils/vis.py), drawn without
cv2 or matplotlib: the skeleton by utils/raster.py (cv2.line and
cv2.circle to the pixel), the figures by utils/figure.py.

Parity: alphapose/utils/vis.py:58-275 (vis_frame_fast skeleton overlay) and
ActiveLearning.py:927-1106 (visualize_thc / visualize_wpu /
pltcluster_and_save / pltcoreset_and_save).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from . import figure as plt
from . import raster

__all__ = ["COCO_PAIRS", "vis_frame_fast", "visualize_thc", "visualize_wpu",
           "plot_embedding_selection"]

COCO_PAIRS = [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9),
              (6, 8), (8, 10), (5, 11), (6, 12), (11, 12), (11, 13),
              (13, 15), (12, 14), (14, 16)]


def vis_frame_fast(img: np.ndarray, keypoints: np.ndarray,
                   kp_thresh: float = 0.3) -> np.ndarray:
    """Draw a 17-keypoint skeleton on an RGB uint8 image.
    keypoints: (17, 3) = (x, y, score)."""
    out = np.ascontiguousarray(img.copy())
    for a, b in COCO_PAIRS:
        if keypoints[a, 2] > kp_thresh and keypoints[b, 2] > kp_thresh:
            raster.line(out, tuple(keypoints[a, :2].astype(int)),
                        tuple(keypoints[b, :2].astype(int)), (0, 255, 255),
                        2)
    for k in range(len(keypoints)):
        if keypoints[k, 2] > kp_thresh:
            raster.circle(out, tuple(keypoints[k, :2].astype(int)), 3,
                          (255, 0, 0))
    return out


def visualize_thc(save_dir: str, ann_id: int, hm_prev, hm_cur, hm_next,
                  thc: float):
    """Per-joint 3-frame heatmap grid (ActiveLearning.py:927-998)."""
    K = hm_cur.shape[0]
    fig, axes = plt.subplots(3, K, figsize=(2 * K, 6))
    for row, hms in enumerate((hm_prev, hm_cur, hm_next)):
        for k in range(K):
            ax = axes[row, k] if K > 1 else axes[row]
            im = ax.imshow(hms[k], cmap="viridis")
            ax.axis("off")
    fig.suptitle(f"ann {ann_id}  THC {thc:.3f}")
    fig.colorbar(im, ax=axes.ravel().tolist(), shrink=0.5)
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"thc_{ann_id}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def visualize_wpu(save_dir: str, ann_id: int, feat_in: np.ndarray,
                  feat_out: np.ndarray, wpu: float):
    """Input/output hybrid-feature skeleton scatter (:1000-1036)."""
    n_kp = (len(feat_in) - 8) // 2
    fig, ax = plt.subplots()
    ax.scatter(feat_in[:n_kp], -feat_in[n_kp:2 * n_kp], label="input")
    ax.scatter(feat_out[:n_kp], -feat_out[n_kp:2 * n_kp], label="recon")
    ax.set_title(f"ann {ann_id}  WPU {wpu:.4f}")
    ax.legend()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"wpu_{ann_id}.png")
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_embedding_selection(save_dir: str, embeddings: np.ndarray,
                             query_list: Sequence[int], name: str,
                             weight: Optional[np.ndarray] = None,
                             cluster_idx: Optional[np.ndarray] = None):
    """2-D embedding scatter with selected queries highlighted
    (pltcluster_and_save / pltcoreset_and_save, :1038-1106; PCA instead of
    UMAP — umap is not available in this environment)."""
    x = embeddings - embeddings.mean(0)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    p2 = x @ vt[:2].T
    fig, ax = plt.subplots()
    c = cluster_idx if cluster_idx is not None else "gray"
    ax.scatter(p2[:, 0], p2[:, 1], c=c, s=18, alpha=0.6)
    q = np.asarray(list(query_list), int)
    if len(q):
        ax.scatter(p2[q, 0], p2[q, 1], marker="x", c="red", s=60,
                   label="queried")
    ax.legend()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{name}.png")
    fig.savefig(path)
    plt.close(fig)
    return path
