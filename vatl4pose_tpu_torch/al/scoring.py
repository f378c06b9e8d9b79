"""Whole-video scoring engine (counterpart of vatl4pose_tpu/al/scoring.py).

  stage 1 (chunked): crop on the device → model forward → heatmaps and the
          2048-d embedding from the same backbone pass;
  stage 2 (whole video): decode through the post-process kernel
          (kernels/postprocess.py) and the inverse crop affine, OKS, THC as
          a shift along the track-sorted sample axis, WPU through the
          hybrid feature and the autoencoder, the local-peak weight `gc`.

Every sample's heatmap is computed once.  Eager PyTorch does not
recompile per shape, so neither stage pads to a static size; the outputs
for the real rows are the same.  Branches ported: THC_L1, THC_L2,
THC+WPU, WPU, HP and None.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.postprocess import fused_postprocess
from ..ops import (bbox_xyxy_to_xywh, compute_hybrid, compute_oks,
                   crop_batch, crop_to_image, thc_scores)

UNC_NONE = "None"
_PORTED = ("THC_L1", "THC_L2", "THC+WPU", "WPU", "HP", UNC_NONE)
_NOT_PORTED = ("TPC", "MPE", "Margin", "Entropy", "VL4Pose")


@dataclasses.dataclass
class ScoringConfig:
    uncertainty: str = "THC+WPU"
    need_embedding: bool = True
    input_size: Tuple[int, int] = (256, 192)
    eval_joints: Tuple[int, ...] = tuple(range(17))
    hybrid_drop_ears: bool = True
    # bf16 serving (--speedup): bf16 crops, bf16-rounded weights and BN
    # stats (the chain kernel still folds BN in f32); decode stays f32
    bf16: bool = False


class ScoringEngine:
    """Runs the two-stage scoring pipeline for one model on one device.

    `model` is a SimplePose (its own weights; `fused_eval=True` routes the
    backbone's bottleneck tails through the chain kernel), `ae_model` the
    WholeBodyAE that the WPU branches need.  device=None means CUDA.
    """

    def __init__(self, model, cfg: ScoringConfig, ae_model=None,
                 chunk: int = 512, device=None):
        u = cfg.uncertainty
        if u in _NOT_PORTED:
            raise NotImplementedError(
                f"uncertainty {u} is not ported yet (ROADMAP A11)")
        if u not in _PORTED:
            raise ValueError(f"Uncertainty type {u} is not supported")
        if "WPU" in u and ae_model is None:
            raise ValueError(f"uncertainty {u} needs ae_model")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.ae_model = ae_model
        self.chunk = chunk

    # ---- stage 1: heatmaps + embeddings ----------------------------------
    def _serving_model(self):
        if not self.cfg.bf16:
            return self.model
        # cast a copy per call, so weights updated by a retrain are seen
        return copy.deepcopy(self.model).to(torch.bfloat16)

    def _forward_chunk(self, model, frames, frame_idx, bboxes):
        dtype = torch.bfloat16 if self.cfg.bf16 else torch.float32
        crops, bbox_crop = crop_batch(frames, frame_idx, bboxes,
                                      self.cfg.input_size, dtype=dtype)
        x = crops.permute(0, 3, 1, 2)
        if self.cfg.need_embedding:
            hm, emb = model(x, return_embedding=True)
        else:
            hm = model(x)
            emb = torch.zeros((x.shape[0], 1), device=x.device)
        # heatmaps stay in the model's dtype: stage 2 upcasts at entry
        return hm, emb.to(torch.float32), bbox_crop

    @torch.no_grad()
    def forward_video(self, frames, frame_idx, bboxes):
        """Chunked forward over all N samples.  frames: (F, H, W, 3) uint8
        or float in [0, 255].  Returns device tensors (N, K, h, w),
        (N, E), (N, 4)."""
        frames = torch.as_tensor(frames, device=self.device)
        frame_idx = np.asarray(frame_idx)
        bboxes = np.asarray(bboxes, np.float32)
        model = self._serving_model()
        was_training = model.training
        model.eval()
        hms, embs, crops_bb = [], [], []
        try:
            for s in range(0, bboxes.shape[0], self.chunk):
                e = s + self.chunk
                hm, emb, bc = self._forward_chunk(model, frames,
                                                  frame_idx[s:e], bboxes[s:e])
                hms.append(hm)
                embs.append(emb)
                crops_bb.append(bc)
        finally:
            model.train(was_training)
        return torch.cat(hms), torch.cat(embs), torch.cat(crops_bb)

    # ---- stage 2: decode + criteria --------------------------------------
    @torch.no_grad()
    def _score_video(self, hms, bbox_crop, gt_kpts, bbox_ann_xywh, is_prev,
                     is_next) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        ej = torch.as_tensor(cfg.eval_joints, device=hms.device)
        pred = hms.index_select(1, ej).to(torch.float32).contiguous()
        H, W = pred.shape[-2:]
        hm_coords, scores, gc = fused_postprocess(pred)
        coords = crop_to_image(hm_coords, bbox_crop, (W, H))
        kpts = torch.cat([coords, scores[..., None]], dim=-1)
        kpts_flat = kpts.reshape(kpts.shape[0], -1)
        oks = compute_oks(kpts_flat, gt_kpts, bbox_ann_xywh)
        det_score = scores.mean(dim=-1) + 1.25 * scores.amax(dim=-1)

        n = hms.shape[0]
        unc = torch.zeros(n, device=hms.device)
        unc2 = torch.zeros(n, device=hms.device)
        u = cfg.uncertainty
        if u == "HP":
            unc = -scores.sum(dim=-1)
        elif "THC" in u:
            norm = "L2" if "L2" in u else "L1"
            unc = thc_scores(pred, is_prev, is_next, norm_type=norm)
            if "WPU" in u:
                unc2 = self._wpu(bbox_crop, kpts_flat)
        elif "WPU" in u:
            unc = self._wpu(bbox_crop, kpts_flat)
        return {"coords": coords, "scores": scores, "kpts": kpts_flat,
                "oks": oks, "det_score": det_score, "unc": unc, "unc2": unc2,
                "gc": gc}

    def _wpu(self, bbox_crop, kpts_flat):
        """WPU = MSE reconstruction error of the 38-d hybrid feature
        (ActiveLearning.py:364-386)."""
        feat = compute_hybrid(bbox_xyxy_to_xywh(bbox_crop), kpts_flat,
                              drop_ears=self.cfg.hybrid_drop_ears)
        recon = self.ae_model(feat)
        return (recon - feat).square().mean(dim=-1)

    # ---- public API -------------------------------------------------------
    def score(self, frames, frame_idx, bboxes, gt_kpts, bbox_ann_xywh,
              is_prev, is_next,
              keep_heatmaps: bool = True) -> Dict[str, np.ndarray]:
        """One scoring pass over a track-sorted video.  Returns numpy
        arrays coords (N, K, 2), scores (N, K), kpts (N, 3K), oks,
        det_score, unc, unc2, gc (N,), embeddings (N, E), bbox_crop (N, 4),
        and the device tensor heatmaps (N, K, h, w) if kept."""
        hms, embs, bbox_crop = self.forward_video(frames, frame_idx, bboxes)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        out = self._score_video(
            hms, bbox_crop, dev(gt_kpts, torch.float32),
            dev(bbox_ann_xywh, torch.float32), dev(is_prev, torch.bool),
            dev(is_next, torch.bool))
        res = {k: v.cpu().numpy() for k, v in out.items()}
        res["embeddings"] = embs.cpu().numpy()
        res["bbox_crop"] = bbox_crop.cpu().numpy()
        if keep_heatmaps:
            res["heatmaps"] = hms
        return res
