"""Whole-video scoring engine (counterpart of vatl4pose_tpu/al/scoring.py).

  stage 1 (chunked): crop on the device → model forward → heatmaps and the
          2048-d embedding from the same backbone pass (under VL4Pose the
          pass is split: one backbone feature feeds the head, the AuxNet
          and the embedding);
  stage 2 (whole video): decode through the post-process kernel
          (kernels/postprocess.py) and the inverse crop affine, OKS, THC
          and TPC as a shift along the track-sorted sample axis, WPU
          through the hybrid feature and the autoencoder, the peak-based
          MPE, Margin and VL4Pose, Entropy, the local-peak weight `gc`.

`score_streaming` is the path for frames that stay in host RAM: the
crops come from the host warp chunk by chunk, and stage 2 runs a chunk at
a time with a ±1-row halo, so the card holds O(chunk) of the video.

Every sample's heatmap is computed once.  Eager PyTorch does not
recompile per shape, so neither stage pads to a static size; the outputs
for the real rows are the same.  Every branch of the JAX package's
`_score_video` is ported: HP, TPC, THC_L1, THC_L2, THC+WPU, WPU, VL4Pose,
MPE, Entropy, Margin and None.

Data parallel (`mesh=`, parallel/mesh.py; one process a rank): the chunk
is rounded to a multiple of the mesh's size as in the JAX package, each
rank crops and forwards its contiguous block of every chunk (the last
chunk may be ragged: the blocks then differ by a row at most), and the
blocks' heatmaps, embeddings, crop boxes and AuxNet outputs are gathered.
Stage 2 runs on the whole gathered arrays on every rank: it is small, and
so every rank has the same scores for the same host-side selection.
`score_streaming` does not use the mesh, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.postprocess import fused_postprocess
from ..ops import (bbox_xyxy_to_xywh, compute_entropy, compute_hybrid,
                   compute_margin, compute_mpe, compute_oks, crop_batch,
                   crop_to_image, normalize_crops, thc_scores, tpc_scores)
from ..ops.vl4pose import vl4pose_scores
from ..parallel import all_gather
from ..utils.profiling import span

UNC_NONE = "None"
UNCERTAINTIES = ("HP", "TPC", "THC_L1", "THC_L2", "THC+WPU", "WPU",
                 "VL4Pose", "MPE", "Entropy", "Margin", UNC_NONE)


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

    @property
    def vl4pose(self) -> bool:
        return self.uncertainty == "VL4Pose"


class ScoringEngine:
    """Runs the two-stage scoring pipeline for one model on one device.

    `model` is the pose estimator (its own weights; on SimplePose and
    FastPose `fused_eval=True` routes the backbone's bottleneck tails
    through the chain kernel; VL4Pose needs their backbone/head split),
    `ae_model` the
    WholeBodyAE that the WPU branches need, `aux_model` the AuxNet that
    VL4Pose needs (it runs in f32 on the backbone feature, also under
    bf16 serving, as the JAX package's f32 aux variables do).  device=None
    means CUDA.  `mesh` (parallel.Mesh): stage 1 sharded over its 'data'
    axis; a mesh whose 'data' axis holds one rank scores as without one.
    """

    def __init__(self, model, cfg: ScoringConfig, ae_model=None,
                 aux_model=None, chunk: int = 512, device=None, mesh=None):
        u = cfg.uncertainty
        if u not in UNCERTAINTIES:
            raise ValueError(f"Uncertainty type {u} is not supported")
        if "WPU" in u and ae_model is None:
            raise ValueError(f"uncertainty {u} needs ae_model")
        if cfg.vl4pose and aux_model is None:
            raise ValueError("uncertainty VL4Pose needs aux_model")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.ae_model = ae_model
        self.aux_model = aux_model
        self.mesh = mesh if mesh is not None \
            and mesh.shape.get("data", 1) > 1 else None
        if self.mesh is not None:
            n_dev = mesh.size
            chunk = max(chunk, n_dev) // n_dev * n_dev
        self.chunk = chunk

    # ---- stage 1: heatmaps + embeddings ----------------------------------
    def _serving_model(self):
        if not self.cfg.bf16:
            return self.model
        # cast a copy per call, so weights updated by a retrain are seen
        return copy.deepcopy(self.model).to(torch.bfloat16)

    def _dtype(self):
        return torch.bfloat16 if self.cfg.bf16 else torch.float32

    @span("score.chunk")
    def _forward_chunk(self, model, frames, frame_idx, bboxes):
        crops, bbox_crop = crop_batch(frames, frame_idx, bboxes,
                                      self.cfg.input_size,
                                      dtype=self._dtype())
        return self._model_outputs(model, crops) + (bbox_crop,)

    def _model_outputs(self, model, crops):
        """(N, h, w, 3) normalized crops in the serving dtype →
        heatmaps (in the model's dtype: stage 2 upcasts at entry), f32
        embeddings and the AuxNet's f32 (N, L, 2) link parameters (None
        unless VL4Pose)."""
        x = crops.permute(0, 3, 1, 2)
        aux = None
        if self.cfg.vl4pose:
            # one backbone pass feeds the head, the AuxNet and the embedding
            feat = model.backbone(x)
            hm = model.head(feat)
            aux = self.aux_model(feat.to(torch.float32)).to(torch.float32)
            emb = feat.mean(dim=(2, 3))
        elif self.cfg.need_embedding:
            hm, emb = model(x, return_embedding=True)
        else:
            hm = model(x)
            emb = torch.zeros((x.shape[0], 1), device=x.device)
        return hm, emb.to(torch.float32), aux

    @torch.no_grad()
    @span("score.stage1")
    def forward_video(self, frames, frame_idx, bboxes):
        """Chunked forward over all N samples.  frames: (F, H, W, 3) uint8
        or float in [0, 255].  Returns device tensors (N, K, h, w),
        (N, E), (N, 4) and, under VL4Pose, (N, L, 2) (else None)."""
        frames = torch.as_tensor(frames, device=self.device)
        if frames.is_floating_point():       # the crop kernel reads f32
            frames = frames.to(torch.float32)
        frame_idx = np.asarray(frame_idx)
        bboxes = np.asarray(bboxes, np.float32)
        model = self._serving_model()
        was_training = model.training
        model.eval()
        outs = []
        try:
            for s in range(0, bboxes.shape[0], self.chunk):
                e = min(s + self.chunk, bboxes.shape[0])
                if self.mesh is not None:
                    outs.append(self._forward_block(model, frames,
                                                    frame_idx, bboxes, s, e))
                else:
                    outs.append(self._forward_chunk(model, frames,
                                                    frame_idx[s:e],
                                                    bboxes[s:e]))
        finally:
            model.train(was_training)
        hms, embs, auxs, crops_bb = zip(*outs)
        auxs = torch.cat(auxs) if self.cfg.vl4pose else None
        return torch.cat(hms), torch.cat(embs), torch.cat(crops_bb), auxs

    def _forward_block(self, model, frames, frame_idx, bboxes, s, e):
        """This rank's contiguous block of the chunk s..e, forwarded, then
        every rank's block gathered: the chunk's outputs on every rank.
        A rank whose block is empty (a last chunk of fewer rows than
        ranks) forwards one row and contributes none."""
        n, r = self.mesh.shape["data"], self.mesh.coords["data"]
        lo, hi = s + r * (e - s) // n, s + (r + 1) * (e - s) // n
        keep = hi - lo
        if keep == 0:
            lo, hi = s, s + 1
        out = self._forward_chunk(model, frames, frame_idx[lo:hi],
                                  bboxes[lo:hi])
        group = self.mesh.group("data")
        return tuple(None if t is None else all_gather(t[:keep], group)
                     for t in out)

    # ---- stage 2: decode + criteria --------------------------------------
    @torch.no_grad()
    @span("score.stage2")
    def _score_video(self, hms, bbox_crop, gt_kpts, bbox_ann_xywh, is_prev,
                     is_next, aux_params=None) -> Dict[str, torch.Tensor]:
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
        elif u == "TPC":
            unc = tpc_scores(hm_coords, coords, bbox_crop, is_prev, is_next,
                             (W, H))
        elif "THC" in u:
            norm = "L2" if "L2" in u else "L1"
            unc = thc_scores(pred, is_prev, is_next, norm_type=norm)
            if "WPU" in u:
                unc2 = self._wpu(bbox_crop, kpts_flat)
        elif "WPU" in u:
            unc = self._wpu(bbox_crop, kpts_flat)
        elif u == "VL4Pose":
            unc = vl4pose_scores(pred, aux_params)
        elif u == "MPE":
            unc = compute_mpe(pred)
        elif u == "Entropy":
            unc = compute_entropy(pred)
        elif u == "Margin":
            unc = compute_margin(pred)
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
    @torch.no_grad()
    @span("score.pass")
    def score_streaming(self, frame_store, frame_idx, bboxes, gt_kpts,
                        bbox_ann_xywh, is_prev, is_next,
                        keep_heatmaps: bool = False,
                        warp_mode: int = 1) -> Dict[str, np.ndarray]:
        """One scoring pass over a track-sorted video whose frames stay in
        host RAM (data/stream.FrameStore).  Stage 1 takes the host warp's
        uint8 crops a chunk at a time; stage 2 scores each chunk with one
        halo row on each side (THC's neighbours are a shift along the
        sample axis, so one row reproduces the whole-video result), one
        chunk behind stage 1, so that at most two chunks of heatmaps are
        on the card; TPC's neighbour decodes and VL4Pose's link
        parameters come with the halo rows too.  Returns what `score`
        returns; heatmaps, if kept, as a CPU tensor."""
        from ..data.pipeline import eval_sample_geometry
        from ..data.stream import warp_crops_host

        cfg = self.cfg
        dev = self.device
        bboxes = np.asarray(bboxes, np.float32)
        n = bboxes.shape[0]
        _, bbox_crop, fwd_mats = eval_sample_geometry(
            bboxes, cfg.input_size, want_fwd=True)
        frame_idx = np.asarray(frame_idx)
        host = {"bbox_crop": (bbox_crop, torch.float32, 1.0),
                "gt": (np.asarray(gt_kpts, np.float32), torch.float32, 0.0),
                "bb_ann": (np.asarray(bbox_ann_xywh, np.float32),
                           torch.float32, 1.0),
                "is_prev": (np.asarray(is_prev, bool), torch.bool, False),
                "is_next": (np.asarray(is_next, bool), torch.bool, False)}

        def halo(key, s, e):
            """Rows s..e-1 with one padding row on each side, on the
            card: row j is sample s + j - 1."""
            a, dtype, pad = host[key]
            out = np.full((e - s + 2,) + a.shape[1:], pad, a.dtype)
            out[1:-1] = a[s:e]
            return torch.as_tensor(out, dtype=dtype, device=dev)

        outs, embs, hms_kept = {}, [], []
        prev_tail = None      # the previous chunk's last heatmap row

        def stage2(s, e, hm, aux, next_head):
            nonlocal prev_tail
            zero = torch.zeros_like(hm[:1])
            rows = torch.cat([zero if prev_tail is None else prev_tail, hm,
                              zero if next_head is None else next_head])
            if aux is not None:
                aux_zero = torch.zeros_like(aux[:1])
                aux = torch.cat([aux_zero, aux, aux_zero])
            out = self._score_video(rows, *(halo(k, s, e) for k in host),
                                    aux)
            for k, v in out.items():
                outs.setdefault(k, []).append(v[1:-1])
            prev_tail = hm[-1:]

        model = self._serving_model()
        was_training = model.training
        model.eval()
        pending = None
        try:
            for s in range(0, n, self.chunk):
                e = min(s + self.chunk, n)
                with span("score.chunk"):
                    crops = warp_crops_host(frame_store, frame_idx[s:e],
                                            fwd_mats[s:e], cfg.input_size,
                                            mode=warp_mode)
                    hm, emb, aux = self._model_outputs(
                        model, normalize_crops(crops, dev, self._dtype()))
                embs.append(emb)
                if keep_heatmaps:
                    hms_kept.append(hm.cpu())
                if pending is not None:
                    stage2(*pending, next_head=hm[:1])
                pending = (s, e, hm, aux)
            if pending is not None:
                stage2(*pending, next_head=None)
        finally:
            model.train(was_training)
        with span("score.fetch"):
            res = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
            res["embeddings"] = torch.cat(embs).cpu().numpy()
        res["bbox_crop"] = bbox_crop
        if keep_heatmaps:
            res["heatmaps"] = torch.cat(hms_kept)
        return res

    @span("score.pass")
    def score(self, frames, frame_idx, bboxes, gt_kpts, bbox_ann_xywh,
              is_prev, is_next,
              keep_heatmaps: bool = True) -> Dict[str, np.ndarray]:
        """One scoring pass over a track-sorted video.  Returns numpy
        arrays coords (N, K, 2), scores (N, K), kpts (N, 3K), oks,
        det_score, unc, unc2, gc (N,), embeddings (N, E), bbox_crop (N, 4),
        and the device tensor heatmaps (N, K, h, w) if kept."""
        hms, embs, bbox_crop, aux = self.forward_video(frames, frame_idx,
                                                       bboxes)

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        out = self._score_video(
            hms, bbox_crop, dev(gt_kpts, torch.float32),
            dev(bbox_ann_xywh, torch.float32), dev(is_prev, torch.bool),
            dev(is_next, torch.bool), aux)
        with span("score.fetch"):
            res = {k: v.cpu().numpy() for k, v in out.items()}
            res["embeddings"] = embs.cpu().numpy()
            res["bbox_crop"] = bbox_crop.cpu().numpy()
        if keep_heatmaps:
            res["heatmaps"] = hms
        return res
