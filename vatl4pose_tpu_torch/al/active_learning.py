"""The VATL active-learning orchestrator (counterpart of
vatl4pose_tpu/al/active_learning.py; reference ActiveLearning.py:51-925).

A per-(video, strategy) state machine: score every sample, COCO mAP and
OSPA (raw and with the labeled samples' annotations substituted), combine
uncertainty and representativeness, filter to a query batch, the AIFT
retrain-set policy, three stopping criteria, early-stop curve padding, and
the reference's 20-field result.

The port's own design:
  - One model.  A single estimator nn.Module (MODEL.TYPE through the
    SPPE registry: SimplePose, FastPose or PoseHighResolutionNet), built
    with `fused_eval=True`, is trained in place by the Retrainer (train
    mode: the exact module graph on cuDNN) and served by the
    ScoringEngine (eval mode: SimplePose's and FastPose's bottleneck tails
    through the chain kernel K1, BN folded from the current weights on
    every forward; HRNet has no K1 path).  The JAX package serves the
    unfused graph in parity mode and the fused one only under --speedup.
  - --speedup, as in the JAX package: bf16 serving (bf16 weights and
    crops, the bottleneck tails through K1 in bf16) and bf16 retraining
    (bf16 copies of the f32 master weights through the forward and
    backward).  The AE and the host evaluation stay f32.
  - The frames go to the device once and stay there across rounds, unless
    they exceed VAL.HBM_FRAME_BUDGET_GB (default 4 GiB): then they stay
    in host RAM (data/stream.FrameStore), and scoring and retraining take
    the host warp's crops a chunk or a batch at a time
    (ScoringEngine.score_streaming, Retrainer.retrain_streaming).
  - Pretrained weights: MODEL.PRETRAINED as a reference `.pth`
    (load_state_dict as it is) or a `.pkl` of numpy Flax variables
    (state_dict_from_flax); the AE likewise from
    AE.PRETRAINED_ROOT/Hybrid/WholeBodyAE_zdim{Z}.{pth,pkl}.  A path that
    is given and missing raises.  --from_scratch (and an empty
    AE.PRETRAINED_ROOT) takes PyTorch's init under torch.manual_seed(seed),
    which is not Flax's init: such runs do not match the JAX package's.
  - VL4Pose (SimplePose or FastPose: an estimator split into backbone
    and head): an AuxNet on the estimator's stride-32 feature, initialised
    from a generator seeded 318 (not Flax's PRNGKey(318) bits); one
    backbone pass feeds the head, the AuxNet and the embedding.
  - --vis, --vis_thc and --vis_wpu as in the JAX package: --vis keeps the
    pass's heatmaps and writes each round's heatmap/Round{r}/heatmaps.npy
    (float16), ann_ids.npy and prediction/Round{r}/predicted_kpt.json, and
    draws the cluster figure under the Coreset, K-Means and weighted
    filters; --vis_thc draws each sample's 3-frame heatmap grid;
    --vis_wpu recomputes the hybrid feature and the AE's reconstruction on
    the device and draws them.  The arrays the two criteria's figures are
    drawn from come from vis_thc_inputs and vis_wpu_inputs; the figures
    are drawn by utils/figure.py (no matplotlib).
  - --data_parallel under torchrun (WORLD_SIZE above 1): one process a
    rank (parallel/mesh.py's process model).  The process group is
    initialised if the caller has not, the loaded weights (estimator, AE,
    AuxNet) are broadcast from rank 0, and the Retrainer and the
    ScoringEngine get the mesh: each scoring pass's stage 1 and each
    resident retrain step's batch are sharded over the ranks.  Every rank
    runs the same host code; rank 0's query list is held against each
    rank's (a rank that selected another one raises), the AE fine-tune
    ends in a broadcast of rank 0's AE, and rank 0 alone logs and writes
    files.  With WORLD_SIZE unset or 1 the flag does nothing, as the JAX
    package's does on one device.

Device work per round: one chunked forward over the whole video and the
stage-2 scoring (al/scoring.py), the cosine product and the f32 coreset
greedy (al/selection.py), the retrain steps (train/retrain.py).  Host work:
json bookkeeping, mAP/OSPA, ranking and filters in float64.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from ..data.dataset import build_dataset
from ..data.pipeline import AugCfg
from ..device import resolve_device
from ..eval.cocoeval import evaluate_map
from ..eval.ospa import ospa_for_loc
from ..models import AuxNet, build_sppe, build_wholebody_ae
from ..models.convert import load_weights, read_weights
from ..ops import bbox_xyxy_to_xywh, compute_hybrid
from ..parallel import (broadcast_module, broadcast_object, init_distributed,
                        make_mesh, world_size)
from ..train.retrain import AETrainer, Retrainer
from ..utils.profiling import CycleTimer
from .al_metric import compute_corr, compute_spearmanr
from .index_sets import IndexCollection
from .scoring import ScoringConfig, ScoringEngine
from .selection import (coreset_selection, diversity_filter, fuse_thc_wpu,
                        influence_scores, kmeans_filter, minmax,
                        random_filter, rank_candidates, total_scores)

__all__ = ["ActiveLearning", "vis_thc_inputs", "vis_wpu_inputs"]


def _cpu_copy(state_dict):
    return {k: v.detach().cpu().clone() for k, v in state_dict.items()}


def _to_cpu(obj):
    """Tensors anywhere in a nested optimizer state → CPU (so a state file
    loads on a machine without a card)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def vis_thc_inputs(heatmaps, eval_joints, is_prev, is_next, ann_ids, thc):
    """What the --vis_thc hook draws (JAX package :402-411): for each
    sample with both neighbours, (ann id, the previous, own and next
    sample's heatmaps at eval_joints as host float32 arrays, its THC
    score).  heatmaps: the pass's (N, K, h, w) tensor or array."""
    hms = torch.as_tensor(heatmaps)[:, list(eval_joints)].float().cpu()
    hms = hms.numpy()
    return [(int(ann_ids[j]), hms[j - 1], hms[j], hms[j + 1], float(thc[j]))
            for j in range(len(hms)) if is_prev[j] and is_next[j]]


@torch.no_grad()
def vis_wpu_inputs(ae, bbox_crop, kpts, ann_ids, wpu, device):
    """What the --vis_wpu hook draws (JAX package :412-425): the hybrid
    feature of each sample's decoded keypoints (compute_hybrid's defaults,
    as the JAX hook calls it) and the AE's reconstruction of it, both
    computed on `device`; returns (ann ids, features, reconstructions,
    WPU values) as host arrays."""
    bb = torch.as_tensor(np.asarray(bbox_crop), dtype=torch.float32,
                         device=device)
    kp = torch.as_tensor(np.asarray(kpts), dtype=torch.float32,
                         device=device)
    feats = compute_hybrid(bbox_xyxy_to_xywh(bb), kp)
    recon = ae(feats)
    return (np.asarray(ann_ids), feats.cpu().numpy(), recon.cpu().numpy(),
            np.asarray(wpu))


class ActiveLearning:
    """One active-transfer-learning run over a single video.  device=None
    means CUDA (`opt.device` where the caller does not pass one)."""

    def __init__(self, cfg, opt, device=None):
        device = device if device is not None \
            else getattr(opt, "device", None)
        self.mesh = None
        if getattr(opt, "data_parallel", False) and world_size() > 1:
            # DP over the ranks (nn.DataParallel analog,
            # ActiveLearning.py:233): scoring's stage 1 AND each retrain
            # step's batch shard over 'data'
            if not torch.distributed.is_initialized():
                init_distributed(device)
            self.mesh = make_mesh(device=device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.primary = self.mesh is None or self.mesh.rank == 0
        self.cfg = cfg
        self.opt = opt
        self.round_cnt = 0
        self.is_early_stop = False
        self.one_by_one = getattr(opt, "onebyone", False)
        self.strategy = opt.strategy
        self.uncertainty = opt.uncertainty
        self.representativeness = opt.representativeness
        self.filter = opt.filter
        self.video_id = opt.video_id
        self.work_dir = opt.work_dir
        self.seed = getattr(opt, "seed", None)
        self.timer = CycleTimer(opt.work_dir if self.primary else None)
        self.rng = np.random.RandomState(self.seed)

        # ---- data: the frames go to the device once, or stream ------------
        self.dataset = build_dataset(cfg.DATASET.EVAL)
        self.data = self.dataset.data
        self.eval_len = len(self.data)
        budget = float(cfg.VAL.get("HBM_FRAME_BUDGET_GB", 4.0)) * (1 << 30)
        store = self.dataset.frame_store()
        self.streaming = store.total_bytes > budget
        if self.streaming:
            self.frame_store = store
            self.frames_dev = None
            self._log(f"[streaming] frames {store.total_bytes / 2**30:.2f} "
                      f"GiB > VAL.HBM_FRAME_BUDGET_GB: host-RAM frame store "
                      f"and chunked scoring")
        else:
            self.frame_store = None
            self.frames_dev = torch.from_numpy(
                self.dataset.load_frames()).to(self.device)
        self.img_wh = (self.data.width, self.data.height)
        self.eval_joints = tuple(self.dataset.EVAL_JOINTS)

        # ---- AL state --------------------------------------------------------
        self.finish_acc = getattr(opt, "retrain_thresh", 1.0)
        self.finish_margin = 0.05
        self.actual_finish = 100
        self.finished_minerror = 100
        self.finished_oursc = 100
        self.query_ratio = list(cfg.VAL.QUERY_RATIO)
        self.unc_lambda = cfg.VAL.UNC_LAMBDA
        self.w_unc = cfg.VAL.W_UNC
        self.query_sizes = [int(self.eval_len * x) for x in self.query_ratio]
        self.query_size = self.query_sizes[0]
        if self.one_by_one:
            self.query_size = 3
        self.unlabeled_id = IndexCollection(range(self.eval_len))
        self.labeled_id = IndexCollection()
        self.retrain_id = IndexCollection()
        self.moks_queried = 0.0
        self.continual = bool(getattr(opt, "continual", False))
        self.speedup = bool(getattr(opt, "speedup", False))

        # result accumulators (result.json schema, Run_active_learning.py:211)
        self.percentage: List[float] = []
        self.performance: List[dict] = []
        self.performance_ann: List[dict] = []
        self.ospa_list: List[float] = []
        self.ospa_list_ann: List[float] = []
        self.combine_weight: List[float] = []
        self.query_list_list: Dict[str, list] = {}
        self.uncertainty_dict: Dict[str, dict] = {}
        self.uncertainty_mean: List[float] = []
        self.influence_dict: Dict[str, dict] = {}
        self.spearmanr_list: List[float] = []
        self.corr_list: List[float] = []
        self.true_labeled_dict: Dict[str, list] = {}
        self.false_labeled_dict: Dict[str, list] = {}
        self.true_unlabeled_dict: Dict[str, list] = {}
        self.false_unlabeled_dict: Dict[str, list] = {}
        self.moksQ_list: List[float] = []

        # ---- model: one module, trained in place and served ----------------
        from_scratch = getattr(opt, "from_scratch", False)
        if from_scratch:
            torch.manual_seed(self.seed or 166)
        self.model = build_sppe(cfg.MODEL, cfg.DATA_PRESET, fused_eval=True,
                                device="cpu")
        if not from_scratch:
            self._load_pretrained()
        self.model.to(self.device)
        self._broadcast(self.model)
        self.pretrained_sd = _cpu_copy(self.model.state_dict())
        aug_cfg = cfg.DATASET.TRAIN.get("AUG", {})
        self.retrainer = Retrainer(
            self.model, cfg.RETRAIN, cfg.MODEL.TYPE,
            input_size=tuple(cfg.DATA_PRESET.IMAGE_SIZE),
            hm_size=tuple(cfg.DATA_PRESET.HEATMAP_SIZE),
            sigma=cfg.DATA_PRESET.SIGMA,
            aug=AugCfg(
                scale_factor=aug_cfg.get("SCALE_FACTOR", 0.3),
                rot_factor=aug_cfg.get("ROT_FACTOR", 40),
                flip=aug_cfg.get("FLIP", False),
                num_joints_half_body=aug_cfg.get("NUM_JOINTS_HALF_BODY", 8),
                prob_half_body=aug_cfg.get("PROB_HALF_BODY", -1)),
            joint_pairs=self.dataset.joint_pairs,
            seed=self.seed or 166, bf16=self.speedup, mesh=self.mesh,
            device=self.device)
        self.retrain_epoch = cfg.RETRAIN.BASE

        # ---- WPU autoencoder -------------------------------------------------
        self.ae = None
        if "WPU" in self.strategy:
            ae_root = cfg.AE.get("PRETRAINED_ROOT", "")
            if not ae_root:
                self._log("[AE] AE.PRETRAINED_ROOT is empty: PyTorch init "
                          "under the run's seed")
                torch.manual_seed(self.seed or 318)
            self.ae = build_wholebody_ae(cfg.AE, device="cpu")
            if ae_root:
                self._load_ae_pretrained(ae_root)
            self.ae.to(self.device)
            self._broadcast(self.ae)
            self.ae_pretrained_sd = _cpu_copy(self.ae.state_dict())
            self.ae_features = compute_hybrid(
                torch.from_numpy(self.data.raw_bbox_xywh),
                torch.from_numpy(self.data.gt_keypoints)).numpy()

        # ---- VL4Pose auxiliary net ------------------------------------------
        self.aux = None
        if "VL4Pose" in self.strategy:
            if cfg.MODEL.TYPE not in ("SimplePose", "FastPose"):
                raise ValueError("VL4Pose needs a backbone/head-split "
                                 "estimator (SimplePose or FastPose)")
            depth = cfg.MODEL.get("NUM_LAYERS", 50)
            self.aux = AuxNet(in_channels=2048 if depth >= 50 else 512,
                              device=self.device)
            self._broadcast(self.aux)

        # ---- scoring engine --------------------------------------------------
        need_emb = (self.representativeness not in ("None", "Random")
                    or self.filter not in ("None", "Random"))
        self.engine = ScoringEngine(
            self.model,
            ScoringConfig(uncertainty=self.uncertainty,
                          need_embedding=need_emb,
                          input_size=tuple(cfg.DATA_PRESET.IMAGE_SIZE),
                          eval_joints=self.eval_joints, bf16=self.speedup),
            ae_model=self.ae, aux_model=self.aux,
            chunk=min(512, max(32, self.eval_len)), device=self.device,
            mesh=self.mesh)
        if self.mesh is not None:
            self._log(f"[DP] scoring+retrain sharded over {self.mesh.size} "
                      f"ranks")
        self._log(f"[[AL strategy: {self.strategy}]] video {self.video_id} "
                  f"N={self.eval_len} model={cfg.MODEL.TYPE} "
                  f"device={self.device}")
        if getattr(opt, "verbose", False):
            # dataset smoke info (test_dataset, ActiveLearning.py:688-691)
            assert self.eval_len >= 1
            self._log(f"[verbose] sample 0: frame={int(self.data.frame_idx[0])}"
                      f" ann_id={int(self.data.ann_ids[0])}"
                      f" bbox={self.data.bboxes[0].tolist()}"
                      f" prev/next={bool(self.data.is_prev[0])}/"
                      f"{bool(self.data.is_next[0])}")

    # ------------------------------------------------------------------ utils
    def _log(self, msg):
        if self.primary:
            print(msg, flush=True)

    def _broadcast(self, module):
        """Rank 0's weights of `module` on every rank (under a mesh)."""
        if self.mesh is not None:
            broadcast_module(module, self.mesh.group("data"))

    def _load_pretrained(self):
        """MODEL.PRETRAINED into the model; a missing path raises."""
        path = self.cfg.MODEL.get("PRETRAINED", "")
        if not path:
            raise ValueError("MODEL.PRETRAINED is empty: give a .pth or .pkl "
                             "of pretrained weights, or --from_scratch")
        if not os.path.exists(path):
            raise FileNotFoundError(f"MODEL.PRETRAINED {path} does not exist")
        load_weights(self.model, read_weights(path, self.cfg.MODEL.TYPE),
                     f"MODEL.PRETRAINED {path}")

    def _load_ae_pretrained(self, root):
        """root/Hybrid/WholeBodyAE_zdim{Z}: the reference's torch .pth
        (ActiveLearning.py:895) or the JAX package's .pkl variable tree."""
        base = os.path.join(root, "Hybrid",
                            f"WholeBodyAE_zdim{self.cfg.AE.Z_DIM}")
        for ext in (".pth", ".pkl"):
            if os.path.exists(base + ext):
                load_weights(self.ae, read_weights(base + ext,
                                                   "WholeBodyAE"),
                             f"AE {base + ext}")
                return
        raise FileNotFoundError(f"no pretrained AE at {base}.pth or .pkl")

    # ------------------------------------------------------------- main round
    def eval_and_query(self):
        self._log(f"\n{self.video_id}[[Round{self.round_cnt}: "
                  f"{self.strategy}]]")
        self.timer.start_cycle(self.round_cnt)
        d = self.data
        # OKS / json bboxes use the clipped crop-source box converted to
        # xywh (ActiveLearning.py:304-312: bbox_xyxy_to_xywh(bboxes_ann))
        bbox_ann_xywh = np.stack(
            [d.bboxes[:, 0], d.bboxes[:, 1],
             d.bboxes[:, 2] - d.bboxes[:, 0],
             d.bboxes[:, 3] - d.bboxes[:, 1]], axis=1)
        args = (d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann_xywh,
                d.is_prev, d.is_next)
        vis = bool(getattr(self.opt, "vis", False))
        keep_hms = vis or bool(getattr(self.opt, "vis_thc", False))
        with self.timer.phase("score"):
            if self.streaming:
                res = self.engine.score_streaming(self.frame_store, *args,
                                                  keep_heatmaps=keep_hms)
            else:
                res = self.engine.score(self.frames_dev, *args,
                                        keep_heatmaps=keep_hms)

        kpts = res["kpts"].astype(np.float64)          # (N, 51)
        oks = res["oks"].astype(np.float64)
        det_score = res["det_score"].astype(np.float64)
        unc = res["unc"].astype(np.float64)
        unc2 = res["unc2"].astype(np.float64)
        gc = res["gc"].astype(np.float64)

        labeled = set(self.labeled_id.index)
        unlabeled_idx = list(self.unlabeled_id.index)

        # ---- json artifacts + mAP/OSPA --------------------------------------
        kpt_json, kpt_json_ann, gt_json = [], [], []
        for j in range(self.eval_len):
            entry = {
                "bbox": [float(v) for v in bbox_ann_xywh[j]],
                "image_id": int(d.img_ids[j]),
                "id": int(d.ann_ids[j]),
                "score": float(det_score[j]),
                "category_id": 1,
                "keypoints": [float(v) for v in kpts[j]],
                "OKS": float(oks[j]),
            }
            kpt_json.append(entry)
            e_ann = dict(entry)
            if j in labeled:
                e_ann["keypoints"] = [float(v) for v in d.gt_keypoints[j]]
            kpt_json_ann.append(e_ann)
            e_gt = dict(entry)
            e_gt["keypoints"] = [float(v) for v in d.gt_keypoints[j]]
            gt_json.append(e_gt)

        gt_dict = self._gt_coco_dict(gt_json)
        if self.primary:
            os.makedirs(self.work_dir, exist_ok=True)
            with open(os.path.join(self.work_dir, "predicted_kpt.json"),
                      "w") as f:
                json.dump(kpt_json, f)
            with open(os.path.join(self.work_dir, "GT_kpt.json"), "w") as f:
                json.dump(gt_dict, f)
        with self.timer.phase("map_ospa"):
            perf = evaluate_map(kpt_json, gt_dict)
            ospa = ospa_for_loc(gt_dict, kpt_json)
            perf_ann = evaluate_map(kpt_json_ann, gt_dict)
            ospa_ann = ospa_for_loc(gt_dict, kpt_json_ann)

        rc = f"Round{self.round_cnt}"
        # rank 0 alone writes the dumps and draws the figures
        vis = vis and self.primary
        if vis:
            # per-round artifact dumps (ActiveLearning.py:416-429, 448-453)
            hm_dir = os.path.join(self.work_dir, "heatmap", rc)
            os.makedirs(hm_dir, exist_ok=True)
            # cast where the heatmaps are (on the card: half the copy off
            # it); the same round-to-nearest-even as the JAX package's
            # host cast
            np.save(os.path.join(hm_dir, "heatmaps.npy"),
                    res["heatmaps"].to(torch.float16).cpu().numpy())
            np.save(os.path.join(hm_dir, "ann_ids.npy"), d.ann_ids)
            pred_dir = os.path.join(self.work_dir, "prediction", rc)
            os.makedirs(pred_dir, exist_ok=True)
            with open(os.path.join(pred_dir, "predicted_kpt.json"),
                      "w") as f:
                json.dump(kpt_json, f)

        self.percentage.append(len(labeled) / self.eval_len * 100)
        self.performance.append(perf)
        self.performance_ann.append(perf_ann)
        self.ospa_list.append(ospa)
        self.ospa_list_ann.append(ospa_ann)
        self._log(f"[Evaluation] Percentage:{self.percentage[-1]:.1f}, "
                  f"mAP:{perf['AP']:.3f} (ANN:{perf_ann['AP']:.3f}), "
                  f"OSPA:{ospa:.3f} (ANN:{ospa_ann:.3f})")

        # ---- uncertainty bookkeeping ----------------------------------------
        thcwpu = self.uncertainty == "THC+WPU"
        if thcwpu:
            unc_dict = {int(i): [float(unc[i]), float(unc2[i])]
                        for i in range(self.eval_len)}
        else:
            unc_dict = {int(i): float(unc[i]) for i in range(self.eval_len)}
        oks_dict = {int(i): float(oks[i]) for i in range(self.eval_len)}
        # the reference sums `uncertainty` per sample (the first criterion
        # only for THC+WPU), ActiveLearning.py:400-402
        self.uncertainty_mean.append(float(unc.sum()) / self.eval_len)

        # per-round criterion-quality correlations against OKS: shipped
        # disabled in the reference (ActiveLearning.py:430-436), computed
        # live here as in the JAX package, on the fused normalized
        # criterion for THC+WPU (the quantity selection consumes)
        if self.uncertainty != "None":
            if thcwpu:
                fused = minmax(unc) + minmax(unc2)
                corr_dict = {int(i): float(fused[i])
                             for i in range(self.eval_len)}
            else:
                corr_dict = {int(i): float(unc[i])
                             for i in range(self.eval_len)}
            self.spearmanr_list.append(compute_spearmanr(corr_dict,
                                                         oks_dict))
            self.corr_list.append(compute_corr(corr_dict, oks_dict))
            self._log(f"[Evaluation] Spearmanr: {self.spearmanr_list[-1]:.3f}"
                      f", Correlation: {self.corr_list[-1]:.3f}")

        # the criteria's figures (ActiveLearning.py:360-363 vis_thc,
        # :383-385 vis_wpu), per sample under work_dir
        if getattr(self.opt, "vis_thc", False) and "THC" in self.uncertainty \
                and self.primary:
            from ..utils.vis import visualize_thc
            thc_dir = os.path.join(self.work_dir, "vis_thc", rc)
            for ann_id, prev, cur, nxt, thc in vis_thc_inputs(
                    res["heatmaps"], self.eval_joints, d.is_prev, d.is_next,
                    d.ann_ids, unc):
                visualize_thc(thc_dir, ann_id, prev, cur, nxt, thc)
        if getattr(self.opt, "vis_wpu", False) and "WPU" in self.uncertainty \
                and self.primary:
            from ..utils.vis import visualize_wpu
            wpu_dir = os.path.join(self.work_dir, "vis_wpu", rc)
            ann_ids, feats, recon, wpu = vis_wpu_inputs(
                self.ae, res["bbox_crop"], kpts, d.ann_ids,
                unc2 if thcwpu else unc, self.device)
            for j in range(self.eval_len):
                visualize_wpu(wpu_dir, int(ann_ids[j]), feats[j], recon[j],
                              float(wpu[j]))

        combine_weight = float(gc[unlabeled_idx].sum()) if unlabeled_idx else 0.0

        # ---- influence -------------------------------------------------------
        influence_score = None
        if self.representativeness != "None":
            if len(unlabeled_idx) in (0, 1):
                influence_score = np.zeros(len(unlabeled_idx))
            elif self.representativeness == "Influence":
                influence_score = influence_scores(
                    res["embeddings"][unlabeled_idx], self.device)
            elif self.representativeness == "Random":
                influence_score = self.rng.rand(len(unlabeled_idx))
            else:
                raise ValueError("Representativeness type is not supported")
            self.influence_dict[f"Round{self.round_cnt}"] = {
                int(i): float(s) for i, s in zip(unlabeled_idx,
                                                 influence_score)}

        if len(unlabeled_idx) > 0:
            combine_weight /= len(unlabeled_idx)
            self.combine_weight.append(combine_weight)

        # ---- total score -----------------------------------------------------
        if len(unlabeled_idx) in (0, 1) or (self.uncertainty == "None"
                                            and influence_score is None):
            total_score = np.zeros(len(unlabeled_idx))
        else:
            unc_score = None
            if self.uncertainty != "None":
                if thcwpu:
                    labeled_ratio = len(labeled) / self.eval_len
                    unc_score = fuse_thc_wpu(
                        unc[unlabeled_idx], unc2[unlabeled_idx],
                        labeled_ratio,
                        mode=getattr(self.opt, "THCvsWPU", "const"))
                else:
                    unc_score = minmax(unc[unlabeled_idx])
                self.uncertainty_dict[f"Round{self.round_cnt}"] = unc_dict
            total_score = total_scores(unc_score, influence_score,
                                       combine_weight)

        # ---- candidates + filter --------------------------------------------
        if self.filter == "None":
            candidate_list = rank_candidates(unlabeled_idx, total_score,
                                             top_k=self.query_size)
        elif self.filter in ("weighted", "K-Means", "Coreset"):
            candidate_list = sorted(int(i) for i in unlabeled_idx)
        else:
            candidate_list = rank_candidates(unlabeled_idx, total_score,
                                             top_k=8 * self.query_size)

        with self.timer.phase("select"):
            query_list = self._apply_filter(candidate_list, total_score,
                                            res.get("embeddings"),
                                            combine_weight, unlabeled_idx)
        self._agree(query_list)

        # the cluster / coreset selection figure (pltcluster_and_save /
        # pltcoreset_and_save, ActiveLearning.py:551-617, behind a
        # hard-coded False there; under --vis here, as in the JAX package)
        if (vis and self.filter in ("Coreset", "K-Means", "weighted")
                and res.get("embeddings") is not None
                and res["embeddings"].shape[1] > 1 and len(query_list)):
            from ..utils.vis import plot_embedding_selection
            plot_embedding_selection(
                os.path.join(self.work_dir, "cluster"), res["embeddings"],
                query_list, f"{self.filter}_round{self.round_cnt}",
                weight=np.asarray(total_score) if len(total_score) else None)

        # ---- tl/tu/fl/fu ------------------------------------------------------
        thresh = self.finish_acc + self.finish_margin
        uset = set(unlabeled_idx)
        tl = [i for i in range(self.eval_len)
              if i in labeled and oks[i] >= thresh]
        fl = [i for i in range(self.eval_len)
              if i in labeled and oks[i] < thresh]
        tu = [i for i in range(self.eval_len)
              if i in uset and oks[i] >= thresh]
        fu = [i for i in range(self.eval_len)
              if i in uset and oks[i] < thresh]
        assert self.eval_len == len(tl) + len(tu) + len(fl) + len(fu)
        self.true_labeled_dict[rc] = tl
        self.true_unlabeled_dict[rc] = tu
        self.false_labeled_dict[rc] = fl
        self.false_unlabeled_dict[rc] = fu

        # ---- update sets + stopping -------------------------------------------
        if len(unlabeled_idx) != 0:
            self.retrain_id = IndexCollection()
            retrain_id, self.moks_queried = self._get_retrain_id(query_list,
                                                                 oks_dict)
            self.moksQ_list.append(self.moks_queried)
            self.retrain_id.update(retrain_id)
            self.labeled_id.update(query_list)
            self.unlabeled_id.difference_update(query_list)
            self.query_list_list[rc] = [int(q) for q in query_list]
            self._log(f"Queried: {sorted(query_list)}")
            self._is_finished(query_list, oks_dict)
        self.timer.end_cycle()

    def _agree(self, query_list):
        """Under a mesh: every rank must have selected rank 0's query (the
        same host code on the same gathered scores); a rank whose host
        state diverged raises rather than train on another set."""
        if self.mesh is None:
            return
        want = broadcast_object([int(q) for q in query_list],
                                self.mesh.group("data"))
        if [int(q) for q in query_list] != want:
            raise RuntimeError(
                f"rank {self.mesh.rank} selected another query than rank 0 "
                f"in round {self.round_cnt}: the ranks' host state diverged")

    def _gt_coco_dict(self, gt_json):
        from ..data.coco_json import CocoJson
        src = CocoJson(os.path.join(self.cfg.DATASET.EVAL.ROOT,
                                    self.cfg.DATASET.EVAL.ANN)).dataset
        return {"images": src["images"], "categories": src["categories"],
                "annotations": gt_json}

    def _apply_filter(self, candidate_list, total_score, embeddings,
                      combine_weight, unlabeled_idx):
        n_un = len(unlabeled_idx)
        if n_un in (0, 1) or self.filter == "None":
            return candidate_list
        if self.filter == "weighted":
            if n_un <= self.query_size:
                self.query_size = n_un
            weight = 1 + self.w_unc * combine_weight * np.asarray(total_score)
            return kmeans_filter(embeddings, candidate_list, self.query_size,
                                 weight=weight, dedupe=True)
        if self.filter == "K-Means":
            if n_un < self.query_size:
                self.query_size = n_un
            return kmeans_filter(embeddings, candidate_list, self.query_size)
        if self.filter == "Diversity":
            return diversity_filter(embeddings, candidate_list,
                                    self.query_size, self.device)
        if self.filter == "Random":
            return random_filter(candidate_list, self.query_size, self.rng)
        if self.filter == "Coreset":
            # clamped: with the taken-mask an over-sized request would pad
            # the tail once every unlabeled sample is picked
            if n_un < self.query_size:
                self.query_size = n_un
            unc_full = np.zeros(self.eval_len)
            unc_full[candidate_list] = np.asarray(total_score)
            return coreset_selection(
                embeddings, unc_full, self.labeled_id.index, self.query_size,
                self.unc_lambda, self.moks_queried,
                mode=self._coreset_mode(), rng=self.rng,
                precision="f64" if self.cfg.VAL.get("CORESET_F64") else "f32",
                device=self.device)
        raise ValueError("Filter type is not supported")

    def _coreset_mode(self):
        """ActiveLearning.py:798-850's branch structure."""
        if self.uncertainty == "None" or self.cfg.VAL.UNC_LAMBDA == 0:
            return "plain"
        if getattr(self.opt, "fixed_lambda", False):
            return "fixed"
        return "dynamic"

    def _get_retrain_id(self, query_list, oks_dict):
        """AIFT retrain policy (ActiveLearning.py:852-871)."""
        oks_q = [oks_dict[i] for i in query_list]
        moks_queried = float(np.mean(oks_q)) if oks_q else 0.0
        labeled = self.labeled_id.index
        retrain = [i for i in labeled
                   if oks_dict[i] <= self.finish_acc + self.finish_margin]
        retrain += list(query_list)
        return retrain, moks_queried

    def _is_finished(self, query_list, oks_dict):
        """Three stopping criteria (ActiveLearning.py:707-725)."""
        time = len(self.labeled_id.index) / self.eval_len * 100
        vals = np.array(list(oks_dict.values()))
        if np.all(vals >= self.finish_acc) and time < self.actual_finish:
            self.actual_finish = time
            self._log(f"[Finished] Actually finished at {time:.1f}%!")
            self.is_early_stop = True
        oks_q = np.array([oks_dict[i] for i in query_list])
        if np.mean(oks_q) >= self.finish_acc and time < self.finished_minerror:
            self.finished_minerror = time
        lq = self.labeled_id.index + list(query_list)
        oks_lq = np.array([oks_dict[i] for i in lq])
        if np.all(oks_lq >= self.finish_acc) and time < self.finished_oursc:
            self.finished_oursc = time

    # --------------------------------------------------------------- outcome
    def outcome(self):
        # --stopping: terminate once "our SC" (all labeled∪queried OKS ≥ τ)
        # has fired; the reference parses the flag but never consults it
        # (SURVEY.md §2.4).  Off by default.
        if getattr(self.opt, "stopping", False) and self.finished_oursc < 100:
            self.is_early_stop = True
        if self.is_early_stop or self.one_by_one:
            while len(self.performance) <= len(self.query_ratio):
                self.round_cnt += 1
                self.performance.append(self.performance[-1])
                self.performance_ann.append(self.performance_ann[-1])
                self.ospa_list.append(self.ospa_list[-1])
                self.ospa_list_ann.append(self.ospa_list_ann[-1])
                self.uncertainty_mean.append(self.uncertainty_mean[-1])
                self.percentage.append(
                    self.query_ratio[self.round_cnt - 1] * 100)
                self.combine_weight.append(self.combine_weight[-1])
                self.moksQ_list.append(self.moksQ_list[-1])
            return self._result()

        if not self.continual:
            # pretrained weights, a fresh optimizer and schedule each round
            self.model.load_state_dict(self.pretrained_sd)
            self.retrainer.reset_optimizer()
            self.retrainer.reset_schedule()
            self.retrain_epoch = int(
                self.cfg.RETRAIN.BASE * len(self.labeled_id.index)
                / self.eval_len
                + self.cfg.RETRAIN.ALPHA * (1 - self.moks_queried))
        else:
            self.retrain_epoch = int(
                self.cfg.RETRAIN.ALPHA * (1 - self.moks_queried))
        self._log(f"[Retrain Epoch]: {self.retrain_epoch}")
        self.timer.start_cycle(self.round_cnt)
        with self.timer.phase("retrain"):
            self._retrain_model()
        self.timer.end_cycle()
        self.round_cnt += 1
        if len(self.unlabeled_id.index) == 0:
            self._log(" --> Finished!")
            self.eval_and_query()
            return self._result()
        if self.round_cnt >= len(self.query_ratio):
            self.query_size = len(self.unlabeled_id.index)
        else:
            self.query_size = (self.query_sizes[self.round_cnt]
                               - len(self.labeled_id.index))
        return None

    def _retrain_model(self):
        if self.retrain_epoch > 0 and len(self.retrain_id.index) > 0:
            if self.streaming:
                from ..data.stream import CropStreamer
                tr = self.retrainer
                streamer = CropStreamer(
                    self.data, self.frame_store, tr.input_size, tr.aug,
                    tr.joint_pairs, tr.batch_size, seed=self.seed or 166)
                tr.retrain_streaming(streamer, self.retrain_id.index,
                                     self.retrain_epoch, log=self._log)
            else:
                self.retrainer.retrain(self.data, self.frames_dev,
                                       self.retrain_id.index,
                                       self.retrain_epoch, self.img_wh,
                                       log=self._log)
        if self.ae is not None:
            # pretrained weights again, then a fine-tune on the labeled
            # samples' GT features (ActiveLearning.py:681-685, 905-925)
            self.ae.load_state_dict(self.ae_pretrained_sd)
            labeled = self.labeled_id.index
            if labeled:
                AETrainer(lr=self.cfg.AE.LR, epochs=self.cfg.AE.EPOCH,
                          device=self.device).train(
                              self.ae, self.ae_features[labeled])
                self._broadcast(self.ae)

    # ---------------------------------------------------------- checkpoint
    _STATE_FIELDS = [
        "round_cnt", "is_early_stop", "query_size", "moks_queried",
        "percentage", "performance", "performance_ann", "ospa_list",
        "ospa_list_ann", "combine_weight", "query_list_list",
        "uncertainty_dict", "uncertainty_mean", "influence_dict",
        "spearmanr_list", "corr_list", "true_labeled_dict",
        "false_labeled_dict", "true_unlabeled_dict", "false_unlabeled_dict",
        "moksQ_list", "actual_finish", "finished_minerror", "finished_oursc",
        "retrain_epoch"]

    def save_state(self, path=None):
        """Checkpoint the whole AL state (round bookkeeping, model,
        optimizer, AE, rng streams) so that a crashed run resumes
        mid-video; the reference re-runs from scratch (SURVEY §5.3)."""
        path = path or os.path.join(self.work_dir, "al_state.pkl")
        state = {k: getattr(self, k) for k in self._STATE_FIELDS}
        state["labeled"] = self.labeled_id.index
        state["unlabeled"] = self.unlabeled_id.index
        state["retrain"] = self.retrain_id.index
        state["model"] = _cpu_copy(self.model.state_dict())
        state["optimizer"] = _to_cpu(self.retrainer.optimizer.state_dict())
        state["epoch_counter"] = self.retrainer.epoch_counter
        state["rng_state"] = self.rng.get_state()
        state["retrainer_rng"] = self.retrainer.rng.bit_generator.state
        if self.ae is not None:
            state["ae"] = _cpu_copy(self.ae.state_dict())
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return path

    def load_state(self, path):
        with open(path, "rb") as f:
            state = pickle.load(f)
        for k in self._STATE_FIELDS:
            setattr(self, k, state[k])
        self.labeled_id = IndexCollection(state["labeled"])
        self.unlabeled_id = IndexCollection(state["unlabeled"])
        self.retrain_id = IndexCollection(state["retrain"])
        self.model.load_state_dict(state["model"])
        self.retrainer.optimizer.load_state_dict(state["optimizer"])
        self.retrainer.epoch_counter = state["epoch_counter"]
        self.rng.set_state(state["rng_state"])
        self.retrainer.rng.bit_generator.state = state["retrainer_rng"]
        if "ae" in state and self.ae is not None:
            self.ae.load_state_dict(state["ae"])
        return self

    def _result(self):
        return (self.percentage, self.performance, self.performance_ann,
                self.query_list_list, self.uncertainty_dict,
                self.uncertainty_mean, self.influence_dict,
                self.combine_weight, self.spearmanr_list, self.corr_list,
                self.true_labeled_dict, self.true_unlabeled_dict,
                self.false_labeled_dict, self.false_unlabeled_dict,
                self.actual_finish, self.finished_minerror,
                self.finished_oursc, self.ospa_list, self.ospa_list_ann,
                self.moksQ_list)
