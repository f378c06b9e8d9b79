#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vatl4pose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error, each with its wall time:
  1. card and build: the card's name and power limit, torch/CUDA versions,
     the four CUDA kernels built with nvcc from csrc/, all at once
     (ptxas report included), and the tensor-core instructions (HGMMA,
     HMMA) of K1's f32 and bf16 kernels in the built library's SASS
     (cuobjdump), none of which fails the run;
  2. kernel vs plain PyTorch version on the card, at the shapes of the
     main paths, with CUDA-event times, bounds and errors: K1 (bottleneck
     chain; beside its bound its design's unfused byte floor, as a
     yardstick the same chain through cuDNN, and in f32 both versions'
     distance from the chain in f64, on random operands and, ROADMAP C1's
     check, on sums that cancel: K1 at most twice cuDNN's), K2 (heatmap
     post-process)
     and K3 (the crop, from uint8 and float32 frames to f32 and bf16
     crops: the retrain batch of 120 rotated, flipped and edge crops, and
     the scoring chunk of 512 rot=0 crops; beside it its copy variant,
     grid_sample as the library yardstick, its bound on these inputs, and
     at the scoring chunk the einsum crop it replaced, timed and
     profiled), each K2 and K3 time the kernel's own launches with the
     wrapper's time beside it;
  3. scoring path: one THC+WPU scoring pass (ScoringEngine, fused_eval) of
     SimplePose-R50 at 256x192 over a synthetic video of 512 samples, in
     f32 parity mode and in bf16, with the launch counters reset before
     each pass and checked after it (K1, K2 and K3 each launched);
     outputs checked for shape and finiteness; warm samples/s and a
     torch.profiler breakdown of one warm pass, which must run no
     aten::einsum; the first 32 samples' heatmaps and embeddings held
     against the same port run on the CPU;
  4. training path: the AL round's retrain of the phase-3 model (RETRAIN
     of configs/posetrack21/al_simple_posetrack.yaml: batch 120, AdamW,
     3 epochs = 15 steps, every crop through K3, the counters reset
     before and read after), a profile of one step, the WholeBodyAE
     fine-tune (AETrainer) and an f32 rescoring pass on the new weights;
     then one train step from the same weights on the card and on the CPU
     (f32, and f64 as the exact step), compared;
  5. AL loop: the port's CLI loop (run_active_learning's set_dir, do_al
     and save_result) on the DUW strategy (THC+WPU, Influence, Coreset,
     continual, seedfix, f32) over the phase-3 video's files laid out as
     PoseTrack21's video 000001 (phases 6, 9, 10, 12 and 13 too: the
     CLI's --synthetic would make the same video again, 35-45 s a loop),
     from phase 3's seeded weights written as a .pth and a
     seeded AE .pth, on configs/posetrack21/al_simple_posetrack.yaml
     read through the port's YAML reader with the cuts of CONFIG_CUTS
     (RETRAIN.ALPHA 250 -> 4; the roots and weights each phase sets): 9
     rounds and the final evaluation.  Checked: result.json's fields, percentages rising
     to 100, every sample queried once, a cycle_times.jsonl line a cycle,
     the launch counters (reset before the loop) at K1 4x, K2 1x and K3 1x
     a scoring pass and K3 once an optimizer step; then the retrained
     model through K1, K1's plain version, the unfused cuDNN graph and an
     f64 CPU forward (fold_check: K1 at most 2x cuDNN's f32 distance from
     f64), and round 0's coreset in f32 on the card against f64 on the
     host; each round's wall and phase split printed;
  6. the same loop with --speedup: bf16 serving (K1 and K3 in bf16) and
     bf16 retraining; the same checks, every K1 and K3 launch in bf16;
  7. streaming: the DUW loop in f32 on a JRDB-wide video (3760x480 .npy
     frames, 768 samples) over a cut frame budget, so that the frames stay
     in host RAM and the crops come from the host warp: it must stream,
     query every sample once and launch K1 and K2 per chunk and K3 never;
     the host warp's ms per chunk, the device time by kernel of a streamed
     pass, streamed scores against resident ones (the JAX package's
     bounds) and chunk 256 against chunk 512 (1e-5).  The loop starts from
     weights pre-trained on the video by jrdbpose_train's trainer, whose
     training accuracy must reach STREAM_PRETRAIN_ACC; that training and
     the loop's retrains run on deterministic algorithms (ROADMAP C6), and
     a retrain step's cost in that mode is printed;
  8. C1's card check: the DUW loop on a small R50 config on the card and
     on the CPU, both through the port, from weights pretrained on the
     video (every round's query list equal) and from random weights
     (printed: there even the CPU's fused and unfused graphs pick apart),
     beside K1's plain version and the unfused graph;
  9. the other strategies: one scoring pass of each of TPC, MPE, Margin,
     Entropy and VL4Pose (R50 at 256x192, 512 samples, f32: K3 1, K1 4
     and K2 1 launches a pass; VL4Pose's one backbone pass feeds the head,
     the AuxNet and the embedding), its stage 2 on the card against the
     CPU's on the same heatmaps; the loop through the CLI's functions on
     MPE + K-Means and on VL4Pose + weighted (checked as phase 5's, and
     every round's query holds query_size distinct candidates); two grid
     trials of --optimize's UNC_LAMBDA study through optimize_alc, with
     its two plots (matplotlib, cv2 and PIL refused at import, as in every
     figure below: the port draws its own);
 10. the other models: HRNet-W32 (configs/posetrack21/
     al_hrnet_posetrack.yaml) and FastPose-R50 (the MODEL of
     fastpose_posetrack21.yaml), seeded random weights, built through the
     SPPE registry: a THC+WPU scoring pass of each over phase 3's 512
     samples in f32 and in bf16 (K3 1, K2 1 and K1 4 for FastPose, 0 for
     HRNet a pass; K5 2 for FastPose's f32 pass), warm samples/s, a
     profile, the first 32 samples against the CPU; FastPose's VL4Pose
     pass (K1 4, K5 2) and fold_check (K1 and K5); each
     model's 15-step retrain (K3 once a step) and FastPose's train step on
     the card against the CPU; the DUW loop on HRNet-W32 through the CLI's
     functions, checked as phase 5's (K2 and K3 once a pass, K3 once a
     step, K1 never); the JAX package's plain kernels in eager PyTorch
     (deformable convolution v1/v2 with gradients, RoIAlign, deformable
     PS-RoI pooling) on the card against the CPU, timed; Fast Pose (DCN)
     (AlphaPose's FastPose-R50 with 13 deformable 3x3s in stages 2-4): a
     THC+WPU pass in chunks of 512 (K4 13, K1 1, K5 2 a chunk), K4's
     columns at those 13 inputs bit for bit the eager route's and timed
     beside its bound, a pass in chunks of 256 (K4 26, K5 4), the pass on
     the eager route (K4 0, the same heatmaps), warm samples/s, then with
     eager DUCs too (K5 0, heatmaps within 1e-4);
 11. the entry points before the AL loop (phase_pretraining):
     posetrack_train at full width (SimplePose-R50, 256x192, batch 180,
     the simplebaseline config's schedule cut to 40 epochs with its DPG
     stage, from phase 7's weights) on phase 3's video, K3 once a step and
     K1 4, K2 1, K3 1 a
     validation pass, its checkpoints against the model in memory; its
     streaming branch on a set of three frame sizes; jrdbpose_train's
     guard; poseestimator_eval on model_best.pth; wholebodyAE_train; the
     two checkpoints handed to ActiveLearning's loaders;
 12. analysis, tracking evaluation and --vis: the DUW loop with the main
     path's flags (--filter Coreset) and --vis through the CLI's
     functions, checked as phase 5's, Coreset's cluster figure each round
     (640x480 PNGs with the query markers' red), its per-round dumps
     (float16 heatmaps, ann ids, predictions) decoded on the host against
     the round's predictions; the arrays the --vis_thc and --vis_wpu hooks
     draw (vis_thc_inputs, vis_wpu_inputs) on a phase-3 pass on the card;
     then on the host, over the outputs of the card's loops (phases 5, 6,
     9, 10 and 12, kept by KEPT): summarize_result, detailed_result's
     numbers and the LaTeX table, then detailed_result.main's and
     wacv_result.main's figures (PNG, PDF), visualize_result.main
     --heatmaps on phase 12's work directory and convert_to_eps.main on
     the figures (each EPS decoded back to its PNG's pixels, each PDF
     parsed); pose_track_eval on phase 12's and phase 5's final
     predictions with the GT track ids, one sequence and two; JRDB AP on
     phase 7's predictions;
 13. data parallel (parallel/, --data_parallel), two gloo ranks sharing
     the one card (NCCL puts no two ranks on one device), at phase 3's
     width and video: (1) ActiveLearning with --data_parallel and no
     WORLD_SIZE has no mesh, and its round 0 is bit-identical to a round
     without the flag (both on deterministic algorithms; phase 5's, on
     cuDNN's default ones, is printed beside); (2) one Retrainer(mesh=) step
     of 120 (60 a rank, the last 20 rows padding, all on rank 1) against
     the one-process step from the same weights (tests/test_sharding.py:
     113's bounds: loss rel 1e-3 here, every gradient at cosine > 0.9999
     and norm rel 1e-2 or, past that, no further from an f64 step's than
     twice the one-process f32 step's, BN statistics rel 1e-4, the ranks'
     parameters bit-identical), the step's and the gradient all-reduce's
     ms; (3) a
     THC+WPU pass of ScoringEngine(mesh=) against the one-process pass at
     rtol 2e-4, atol 1e-5 (a sample whose argmax flips between two near-
     equal maxima apart from what follows the decode), K1 4, K2 1 and K3
     1 on each rank, samples/s; (4) phase 5's DUW loop, its rounds cut to
     3, on phase 3's video files laid out as a PoseTrack21 video, under
     `torchrun --standalone --nproc_per_node 2` with
     --data_parallel (this script with --dp-loop-rank as each rank),
     checked as phase 5's, every file written by rank 0, round 0's pass
     against step 1's as step 3 holds it, every rank's final estimator
     and AE bit-identical to rank 0's;
 14. the library tail, at full width: on (512, 17, 64, 48) f32 heatmaps
     the integral decode and the L1 joint-regression loss, forward and
     backward, for the three norm types, on the card against the CPU;
     flip_heatmap bit-identical to the CPU and, unshifted, its own
     inverse; phase 3's seeded R50 state_dict through save_checkpoint and
     load_checkpoint, try_load onto a 14-joint SimplePose-R50 (all but
     the final layer load) and onto R50 itself (all load), then a THC+WPU
     pass of 512 with the reloaded weights, bit-identical heatmaps to
     the pass before the save (deterministic algorithms), K1 4, K2 1, K3
     1;
 15. the entry points as a user starts them: every configs/**/*.yaml
     read through the port's YAML reader (the card's machine is
     specified without PyYAML);
     the committed JPEG video (tests/data/jpeg_video: 16 frames of phase
     3's generator at 640x360, 8 persons, 128 samples, written by cv2 at
     quality 90, 4:2:0) decoded by the port's JPEG decoder and held
     against the recorded SHA-256 of cv2's decode, ms a frame on the host;
     the same 16 frames (phase 3's video begins with them) written again
     by the port's JPEG encoder at quality 90, 4:2:0, each file equal to
     the committed one byte for byte, ms a frame on the host;
     then run_active_learning.main(argv), in this process (so that the
     launch counters can be read), with the DUW flags on the frames the
     encoder wrote, laid out as PoseTrack21's video 000001, matplotlib,
     cv2 and PIL refused, and --cfg a copy of
     configs/posetrack21/al_simple_posetrack.yaml whose only changes are
     entry_cuts (its dict checked equal to the file's elsewhere): checked
     as phase 5's loop (result.json, cycle_times.jsonl, K1 4x, K2 and K3
     1x a pass, K3 once a step), each round's query within the pool and
     disjoint from the samples labeled before; the loop's wall and split
     beside the card's name and power limit; then main() again with
     --vis --vis_thc --vis_wpu, QUERY_RATIO cut to its first two entries,
     checked the same way (on the committed files), with its figures of
     each kind counted and timed (host ms a figure); last the format
     fixtures (tests/data/formats: BMP, TIFF, PNG and progressive JPEG)
     decoded in cv2's and PIL's views and converted by convert_to_eps,
     each against the SHA-256s and refusals recorded from cv2, PIL and
     the JAX package, ms a 640x360 progressive JPEG and LZW TIFF;
 16. a `{"host_warp": ...}` line, a `{"kernels": [...]}` line (launches by
     main path), then the last line `{"ok": true, "device": {...}}`.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.  `--dp-loop-rank SPEC` runs one rank of phase 13's
loop (torchrun starts it).
"""

from __future__ import annotations

import contextlib
import copy
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from benchmark import bounds, chip, dcn_bounds

BATCH = 512
HM_SHAPE = (BATCH, 17, 64, 48)
VIDEO = dict(num_frames=64, num_persons=8, width=640, height=360)
MODEL = dict(num_joints=17, num_layers=50, deconv_dim=(256, 256, 256))
INPUT_SIZE = (256, 192)
HM_SIZE = (64, 48)
# RETRAIN, DATASET.TRAIN.AUG and AE of configs/posetrack21/
# al_simple_posetrack.yaml
RETRAIN = {"BATCH_SIZE": 120, "OPTIMIZER": "AdamW", "LR": 2.5e-4,
           "WEIGHT_DECAY": 0.7, "LR_GAMMA": 0.99}
AUG = dict(scale_factor=0.3, rot_factor=40.0, flip=False,
           num_joints_half_body=8, prob_half_body=-1.0)
AE_LR, AE_EPOCHS = 8e-5, 20
RETRAIN_EPOCHS = 3
# the AL loops' RETRAIN.ALPHA (250 in configs/posetrack21/
# al_simple_posetrack.yaml): a continual round retrains at most AL_ALPHA
# epochs instead of about 250 (CONFIG_CUTS)
AL_ALPHA = 4
# the streaming loop (phase 7): a JRDB-Pose-wide video (a stitched frame is
# 3760x480x3 = 5.41 MB), 96 frames = 0.48 GiB, 8 persons a frame = 768
# samples (scoring chunks of 512 and 256), on AL_CFG with two cuts:
# QUERY_RATIO 9 rounds -> 3, and the frame budget 4 GiB -> 0.25 GiB so
# that this video streams (a real scene streams past about 793 frames);
# RETRAIN.ALPHA 250 -> STREAM_ALPHA, not phase 5's 4: a continual round
# retrains ALPHA * (1 - the queries' mean OKS) epochs, which from
# pre-trained weights (mean OKS 0.82, then 0.29) round down to none at 4
# and come to 764 steps, 232 s, at the published 250
# (scripts/c6_repeat.py)
WIDE_VIDEO = dict(num_frames=96, num_persons=8, width=3760, height=480)
STREAM_QUERY_RATIO = [0.05, 0.5, 1.0]
STREAM_BUDGET_GB = 0.25
STREAM_ALPHA = 20
# before its loop, phase 7 pre-trains an R50 on the wide video with the
# JRDB pre-training CLI's trainer (jrdbpose_train: PRETRAIN_TRAIN below,
# Adam at the published 1e-3, batch 180, from the model's own init), for
# STREAM_PRETRAIN_EPOCHS with a linear warmup over
# STREAM_PRETRAIN_WARMUP epochs and the rate cut tenfold at
# STREAM_PRETRAIN_LR_STEP, without AUG's rotations and scalings (the
# scoring crops have none); its last epoch's training accuracy must reach
# STREAM_PRETRAIN_ACC.  Both that training and the loop's retrains run on
# deterministic algorithms (ROADMAP C6).
STREAM_PRETRAIN_EPOCHS = 40
STREAM_PRETRAIN_WARMUP = 5
STREAM_PRETRAIN_LR_STEP = [35]
STREAM_PRETRAIN_ACC = 0.5
# deterministic cuBLAS needs a fixed workspace: 8 buffers of 4096 KiB, the
# size PyTorch already gives a Hopper card by default, set before the
# first cuBLAS call
CUBLAS_WORKSPACE = ":4096:8"
# C1's card-vs-CPU loop (phase 8): configs/synthetic/al_simple_synthetic.
# yaml (128x96 input, 32x24 maps, RETRAIN, QUERY_RATIO, the AE's 2
# epochs), with SimplePose-R50 for its R18 (R18's basic blocks never reach
# K1; CONFIG_CUTS), on a 48-sample synthetic video
C1_VIDEO = dict(num_frames=12, num_persons=4, width=320, height=240)
C1_PRETRAIN_EPOCHS = 100
# the pre-training path (phase 11): configs/posetrack21/
# simplebaseline_posetrack21.yaml: SimplePose-R50 at 256x192, deconv
# 256x3, 64x48 maps, sigma 2; TRAIN batch 180, Adam at 1e-3, LR_FACTOR
# 0.1; AUG flip, rotation 40, scale 0.3; its cuts in CONFIG_CUTS.
# MODEL.PRETRAINED '' -> phase 7's pre-trained weights, in the place of
# the reference's ImageNet-initialised backbone: from the model's own init
# no validation gets past an AP of 0.001 in 40 epochs (0 in 8), so that
# model_best.pth, the evaluation and the hand-off would hold an untrained
# model; from phase 7's weights 40 epochs reach about 0.5 (8 reach 0.0003;
# scripts/pretrain_probe.py)
PRETRAIN_SNAPSHOT = 2
# the streaming branch: a combined set of three synthetic videos at the
# three frame sizes of make_synthetic_multivideo (240 samples, two steps
# an epoch), 2 epochs
PRETRAIN_STREAM_SET = dict(num_videos=3, num_frames=20, num_persons=4,
                           appearance_jitter=True)
PRETRAIN_STREAM_EPOCHS = 2
# the AE's pre-training: wholebodyAE_train's defaults (z 4, batch 10000,
# patience 30) with --epochs 80 -> 45, past both of its rate cuts (12, 40)
AE_PRETRAIN_EPOCHS = 45
# the fields of run_active_learning.save_result
RESULT_FIELDS = {
    "config_file", "video_id", "strategy", "model", "percentages",
    "performances", "performances_ann", "query_list", "uncertaity",
    "influence", "combine_weight", "mean_uncertaity", "spearmanr",
    "corrcoef", "true_labeled", "true_unlabeled", "false_labeled",
    "false_unlabeled", "actual_finish", "finished_minerror",
    "finished_oursc", "ospa", "ospa_ann", "moks_queried"}


HERE = Path(__file__).resolve().parent

# The configs the phases run, each read from its file in configs/ through
# the port's own YAML reader (the card's machine has no PyYAML), and every
# cut made to one, key by key: name -> (file, {key path: value}).
_AL_CUTS = {
    # 250 -> AL_ALPHA: a continual round retrains at most AL_ALPHA epochs
    ("RETRAIN", "ALPHA"): AL_ALPHA,
    # data/PoseTrack21/ -> '': each phase sets its video's files
    ("DATASET", "TRAIN", "ROOT"): "",
    ("DATASET", "EVAL", "ROOT"): "",
    # the published weights, which the card's machine does not have ->
    # '': a phase writes seeded or pre-trained weights (write_weights)
    ("MODEL", "PRETRAINED"): "",
    ("AE", "PRETRAINED_ROOT"): "",
}
CONFIG_CUTS = {
    # the AL loops (phases 5-7, 9, 12, 13)
    "AL_CFG": ("configs/posetrack21/al_simple_posetrack.yaml", _AL_CUTS),
    # C1 (phase 8): R18 -> R50
    "C1_CFG": ("configs/synthetic/al_simple_synthetic.yaml",
               {("MODEL", "NUM_LAYERS"): 50}),
    # pre-training (phases 7 and 11): the schedule's epochs by 5 (END_EPOCH
    # 200 -> 40, LR_STEP [90, 120] -> [18, 24], DPG_MILESTONE 140 -> 28,
    # DPG_STEP [160, 190] -> [32, 38]), WORLD_SIZE 4 -> one card
    # (BATCH_SIZE is the whole batch, as in the JAX CLI); the data's place
    # -> '': each phase sets its video's files
    "PRETRAIN_CFG": ("configs/posetrack21/simplebaseline_posetrack21.yaml",
                     {**{("DATASET", split, key): ""
                         for split in ("TRAIN", "TEST")
                         for key in ("ROOT", "ANN")},
                      ("TRAIN", "WORLD_SIZE"): 1,
                      ("TRAIN", "END_EPOCH"): 40,
                      ("TRAIN", "LR_STEP"): [18, 24],
                      ("TRAIN", "DPG_MILESTONE"): 28,
                      ("TRAIN", "DPG_STEP"): [32, 38]}),
    # HRNet's loop (phase 10): the AL loops' cuts, and VAL.VIS false
    "HRNET_CFG": ("configs/posetrack21/al_hrnet_posetrack.yaml",
                  {**_AL_CUTS, ("VAL", "VIS"): False}),
    # FastPose's passes (phase 10) read its MODEL
    "FASTPOSE_CFG": ("configs/posetrack21/fastpose_posetrack21.yaml", {}),
}


def with_cuts(tree, cuts, source):
    """`tree` (a nested dict) with each key path of `cuts` set to its
    value; a path the tree does not have raises KeyError."""
    for path, value in cuts.items():
        node = tree
        for key in path[:-1]:
            node = node[key]
        if path[-1] not in node:
            raise KeyError(f"{source} has no {'.'.join(path)} to cut")
        node[path[-1]] = copy.deepcopy(value)
    return tree


def repo_config(name):
    """CONFIG_CUTS[name]: its file read through the port's reader, with
    its cuts, as a plain dict."""
    from vatl4pose_tpu_torch.config import parse_yaml
    rel, cuts = CONFIG_CUTS[name]
    return with_cuts(parse_yaml((HERE / rel).read_text(), rel), cuts, rel)


try:
    AL_CFG, C1_CFG, PRETRAIN_CFG, HRNET_CFG, FASTPOSE_CFG = (
        repo_config(name) for name in CONFIG_CUTS)
except (ImportError, OSError):      # not a checkout: main() refuses it
    AL_CFG, C1_CFG, PRETRAIN_CFG, HRNET_CFG, FASTPOSE_CFG = {}, {}, {}, {}, {}
PRETRAIN_TRAIN = PRETRAIN_CFG.get("TRAIN")


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def deterministic():
    """Every op on deterministic algorithms (cuDNN's included) for the
    duration, then the previous settings back, so that no other phase's
    timing changes.  Ops with no deterministic implementation warn instead
    of raising, and are printed: their presence means the run is not
    deterministic.  CUBLAS_WORKSPACE_CONFIG is set by main() before the
    first cuBLAS call."""
    import os
    import warnings
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.benchmark)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
            torch.backends.cudnn.benchmark = was[2]
    ops = sorted({str(w.message).split(" does not have")[0][:120]
                  for w in caught if "deterministic" in str(w.message)})
    if ops:
        log(f"deterministic mode: ops without a deterministic "
            f"implementation ran: {ops}")


@contextlib.contextmanager
def patched(owner, name, make):
    """owner.name replaced by make(original) for the duration."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


# the figures: drawn by the port's own raster, plot, PDF and EPS writers
# (utils/raster.py, utils/figure.py, cli/convert_to_eps.py).  The card's
# machine is specified without matplotlib, cv2 and PIL, but cv2 and PIL
# were found importable there, so the figure work runs with them
# refused at import, by the finder of tests/test_torch_imports.py
FIGURE_REFUSED = ("matplotlib", "cv2", "PIL")


@contextlib.contextmanager
def refusing(names=FIGURE_REFUSED):
    """Imports of `names` raise ImportError for the duration (the modules
    already imported are set aside and put back after)."""
    import importlib.abc

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in names:
                raise ImportError(f"refused import of {name}")
            return None
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.split(".")[0] in names}
    finder = Refuse()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


class FigureTimes:
    """The port's figure functions wrapped to count and time their calls
    (host ms a figure), by name, for the duration."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.ms = {n: [] for n in names}
        self._stack = contextlib.ExitStack()

    def _wrap(self, name):
        def make(fn):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return timed
        return make

    def __enter__(self):
        for n in self.names:
            self._stack.enter_context(patched(self.module, n, self._wrap(n)))
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def summary(self):
        return {n: {"count": len(v),
                    "ms_each": statistics.median(v) if v else None}
                for n, v in self.ms.items()}


def png_pixels(path, size=None):
    """A figure PNG read back by the port's reader: (H, W, 3) uint8, of
    `size` (w, h) if given, and not one colour."""
    from vatl4pose_tpu_torch.data.image_io import read_images
    img = read_images([str(path)])[0]
    if size is not None and img.shape[:2] != (size[1], size[0]):
        raise AssertionError(f"{path}: {img.shape[1]}x{img.shape[0]}, "
                             f"want {size[0]}x{size[1]}")
    if not (img != img[0, 0]).any():
        raise AssertionError(f"{path}: one colour")
    return img


def eps_pixels(path):
    """The pixels of an EPS that convert_to_eps wrote: its hex body
    decoded to (H, W, channels)."""
    import numpy as np
    data = Path(path).read_bytes()
    w, h = (int(v) for v in data.split(b"%%BoundingBox: 0 0 ")[1]
            .split(b"\n")[0].split())
    ch = 3 if b"false 3 colorimage\n" in data else 1
    op = b"false 3 colorimage\n" if ch == 3 else b"\nimage\n"
    body = data[data.index(op) + len(op):data.index(b"\n%%%%EndBinary")]
    px = np.frombuffer(bytes.fromhex(body.replace(b"\n", b"").decode()),
                       np.uint8)
    return px.reshape(h, w, ch) if ch == 3 else px.reshape(h, w)


def pdf_image(path):
    """A one-page PDF of utils/figure.write_pdf parsed: the xref offsets
    point at their objects, and the page's image inflates to /Width x
    /Height x 3 bytes.  Returns (MediaBox, (H, W, 3) uint8)."""
    import re
    import zlib
    import numpy as np
    data = Path(path).read_bytes()
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    if data[start:start + 4] != b"xref":
        raise AssertionError(f"{path}: startxref points at no xref")
    offsets = [int(v) for v in re.findall(rb"(\d{10}) 00000 n",
                                          data[start:])]
    for i, off in enumerate(offsets, 1):
        if not data[off:].startswith(b"%d 0 obj" % i):
            raise AssertionError(f"{path}: object {i} not at {off}")
    box = [float(v) for v in re.search(rb"/MediaBox \[([\d. ]+)\]",
                                       data).group(1).split()]
    w = int(re.search(rb"/Width (\d+)", data).group(1))
    h = int(re.search(rb"/Height (\d+)", data).group(1))
    i = data.index(b"/Subtype /Image")
    m = re.search(rb"/Length (\d+) >>\nstream\n", data[i:])
    s0 = i + m.end()
    raw = zlib.decompress(data[s0:s0 + int(m.group(1))])
    if len(raw) != w * h * 3:
        raise AssertionError(f"{path}: image of {len(raw)} bytes for "
                             f"{w}x{h}")
    return box, np.frombuffer(raw, np.uint8).reshape(h, w, 3)


def launch_counts():
    from vatl4pose_tpu_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def cuda_ms(fn, reps=10, warm=2, inner=1):
    """Median device time of one fn() call in ms: CUDA events around
    `inner` back-to-back calls (so that a short kernel is not timed at the
    host's enqueue rate), divided by `inner`, after warm-up."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_card_and_build():
    import torch
    from vatl4pose_tpu_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    _build.build_seconds.items()))
    for name, info in _build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    counts = tensor_core_instructions(_build.lib_path("fused_bottleneck"))
    for fn, n in counts.items():
        log(f"  SASS {n:5d} tensor-core instructions in {fn}")
    per_entry = {"f32": 0, "bf16": 0}
    for fn, n in counts.items():
        per_entry["bf16" if "__nv_bfloat16" in fn else "f32"] += n
    log(f"K1 tensor-core instructions (HGMMA/HMMA) per entry point: "
        f"{per_entry}")
    if min(per_entry.values()) == 0:
        raise AssertionError("an entry point of K1 has no tensor-core "
                             "instruction")
    return card


def tensor_core_instructions(lib):
    """HGMMA (wgmma) and HMMA (mma.sync) instructions of each kernel
    function in a built library's SASS, from `cuobjdump -sass`."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HGMMA" in line or "HMMA" in line):
            counts[fn] += 1
    return counts


def _chain_inputs(N, H, W, C, P, nb, dtype, gen):
    import torch
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def uni(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    x = randn(N, H, W, C).relu().to(dtype)
    ws = (randn(nb, C, P, std=(2.0 / C) ** 0.5).to(dtype),
          uni(nb, P), randn(nb, P, std=0.1),
          randn(nb, 3, 3, P, P, std=(2.0 / (9 * P)) ** 0.5).to(dtype),
          uni(nb, P), randn(nb, P, std=0.1),
          randn(nb, P, C, std=(2.0 / P) ** 0.5).to(dtype),
          uni(nb, C, lo=0.1, hi=0.3), randn(nb, C, std=0.1))
    return x, ws


def cudnn_chain(x, ws):
    """The yardstick for K1, which the port never calls: the same chain as
    3*nb cuDNN convolutions in the stream dtype on channels-last tensors,
    each followed by its epilogue as eager ops in the stream dtype (TF32
    off, as main() sets it)."""
    import torch
    import torch.nn.functional as F
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = ws
    dt = x.dtype
    cl = torch.channels_last
    cur = x.permute(0, 3, 1, 2)          # NCHW view, channels-last memory
    for i in range(w1.shape[0]):
        k1 = w1[i].t()[:, :, None, None].contiguous(memory_format=cl)
        k2 = w2[i].permute(3, 2, 0, 1).contiguous(memory_format=cl)
        k3 = w3[i].t()[:, :, None, None].contiguous(memory_format=cl)
        h = torch.relu(F.conv2d(cur, k1) * s1[i].to(dt)[:, None, None]
                       + b1[i].to(dt)[:, None, None])
        h = torch.relu(F.conv2d(h, k2, padding=1)
                       * s2[i].to(dt)[:, None, None]
                       + b2[i].to(dt)[:, None, None])
        cur = torch.relu(F.conv2d(h, k3) * s3[i].to(dt)[:, None, None]
                         + b3[i].to(dt)[:, None, None] + cur)
    return cur


def phase_chain_kernel(dtype, gen):
    """K1 at the four R50 stage shapes, N=512.  Tolerances: f32 (3xTF32,
    against cuDNN in full f32) is of the order of f32 rounding, so
    max|err| <= 1e-4 of the output's max; bf16 rounds each of 3*nb
    epilogues to 8 mantissa bits, and a one-ulp flip in either version
    propagates down the chain, so max|err| <= 5e-2 and mean|err| <= 5e-3
    of the output's max.  Bound: the larger of the bytes (the stream read
    and written once, the weights read once) and the FLOPs, in bf16 over
    the tensor cores' peak, in f32 over the lesser of the CUDA cores' time
    and three TF32 products' time.  Beside it this design's unfused byte
    floor (4 stream sizes a block: the stream read twice and written once,
    y1 and y2 written and read) and the cuDNN chain as a yardstick.  In
    f32 also ROADMAP C1's check on the cancelling operands of
    tests/test_torch_cuda.py: K1 at most twice cuDNN's f32 distance from
    the chain in f64."""
    import torch
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference, fused_bottleneck_chain)
    f32 = dtype == torch.float32
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0,
           "cudnn_ms": 0.0, "max_abs_err": 0.0, "f64_err": 0.0,
           "plain_f64_err": 0.0}
    bound_share = {"operations": 0.0, "bytes": 0.0}
    for (H, W, C, P, nb) in bounds.resnet_tails(50, INPUT_SIZE):
        x, ws = _chain_inputs(BATCH, H, W, C, P, nb, dtype, gen)
        got = fused_bottleneck_chain(x, *ws)
        ref = bottleneck_chain_reference(x, *ws)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        max_err, mean_err = err.max().item(), err.mean().item()
        ok = (max_err <= 1e-4 * scale) if f32 else \
            (max_err <= 5e-2 * scale and mean_err <= 5e-3 * scale)
        if f32:
            # both versions' distance from the chain in f64 (cuDNN)
            exact = cudnn_chain(x.double(), [w.double() for w in ws]) \
                .permute(0, 2, 3, 1)
            e_scale = exact.abs().max().item()
            tot["f64_err"] = max(tot["f64_err"], (got.double() - exact)
                                 .abs().max().item() / e_scale)
            tot["plain_f64_err"] = max(
                tot["plain_f64_err"],
                (ref.double() - exact).abs().max().item() / e_scale)
            del exact
        ms = cuda_ms(lambda: fused_bottleneck_chain(x, *ws))
        plain_ms = cuda_ms(lambda: bottleneck_chain_reference(x, *ws),
                           reps=5)
        cudnn_ms = cuda_ms(lambda: cudnn_chain(x, ws), reps=5)
        flops = 2.0 * BATCH * H * W * (2 * C * P + 9 * P * P) * nb
        bound = bounds.k1_bound_s(BATCH, [(H, W, C, P, nb)],
                                  x.element_size()) * 1e3
        # the bound's side: its bytes are the stream read and written once
        # and the operands read once
        t_bytes = (2 * x.numel() * x.element_size()
                   + sum(w.numel() * w.element_size() for w in ws)) \
            / chip.HBM_BYTES_PER_S * 1e3
        by = "operations" if bound > t_bytes else "bytes"
        floor_ms = 4 * x.numel() * x.element_size() * nb \
            / chip.HBM_BYTES_PER_S * 1e3
        bound_share[by] += bound
        log(f"  K1 {str(dtype)[6:]} N={BATCH} {H}x{W} C={C} P={P} nb={nb}: "
            f"max|err| {max_err:.3e} mean|err| {mean_err:.3e} "
            f"(|ref|max {scale:.3e}) kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms bound {bound:.3f} ms "
            f"({by}) unfused "
            f"floor {floor_ms:.3f} ms cuDNN chain {cudnn_ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)")
        if not ok:
            raise AssertionError(f"K1 {dtype} {H}x{W}: kernel disagrees "
                                 "with the plain version")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        tot["floor_ms"] += floor_ms
        tot["cudnn_ms"] += cudnn_ms
        tot["max_abs_err"] = max(tot["max_abs_err"], max_err)
        del x, ws, got, ref
    # the summed bound is labelled by the side that bounds most of it
    tot["bound_by"] = max(bound_share, key=bound_share.get)
    log(f"K1 {str(dtype)[6:]} over the four stages: kernel "
        f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']}), unfused floor {tot['floor_ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms")
    if f32:
        log(f"K1 f32 (3xTF32, a k-step's products promoted to an f32 "
            f"sum, each part's last bit set; 55.194 ms without the last "
            f"bit on an H100 80GB HBM3 at 700 W): max|err|/max from the "
            f"f64 chain {tot['f64_err']:.3e}, its plain version's "
            f"{tot['plain_f64_err']:.3e} (2.4e-7 without the last bit); "
            f"bound {tot['bound_ms']:.3f} ms (3F / 495 TFLOP/s)")
        tot.update(cancelling_check())
    log(f"K1 yardstick (not used by the port): the cuDNN chain, "
        f"{str(dtype)[6:]}, channels-last, 3*nb F.conv2d with eager "
        f"epilogues: {tot['cudnn_ms']:.3f} ms")
    return tot


def cancelling_check():
    """ROADMAP C1: K1's f32 chain on the cancelling operands of
    tests/test_torch_cuda.py (R50's last stage, sums that cancel to a few
    percent), max|err| / max from the chain in f64, at most twice that of
    cuDNN's f32 chain (K1's plain version, TF32 off)."""
    import numpy as np
    import torch
    from tests.test_torch_cuda import _chain_f64, cancelling_chain_operands
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference, fused_bottleneck_chain)
    x, ws = cancelling_chain_operands("cuda", np.random.default_rng(8111))
    exact = _chain_f64(x, ws)
    scale = exact.abs().max().item()
    e_k1 = (fused_bottleneck_chain(x, *ws).double() - exact).abs().max() \
        .item() / scale
    e_plain = (bottleneck_chain_reference(x, *ws).double() - exact).abs() \
        .max().item() / scale
    log(f"K1 f32 on cancelling sums (C1), max|err|/max from f64: K1 "
        f"{e_k1:.3e}, cuDNN f32 {e_plain:.3e}, ratio {e_k1 / e_plain:.2f} "
        f"(bar 2; without the last bit: 6.2)")
    if e_k1 > 2 * e_plain:
        raise AssertionError(f"K1 f32 is {e_k1 / e_plain:.2f}x cuDNN's f32 "
                             f"distance from f64 on cancelling sums")
    return {"cancel_err": e_k1, "cancel_plain_err": e_plain}


def planted_heatmaps(gen):
    """(512, 17, 64, 48) f32 maps: noise, plus every 4th sample all
    negative, every 4th quantized to few levels (many argmax and peak
    ties), every 4th with a planted tie of the max (joints 0-5), a max in
    the corner (6-11) or on the bottom border (12-16)."""
    import torch
    N, K, H, W = HM_SHAPE
    hms = torch.randn(HM_SHAPE, generator=gen, device="cuda") * 0.4 + 0.1
    hms[1::4] = -hms[1::4].abs() - 1e-3
    hms[2::4] = torch.round(hms[2::4] * 4) / 4
    tie = hms[3::4]
    peak = tie.amax(dim=(-2, -1)) + 1.0                 # (n, K)
    flat = tie.view(tie.shape[0], K, H * W)
    flat[:, :, 200] = peak
    flat[:, :, 1000] = peak                             # tie: 200 wins
    flat[:, 6:12, 0] = peak[:, 6:12] + 1.0
    flat[:, 12:, H * W - 1 - W // 2] = peak[:, 12:] + 1.0
    return hms


def phase_postprocess_kernel(gen):
    """K2 at (512, 17, 64, 48).  coords and maxvals must be bit-exact; gc
    is a float sum in another order: rtol 1e-5.  `ms` is the kernel's own
    device time (the raw ctypes launch into preallocated outputs, 20 back
    to back between two events); the wrapper's time, with its output
    allocation, is logged beside it."""
    import torch
    from vatl4pose_tpu_torch.kernels import _build
    from vatl4pose_tpu_torch.kernels.postprocess import (
        fused_postprocess, postprocess_reference)
    hms = planted_heatmaps(gen)
    c, m, g = fused_postprocess(hms)
    rc, rm, rg = postprocess_reference(hms)
    torch.cuda.synchronize()
    exact = torch.equal(c, rc) and torch.equal(m, rm)
    gc_err = ((g - rg).abs() / rg.abs().clamp(min=1e-30)).max().item()
    max_err = max((c - rc).abs().max().item(), (m - rm).abs().max().item(),
                  (g - rg).abs().max().item())
    N, K, H, W = hms.shape
    lib = _build.load("postprocess")
    outs = [torch.empty(s, dtype=torch.float32, device="cuda")
            for s in ((N, K, 2), (N, K), (N,))]
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        _build.check(lib.heatmap_postprocess_f32(
            hms.data_ptr(), *(o.data_ptr() for o in outs), N, K, H, W,
            stream), "heatmap_postprocess_f32")

    ms = cuda_ms(raw, reps=10, inner=20)
    wrapper_ms = cuda_ms(lambda: fused_postprocess(hms), reps=10, inner=20)
    plain_ms = cuda_ms(lambda: postprocess_reference(hms), reps=10)
    bound = bounds.k2_bound_s(N, K, H, W) * 1e3
    log(f"  K2 {tuple(hms.shape)}: coords/maxvals exact {exact}, gc max "
        f"rel err {gc_err:.3e}, kernel {ms:.4f} ms (wrapper "
        f"{wrapper_ms:.4f} ms) plain {plain_ms:.4f} ms bound "
        f"{bound:.4f} ms")
    if not exact or gc_err > 1e-5:
        raise AssertionError("K2 disagrees with the plain version")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "max_abs_err": max_err}


def crop_batches(video, seed):
    """Two K3 batches of RETRAIN.BATCH_SIZE crops from the video's frames,
    their dst->src matrices drawn by train_sample_geometry: "train" with
    the retrain config's augmentation (rotation with p=0.6, N(0, 40 deg)
    clipped to +-80 deg, scale 0.3); "flips+edges" with flips on (p=0.5)
    and every 4th box moved half past the left and every 4th + 2 half past
    the bottom frame edge."""
    import numpy as np
    from vatl4pose_tpu_torch.data import AugCfg, train_sample_geometry
    d = video.data
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(d), RETRAIN["BATCH_SIZE"], replace=False)
    fi = d.frame_idx[sel].astype(np.int64)
    geo = dict(joints_xy=d.joints_xy[sel], joints_vis=d.joints_vis[sel],
               img_wh=(d.width, d.height), input_size=INPUT_SIZE,
               joint_pairs=video.joint_pairs, rng=rng)
    train, _, _, _, _ = train_sample_geometry(d.bboxes[sel],
                                              aug=AugCfg(**AUG), **geo)
    bb = d.bboxes[sel].copy()
    half_w = (bb[:, 2] - bb[:, 0]) / 2
    half_h = (bb[:, 3] - bb[:, 1]) / 2
    bb[0::4, 0::2] -= (bb[0::4, 0] + half_w[0::4])[:, None]
    bb[2::4, 1::2] += (d.height - bb[2::4, 1] - half_h[2::4])[:, None]
    edges, flips, _, _, _ = train_sample_geometry(
        bb, aug=AugCfg(**dict(AUG, flip=True)), **geo)
    rotated = np.mean(np.abs(train[:, 0, 1]) > 1e-6)
    outside = outside_share(edges, d.width, d.height)
    log(f"  K3 batches: {rotated:.2f} of 'train' rotated; 'flips+edges' "
        f"{flips.mean():.2f} flipped, {outside:.2f} reaching outside the "
        "frame")
    if rotated < 0.3 or flips.mean() < 0.25 or outside < 0.25:
        raise AssertionError("K3 batches miss rotations, flips or edges")
    return {"train": (fi, train), "flips+edges": (fi, edges)}


def outside_share(mats, width, height):
    """Share of crops whose corners map outside the frame."""
    import numpy as np
    oh, ow = INPUT_SIZE
    corners = np.array([[0, 0, 1], [ow - 1, 0, 1], [0, oh - 1, 1],
                        [ow - 1, oh - 1, 1]], np.float64)
    src = np.einsum("nij,cj->nci", mats.astype(np.float64), corners)
    out = (src[..., 0] < 0) | (src[..., 0] > width - 1) \
        | (src[..., 1] < 0) | (src[..., 1] > height - 1)
    return float(out.any(axis=1).mean())


def grid_sample_theta(mats, width, height):
    """dst->src pixel affines as affine_grid's thetas (align_corners=True:
    -1 and +1 are the centres of the first and last pixels)."""
    import numpy as np
    oh, ow = INPUT_SIZE
    to_pix = np.array([[(ow - 1) / 2, 0, (ow - 1) / 2],
                       [0, (oh - 1) / 2, (oh - 1) / 2], [0, 0, 1]])
    to_unit = np.array([[2 / (width - 1), 0, -1], [0, 2 / (height - 1), -1]])
    return (to_unit @ np.concatenate(
        [mats.astype(np.float64),
         np.broadcast_to([[[0, 0, 1]]], (len(mats), 1, 3))], 1)
        @ to_pix).astype(np.float32)


def check_crop(label, args, dtype):
    """K3 against its plain version: f32 within 1e-3/255 (in practice
    equal: the kernel repeats the plain version's operations and its
    division by 255), bf16 bit for bit (the f32 crop rounded once)."""
    import torch
    from vatl4pose_tpu_torch.kernels import (rot_warp_crop,
                                             rot_warp_crop_reference)
    got = rot_warp_crop(*args, dtype=dtype)
    ref = rot_warp_crop_reference(*args, dtype=dtype)
    err = (got.float() - ref.float()).abs().max().item()
    exact = torch.equal(got, ref)
    log(f"  K3 {label} {str(dtype)[6:]} {tuple(got.shape)}: max|err| "
        f"{err:.3e}, bit-exact {exact} (f32 tolerance {1e-3 / 255:.3e}, "
        "bf16 bit-exact)")
    ok = exact if dtype == torch.bfloat16 else err <= 1e-3 / 255
    if not ok or not got.float().isfinite().all():
        raise AssertionError(f"K3 {label} {dtype} disagrees with the plain "
                             "version")
    return err


def raw_crop(variant, args, dtype):
    """A K3 entry point launched through ctypes into a preallocated output,
    so that CUDA events time the kernel and not the wrapper's host work."""
    import torch
    from vatl4pose_tpu_torch.kernels import _build
    from vatl4pose_tpu_torch.kernels.rot_warp import _INV_255
    from vatl4pose_tpu_torch.ops import RGB_MEAN
    frames, fi, mats, (oh, ow) = args
    F_, H, W, _ = frames.shape
    src = {torch.uint8: "u8", torch.float32: "f32"}[frames.dtype]
    entry = f"{variant}_{src}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    fn = getattr(_build.load("rot_warp"), entry)
    out = torch.empty((fi.shape[0], oh, ow, 3), dtype=dtype,
                      device=frames.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(fn(frames.data_ptr(), fi.data_ptr(), mats.data_ptr(),
                        out.data_ptr(), F_, H, W, fi.shape[0], oh, ow,
                        _INV_255, *(float(m) for m in RGB_MEAN), stream),
                     entry)
    return launch


def time_crop(label, args, dtype, library=True):
    """K3's own device time (raw launches, 20 back to back between two
    events) and its wrapper's, its copy variant (one tap, no
    interpolation, the same stores), its plain version and, as the library
    yardstick, affine_grid + grid_sample (bilinear, zeros, align_corners;
    f32, on frames gathered and cast beforehand, untimed), with K3's bound
    on these inputs."""
    import torch
    import torch.nn.functional as F
    from vatl4pose_tpu_torch.kernels import (rot_warp_crop,
                                             rot_warp_crop_reference)
    from vatl4pose_tpu_torch.ops import warp_affine_bilinear_batch
    frames, fi, mats, out_size = args
    N = fi.shape[0]
    oh, ow = out_size
    res = {"ms": cuda_ms(raw_crop("rot_warp", args, dtype), reps=10,
                         inner=20),
           "wrapper_ms": cuda_ms(lambda: rot_warp_crop(*args, dtype=dtype),
                                 reps=10, inner=20),
           "copy_ms": cuda_ms(raw_crop("rot_warp_copy", args, dtype),
                              reps=10, inner=20),
           "plain_ms": cuda_ms(lambda: rot_warp_crop_reference(
               *args, dtype=dtype), reps=3, warm=1)}
    src_bytes = bounds.k3_source_bytes(frames, fi, mats, out_size)
    itemsize = torch.finfo(dtype).bits // 8
    res["bound_ms"] = bounds.k3_bound_s(N, out_size, src_bytes,
                                        itemsize) * 1e3
    # each output value's 2 or 4 bytes outweigh its 20 flops at the peaks
    res["bound_by"] = "bytes"
    res["library_ms"] = None
    if library:
        src = frames[fi].permute(0, 3, 1, 2).float().contiguous()
        theta = torch.as_tensor(grid_sample_theta(
            mats.cpu().numpy(), frames.shape[2], frames.shape[1]),
            device=frames.device)

        def lib_call():
            grid = F.affine_grid(theta, (N, 3, oh, ow), align_corners=True)
            return F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

        lib_err = (lib_call().permute(0, 2, 3, 1)
                   - warp_affine_bilinear_batch(*args)).abs()
        log(f"  K3 {label} yardstick grid_sample vs plain on [0, 255]: "
            f"max|err| {lib_err.max().item():.3e} mean "
            f"{lib_err.mean().item():.3e}")
        if not lib_err.mean().item() < 1e-2:
            raise AssertionError("grid_sample's thetas do not give K3's crop")
        del lib_err
        res["library_ms"] = cuda_ms(lib_call, reps=10, inner=5)
        del src
    # the bound as PRs 2-3 counted it: one source byte an output value
    res["bound_pr3_ms"] = N * oh * ow * 3 * (itemsize + 1) \
        / chip.HBM_BYTES_PER_S * 1e3
    log(f"  K3 {label} {str(dtype)[6:]} N={N} {oh}x{ow}: kernel "
        f"{res['ms']:.4f} ms (wrapper {res['wrapper_ms']:.4f} ms), copy "
        f"variant {res['copy_ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, grid_sample {res['library_ms']} ms; "
        f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"{src_bytes / 1e6:.2f} MB of source tapped; share "
        f"{res['bound_ms'] / res['ms']:.3f}); one source byte a value: "
        f"{res['bound_pr3_ms']:.4f} ms")
    return res


def old_scoring_crop(frames, fi, mats, dtype):
    """The scoring crop before K3 took it: the separable form (the frames
    gathered per sample, two batched einsums) normalized in `dtype`."""
    import torch
    from vatl4pose_tpu_torch.ops import RGB_MEAN, warp_axis_aligned_batch
    crops = warp_axis_aligned_batch(frames, fi, mats, INPUT_SIZE,
                                    dtype=dtype)
    return crops / 255.0 - torch.as_tensor(RGB_MEAN,
                                           device=frames.device).to(dtype)


def phase_rot_warp_kernel(video, seed):
    """K3 at the main paths' shapes, from the video's 640x360 uint8 frames:
    the retrain batch (120 crops of 256x192 with the config's rotations,
    and with flips and edges) in f32; the scoring chunk (512 crops, rot=0
    matrices from the video's boxes) in f32 and bf16, with the crop it
    replaced (the einsum form) timed and profiled beside it; and the
    float32-frame instances on the same inputs."""
    import torch
    from vatl4pose_tpu_torch.kernels import rot_warp_crop
    from vatl4pose_tpu_torch.ops import crop_geometry
    frames = video.frames_dev
    dev = frames.device
    frames_f32 = frames.float()
    max_err = {}
    batches = {name: (frames, torch.as_tensor(fi, device=dev),
                      torch.as_tensor(mats, device=dev), INPUT_SIZE)
               for name, (fi, mats) in crop_batches(video, seed).items()}
    d = video.data
    mats, _ = crop_geometry(d.bboxes[:BATCH], INPUT_SIZE, device=dev)
    scoring = (frames, torch.as_tensor(d.frame_idx[:BATCH], dtype=torch.int64,
                                       device=dev), mats, INPUT_SIZE)
    batches["scoring"] = scoring
    log(f"  K3 scoring chunk: {outside_share(mats.cpu().numpy(), d.width, d.height):.2f}"
        " of the crops reach outside the frame")
    for name, args in batches.items():
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for src, a in (("u8", args), ("f32", (frames_f32,) + args[1:])):
                key = f"{src}_{tag}"
                err = check_crop(f"'{name}' from {src} frames", a, dtype)
                max_err[key] = max(max_err.get(key, 0.0), err)
    res = {"retrain_f32": time_crop("retrain", batches["train"],
                                    torch.float32),
           "scoring_f32": time_crop("scoring", scoring, torch.float32),
           "scoring_bf16": time_crop("scoring", scoring, torch.bfloat16,
                                     library=False)}
    res["scoring_bf16"]["library_ms"] = res["scoring_f32"]["library_ms"]
    f32_args = (frames_f32,) + scoring[1:]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        r = res[f"scoring_{tag}"]
        r["from_f32_frames_ms"] = cuda_ms(
            lambda: rot_warp_crop(*f32_args, dtype=dtype), reps=10, inner=20)
        r["old_crop_ms"] = cuda_ms(
            lambda: old_scoring_crop(*scoring[:3], dtype), reps=5)
        log(f"  K3 scoring {tag}: from float32 frames "
            f"{r['from_f32_frames_ms']:.4f} ms; the crop it replaced (gather "
            f"+ two einsums + normalize) {r['old_crop_ms']:.4f} ms")
        profile_call(lambda: old_scoring_crop(*scoring[:3], dtype),
                     f"replaced scoring crop {tag}", top=8)
        r["max_abs_err"] = max_err[f"u8_{tag}"]
    res["retrain_f32"]["max_abs_err"] = max_err["u8_f32"]
    res["max_abs_err"] = max_err
    del frames_f32
    torch.cuda.empty_cache()
    return res


def randomize_(model, gen):
    """Seeded random weights, BN running stats included, so the fold
    matters; He-scaled convs and small gains on the BNs whose outputs are
    summed (a bottleneck's bn3 and shortcut; HRNet's branch blocks' bn2
    and its fusion layers) keep activations O(1)."""
    import torch
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                if isinstance(m, torch.nn.ConvTranspose2d):
                    fan_in = m.weight.shape[0] * 4
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.05)
            elif isinstance(m, torch.nn.BatchNorm2d):
                summed = name.endswith(("bn3", "downsample.1")) or (
                    ".branches." in name and name.endswith("bn2")) \
                    or ".fuse_layers." in name
                lo, hi = (0.1, 0.3) if summed else (0.5, 1.0)
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model


def write_video(out_dir, seed):
    """VIDEO's synthetic video written under out_dir: the files that the
    AL CLI's --synthetic --synth_seed <seed> with VIDEO's sizes writes
    (tests/test_torch_library_tail.py holds them equal).  Returns (root,
    ann)."""
    from vatl4pose_tpu_torch.data import make_synthetic_video
    return make_synthetic_video(out_dir, seed=seed, **VIDEO)


def make_video(seed):
    """The main paths' input: a synthetic video of 64 frames x 8 persons
    at 640x360 (512 samples), decoded to (F, H, W, 3) uint8 frames, which
    stay on the card across passes as an AL loop keeps them across rounds;
    with its VideoPoseData, joint pairs, the score() arguments, and its
    files (root, ann) in a directory that lives as long as the namespace
    (`tmpdir`).  The AL loops of phases 5, 6, 9, 10, 12 and 13 read these
    files (`on_video_files`) instead of making the video again."""
    import types
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.data import build_dataset
    tmpdir = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    root, ann = write_video(tmpdir.name, seed)
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
    frames = ds.load_frames()
    log(f"synthetic video: {len(ds)} samples, {frames.shape[0]} frames "
        f"{frames.shape[2]}x{frames.shape[1]}, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    d = ds.data
    if len(d) < BATCH:
        raise AssertionError(f"the video has {len(d)} samples, fewer than "
                             f"one full chunk of {BATCH}")
    frames_dev = torch.from_numpy(frames).cuda()
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    return types.SimpleNamespace(
        frames=frames, frames_dev=frames_dev, data=d,
        joint_pairs=ds.joint_pairs, tmpdir=tmpdir, root=root, ann=ann,
        args=(frames_dev, d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann,
              d.is_prev, d.is_next))


def make_models(seed):
    """SimplePose-R50 at full width (deconv 256x3, 17 joints, fused_eval)
    and a WholeBodyAE (z=4, 38 inputs), seeded random weights, on the
    CPU."""
    import torch
    from vatl4pose_tpu_torch.models import SimplePose, WholeBodyAE
    gen = torch.Generator().manual_seed(seed)
    model = randomize_(SimplePose(**MODEL, fused_eval=True, device="cpu"),
                       gen)
    ae = randomize_(WholeBodyAE(z_dim=4, input_dim=38, device="cpu"), gen)
    return model, ae


def phase_main_path(video, seed):
    """The scoring path in f32 and bf16.  Returns the launch counts, the
    warm samples/s, the models (on the card) and the f32 heatmaps."""
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts

    args = video.args
    frame_idx, bboxes = args[1], args[2]
    n = len(frame_idx)
    model, ae = make_models(seed)
    model_cpu, ae_cpu = copy.deepcopy(model), copy.deepcopy(ae)
    model.cuda()
    ae.cuda()

    counts, rates, results = {}, {}, {}
    for mode in ("f32", "bf16"):
        cfg = ScoringConfig(uncertainty="THC+WPU", bf16=mode == "bf16")
        engine = ScoringEngine(model, cfg, ae_model=ae, chunk=BATCH)
        reset_launch_counts()
        res = engine.score(*args)
        torch.cuda.synchronize()
        counts[mode] = {k.__name__: k.launches for k in KERNELS}
        log(f"main path {mode}: launches {counts[mode]}")
        check_scoring_launches(counts[mode], mode)
        check_outputs(res, n)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.score(*args, keep_heatmaps=False)
            times.append(time.perf_counter() - t0)
        rates[mode] = n / statistics.median(times)
        log(f"main path {mode}: warm scoring {rates[mode]:.1f} samples/s "
            f"({n} samples, median of 3: {statistics.median(times):.3f} s)")
        if profile_call(lambda: engine.score(*args, keep_heatmaps=False),
                        f"scoring pass {mode}"):
            raise AssertionError(f"{mode}: the scoring pass ran an einsum "
                                 "(the crop K3 replaced)")
        results[mode] = res

    # the same port on the CPU, first 32 samples, f32 (plain versions)
    ref = ScoringEngine(model_cpu, ScoringConfig(uncertainty="THC+WPU"),
                        ae_model=ae_cpu, chunk=32, device="cpu")
    hm_cpu, emb_cpu, _, _ = ref.forward_video(video.frames, frame_idx[:32],
                                           bboxes[:32])
    # f32: TF32 off, so the GPU and CPU differ by summation order only;
    # bf16 rounds every layer's input to 8 mantissa bits over ~60 layers
    for mode, tol in (("f32", 1e-3), ("bf16", 0.25)):
        hm = results[mode]["heatmaps"][:32].float().cpu()
        emb = torch.as_tensor(results[mode]["embeddings"][:32])
        e_hm = ((hm - hm_cpu).abs().max() / hm_cpu.abs().max()).item()
        e_emb = ((emb - emb_cpu).abs().max() / emb_cpu.abs().max()).item()
        log(f"main path {mode} vs CPU (32 samples): heatmaps max|err|/max "
            f"{e_hm:.3e}, embeddings {e_emb:.3e} (tolerance {tol})")
        if e_hm > tol or e_emb > tol:
            raise AssertionError(f"{mode}: GPU run disagrees with the CPU")
    return counts, rates, model, ae, results["f32"]["heatmaps"]


def check_scoring_launches(counts, what):
    if counts["fused_bottleneck_chain"] == 0 \
            or counts["fused_postprocess"] == 0 \
            or counts["rot_warp_crop"] == 0:
        raise AssertionError(f"{what}: a kernel of the path never ran")


def profile_call(fn, label, top=12, show=("rot_warp", "heatmap_postprocess")):
    """fn() once more under torch.profiler: device time by kernel (the top
    rows, and any row naming one of `show`) and the count of aten::einsum
    calls, which it returns.  The card's idle share is the benchmark's
    (benchmark/trace.py: the union of the device's intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    einsums = sum(e.count for e in events if e.key == "aten::einsum")
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not dev:
        log(f"profile {label}: the profiler recorded no device time "
            f"(breakdown not measured); aten::einsum calls {einsums}")
        return einsums
    total = sum(t for _, t, _ in dev)
    log(f"profile {label}: device time summed by kernel {total:.1f} ms, "
        f"aten::einsum calls {einsums}")
    rows = sorted(dev, key=lambda r: -r[1])
    for i, (key, t, count) in enumerate(rows):
        if i < top or any(k in key for k in show):
            log(f"  {t:9.3f} ms {100 * t / total:5.1f}% x{count:<4d} "
                f"{key[:110]}")
    return einsums


def make_retrainer(model, video, device=None, seed=166,
                   model_type="SimplePose", mesh=None):
    from vatl4pose_tpu_torch.data import AugCfg
    from vatl4pose_tpu_torch.train import Retrainer
    return Retrainer(model, RETRAIN, model_type, input_size=INPUT_SIZE,
                     hm_size=HM_SIZE, sigma=2.0, aug=AugCfg(**AUG),
                     joint_pairs=video.joint_pairs, seed=seed, mesh=mesh,
                     device=device)


def train_batch(video, n, rng):
    """One batch of n samples' step operands, drawn as the retrainer draws
    them: (frame_idx, inv_mats, joints, vis, valid)."""
    import numpy as np
    from vatl4pose_tpu_torch.data import AugCfg, train_sample_geometry
    d = video.data
    sel = rng.choice(len(d), n, replace=False)
    mats, _, joints, vis, _ = train_sample_geometry(
        d.bboxes[sel], d.joints_xy[sel], d.joints_vis[sel],
        (d.width, d.height), INPUT_SIZE, AugCfg(**AUG), video.joint_pairs,
        rng)
    return (d.frame_idx[sel].astype(np.int64), mats, joints, vis,
            np.ones(n, bool))


def phase_step_check(video, seed, n=8, model_cfg=None):
    """One train step on n samples from the same weights on the card (f32,
    TF32 off), with the same port on the CPU in f32, and on the CPU in f64
    as the exact step.  Tolerances: loss relative 1e-4 between card and
    CPU.  A gradient tensor passes at a relative Frobenius error <= 1e-3
    between card and CPU, or where the card's f32 gradient is no further
    from the f64 one than twice the CPU's f32 gradient is: behind a ReLU a
    forward difference of relative size e flips about 0.4e of the gates,
    which moves the gradient by about sqrt(0.4e), so two f32 runs that
    differ by 1e-5 in the forward differ by about 2e-3 in the gradient.
    After the AdamW step: all parameter elements within 2 lr mult (plus
    one ulp) of the CPU's (AdamW's first step is lr mult sign(g), so a
    sign flip of a tiny gradient moves an element by up to that), and >=
    99.5% within 1e-6 + 1e-4|p| of the CPU's, or no fewer within it of the
    f64 step than the CPU's f32 step has, less 0.5%.  The model is phase
    3's SimplePose-R50, or the estimator of `model_cfg` (a MODEL section)
    with the same seeded random weights."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.train import LR_GROUPS
    model_type = "SimplePose" if model_cfg is None else model_cfg["TYPE"]
    model_cpu = make_models(seed + 1)[0] if model_cfg is None \
        else make_zoo_model(model_cfg, seed + 1)[0]
    runs = (("cpu", copy.deepcopy(model_cpu).double(),
             torch.from_numpy(video.frames)),
            ("cpu", model_cpu, torch.from_numpy(video.frames)),
            ("cuda", copy.deepcopy(model_cpu).cuda(), video.frames_dev))
    batch = train_batch(video, n, np.random.default_rng(seed + 1))
    loss, grads, params = {}, {}, {}
    for dev, model, frames in runs:
        key = "f64" if next(model.parameters()).dtype == torch.float64 \
            else dev
        tr = make_retrainer(model.train(), video, device=dev,
                            model_type=model_type)
        t0 = time.perf_counter()
        loss[key] = tr.train_step(frames, *batch)[0].item()
        log(f"  step {key}: {time.perf_counter() - t0:.2f} s")
        grads[key] = {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()}
        params[key] = {k: p.detach().double().cpu()
                       for k, p in model.named_parameters()}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    failed, worst = [], {"card-CPU": 0.0, "card-f64": 0.0, "CPU-f64": 0.0,
                         "ratio": 0.0}
    for k, g in grads["cpu"].items():
        e_gc = rel(grads["cuda"][k], g)
        e_g, e_c = (rel(grads[d][k], grads["f64"][k]) for d in ("cuda", "cpu"))
        for name, e in (("card-CPU", e_gc), ("card-f64", e_g),
                        ("CPU-f64", e_c),
                        ("ratio", e_g / max(1e-3, 2 * e_c))):
            worst[name] = max(worst[name], e)
        if e_gc > 1e-3 and e_g > max(1e-3, 2 * e_c):
            failed.append((k, e_gc, e_g, e_c))
    close = {"cuda-cpu": 0, "cuda-f64": 0, "cpu-f64": 0}
    total, worst_p = 0, 0.0
    for k, p in params["cpu"].items():
        for pair in close:
            a, b = (params[d][k] for d in pair.split("-"))
            ok = (a - b).abs() <= 1e-6 + 1e-4 * b.abs()
            close[pair] += ok.sum().item()
        total += p.numel()
        lr_mult = RETRAIN["LR"] * LR_GROUPS[model_type](k.split(".")[0])
        d = (params["cuda"][k] - p).abs()
        worst_p = max(worst_p, (d / (2 * lr_mult + 2 * 1.2e-7 * p.abs()))
                      .max().item())
    share = {pair: c / total for pair, c in close.items()}
    params_ok = worst_p <= 1.0 and (
        share["cuda-cpu"] >= 0.995
        or share["cuda-f64"] >= share["cpu-f64"] - 0.005)
    log(f"  GPU vs CPU step ({model_type}, {n} samples): loss {loss['cuda']:.7e} vs "
        f"{loss['cpu']:.7e} (f64 {loss['f64']:.7e}), rel err "
        f"{loss_err:.3e} (tolerance 1e-4)")
    log(f"  gradients, max rel Frobenius err over tensors: card-CPU "
        f"{worst['card-CPU']:.3e}, card-f64 {worst['card-f64']:.3e}, "
        f"CPU-f64 {worst['CPU-f64']:.3e}; max of card-f64 / max(1e-3, "
        f"2 CPU-f64) {worst['ratio']:.3f} (<= 1 where card-CPU > 1e-3); "
        f"{len(failed)} tensors fail both")
    for k, e_gc, e_g, e_c in failed[:10]:
        log(f"    {k}: card-CPU {e_gc:.3e} card-f64 {e_g:.3e} "
            f"CPU-f64 {e_c:.3e}")
    log(f"  parameters after AdamW, share within 1e-6 + 1e-4|p|: "
        + ", ".join(f"{k} {v:.5f}" for k, v in share.items())
        + f"; max |card - CPU| / (2 lr mult) {worst_p:.4f} (<= 1)")
    if not (loss_err <= 1e-4 and not failed and params_ok):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")


def phase_retrain(video, model, ae, hm_before, seed):
    """The AL round's retrain of the phase-3 model: RETRAIN_EPOCHS epochs
    over every sample, one retrain() call per epoch (the optimizer state
    and the LR schedule carry over, as in one call); the counters are reset
    before the first and read after the last.  Then one step profiled on a
    copy, the AE fine-tune and the f32 rescoring."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import (KERNELS, reset_launch_counts,
                                             rot_warp_crop)
    from vatl4pose_tpu_torch.ops import compute_hybrid
    from vatl4pose_tpu_torch.train import AETrainer
    d = video.data
    n = len(d)
    idx = np.arange(n)
    steps_per_epoch = -(-n // RETRAIN["BATCH_SIZE"])
    tr = make_retrainer(model, video)
    walls, curve = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for epoch in range(RETRAIN_EPOCHS):
        t0 = time.perf_counter()
        loss, acc = tr.retrain(d, video.frames_dev, idx, 1,
                               (d.width, d.height))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        curve.append((loss, acc))
        log(f"retrain epoch {epoch + 1}: loss {loss:.7f} acc {acc:.4f}, "
            f"{steps_per_epoch} steps in {walls[-1]:.3f} s")
    counts = {k.__name__: k.launches for k in KERNELS}
    steps = RETRAIN_EPOCHS * steps_per_epoch
    log(f"retrain: launches {counts}, optimizer steps {steps}")
    if rot_warp_crop.launches != steps:
        raise AssertionError(f"K3 ran {rot_warp_crop.launches} times in "
                             f"{steps} steps")
    if not np.isfinite(curve).all():
        raise AssertionError("retrain loss or accuracy is not finite")
    warm = statistics.median(walls[1:])
    rate = {"ms_per_step": warm / steps_per_epoch * 1e3,
            "samples_per_s": n / warm, "steps": steps}
    log(f"retrain warm (median of epochs 2-{RETRAIN_EPOCHS}): "
        f"{rate['ms_per_step']:.1f} ms/step, {rate['samples_per_s']:.1f} "
        f"samples/s (batch {RETRAIN['BATCH_SIZE']}, {n} samples an epoch)")

    # one step on a copy, so that the retrained model takes no extra step
    twin = make_retrainer(copy.deepcopy(model), video, seed=seed)
    batch = train_batch(video, RETRAIN["BATCH_SIZE"],
                        np.random.default_rng(seed))
    twin.model.train()
    for _ in range(2):
        twin.train_step(video.frames_dev, *batch)
    profile_call(lambda: twin.train_step(video.frames_dev, *batch),
                 "retrain step")
    del twin
    torch.cuda.empty_cache()

    feats = compute_hybrid(torch.from_numpy(d.raw_bbox_xywh),
                           torch.from_numpy(d.gt_keypoints)).numpy()
    before = [p.detach().clone() for p in ae.parameters()]
    t0 = time.perf_counter()
    AETrainer(lr=AE_LR, epochs=AE_EPOCHS, batch_size=10).train(ae, feats[idx])
    torch.cuda.synchronize()
    ae_s = time.perf_counter() - t0
    moved = [(p - b).abs().max().item() for p, b in zip(ae.parameters(),
                                                        before)]
    log(f"AE fine-tune: {AE_EPOCHS} epochs over {len(idx)} features, "
        f"{ae_s:.2f} s; max parameter change {max(moved):.3e}")
    if not (np.isfinite(moved).all() and max(moved) > 0):
        raise AssertionError("the AE fine-tune left the weights unchanged "
                             "or not finite")

    engine = ScoringEngine(model, ScoringConfig(uncertainty="THC+WPU"),
                           ae_model=ae, chunk=BATCH)
    reset_launch_counts()
    res = engine.score(*video.args)
    torch.cuda.synchronize()
    rescore = {k.__name__: k.launches for k in KERNELS}
    check_scoring_launches(rescore, "rescoring")
    check_outputs(res, n)
    change = (res["heatmaps"] - hm_before).abs().max().item()
    log(f"rescoring f32 on the retrained weights: launches {rescore}, "
        f"heatmaps max |change| {change:.3e}")
    if not change > 0:
        raise AssertionError("rescoring did not see the retrained weights")
    rate["k3_launches"] = counts["rot_warp_crop"]
    return rate


class CallLog:
    """Counts the calls of the AL loop's entry points (a scoring pass,
    resident or streamed; an optimizer step, on device crops or host
    crops) and keeps round 0's coreset arguments, the scoring engine, the
    ActiveLearning instance, each host warp's size and wall time and each
    round's filter (candidates, clamped query size, query, wall time), by
    wrapping the functions for the duration of the loop."""

    def __init__(self):
        self.score_calls = self.train_steps = 0
        self.coreset_args = None
        self.engine = self.al = None
        self.host_warps = []          # (crops, seconds)
        self.filters = []
        self._undo = []

    def wrap(self, owner, name, before, timed=None):
        orig = getattr(owner, name)

        def wrapper(*a, **kw):
            before(*a, **kw)
            if timed is None:
                return orig(*a, **kw)
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            timed(out, time.perf_counter() - t0)
            return out
        setattr(owner, name, wrapper)
        self._undo.append((owner, name, orig))

    def __enter__(self):
        from vatl4pose_tpu_torch.al import active_learning, scoring
        from vatl4pose_tpu_torch.data import stream
        from vatl4pose_tpu_torch.train import retrain

        def on_score(engine, *a, **kw):
            self.score_calls += 1
            self.engine = engine

        def on_step(*a, **kw):
            self.train_steps += 1

        def on_coreset(*a, **kw):
            if self.coreset_args is None:
                self.coreset_args = copy.deepcopy((a, kw))

        def on_round(al, *a, **kw):
            self.al = al

        def on_warp(crops, seconds):
            self.host_warps.append((len(crops), seconds))

        pending = []

        def on_filter(al, candidate_list, *a, **kw):
            pending.append((al, list(candidate_list)))

        def filtered(query, seconds):
            al, cands = pending.pop()
            self.filters.append((cands, al.query_size, list(query), seconds))
        self.wrap(scoring.ScoringEngine, "score", on_score)
        self.wrap(scoring.ScoringEngine, "score_streaming", on_score)
        self.wrap(retrain.Retrainer, "train_step", on_step)
        self.wrap(retrain.Retrainer, "train_step_crops", on_step)
        self.wrap(active_learning, "coreset_selection", on_coreset)
        self.wrap(active_learning.ActiveLearning, "eval_and_query", on_round)
        self.wrap(stream, "warp_crops_host", lambda *a, **kw: None, on_warp)
        self.wrap(active_learning.ActiveLearning, "_apply_filter", on_filter,
                  filtered)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)


def coreset_gaps(args, kw, picks, ref):
    """Where the f32 greedy's picks differ from the f64 one's: the f64
    score gap between the two picks at that step, relative to the step's
    top score, with the f64 greedy's state replayed up to it.  The f32
    resolution is 2^-23 (1.2e-7) of a score."""
    import numpy as np
    from vatl4pose_tpu_torch.al.selection import euclidean_distances
    emb, unc, labeled, _, lam, moks = args
    enc = np.asarray(emb, np.float64)
    unc = np.asarray(unc, np.float64).copy()
    md = euclidean_distances(enc, enc[labeled]).min(axis=1) if labeled \
        else None
    gaps = []
    for a, b in zip(picks, ref):
        if md is None:
            sc = unc
        elif kw["mode"] == "dynamic":
            sc = (1.0 - moks) * md + lam * moks * unc
        else:
            sc = md + lam * unc if kw["mode"] == "fixed" else md
        if a != b:
            gaps.append((a, b, abs(sc[b] - sc[a]) / abs(sc).max()))
        d = euclidean_distances(enc, enc[[b]])[:, 0]
        md = d if md is None else np.minimum(md, d)
        unc[b] = 0.0
    return gaps


def fold_check(model, video, n=16, label="AL loop"):
    """A SimplePose's or FastPose's weights (phase 5: the retrained ones)
    on the first n samples' scoring crops, in eval
    mode, four ways: through K1 (and FastPose's DUCs through K5); through
    K1's plain version (the same folded operands, f32 products on cuDNN);
    through the unfused cuDNN graph in f32 (eager DUCs); and, as the exact
    forward, through the unfused graph in f64 on the CPU.  The bars:
      - the fold: K1's plain version against the unfused graph at the
        backbone's output (the chain's output) within K1's f32 bar of
        phase 2, 1e-4 of the max (a stale fold or a stale copy of the
        weights misses it by orders of magnitude: retraining moves the
        heatmaps by O(1));
      - K1's precision (fault C1, repaired by promotion): K1's distance
        from the f64 forward, max|err| / max, at most twice cuDNN's
        unfused f32 distance, at the backbone and at the heatmaps (there
        with K5's, which computes as K1 does).
    K1 against the unfused graph at the heatmaps is printed beside them."""
    import torch
    import vatl4pose_tpu_torch.models.resnet as resnet_mod
    from vatl4pose_tpu_torch.kernels import bottleneck_chain_reference
    from vatl4pose_tpu_torch.models.layers import DUC
    from vatl4pose_tpu_torch.ops import crop_batch
    d = video.data
    crops = crop_batch(video.frames_dev, d.frame_idx[:n], d.bboxes[:n],
                       INPUT_SIZE)[0].permute(0, 3, 1, 2)
    exact = copy.deepcopy(model).double().cpu().eval()
    ducs = [m for m in model.modules() if isinstance(m, DUC)]
    kernel = resnet_mod.fused_bottleneck_chain
    was_training = model.training
    model.eval()
    out = {}
    try:
        with torch.no_grad():
            for key, m, x in (("K1", model, crops),
                              ("K1 plain", model, crops),
                              ("unfused", model, crops),
                              ("f64", exact, crops.double().cpu())):
                m.preact.fused_eval = key.startswith("K1")
                for duc in ducs:
                    duc.fused_eval = key.startswith("K1")
                resnet_mod.fused_bottleneck_chain = \
                    bottleneck_chain_reference if key == "K1 plain" \
                    else kernel
                feat = m.preact(x)
                out[key] = {"backbone": feat.double().cpu(),
                            "heatmaps": m.head(feat).double().cpu()}
    finally:
        resnet_mod.fused_bottleneck_chain = kernel
        model.preact.fused_eval = True
        for duc in ducs:
            duc.fused_eval = True
        model.train(was_training)

    def rel(a, b, what):
        a, b = out[a][what], out[b][what]
        return ((a - b).abs().max() / b.abs().max()).item()
    res = {"fold": rel("K1 plain", "unfused", "backbone"),
           "k1": rel("K1", "unfused", "heatmaps")}
    ok = res["fold"] <= 1e-4
    for what in ("backbone", "heatmaps"):
        d = res[f"{what}_vs_f64"] = {k: rel(k, "f64", what)
                                     for k in ("K1", "K1 plain", "unfused")}
        d["K1 / unfused"] = d["K1"] / d["unfused"]
        ok = ok and d["K1"] <= 2 * d["unfused"]
        log(f"{label}: ({n} samples), {what} max|err| / "
            f"max against the f64 forward: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items()) + " (bar: K1 at most "
            "2x unfused)")
    res["ok"] = ok
    log(f"{label}: the fold (K1's plain version vs unfused, backbone) "
        f"{res['fold']:.3e} (bar 1e-4); K1 vs unfused, heatmaps "
        f"{res['k1']:.3e}: {'ok' if res['ok'] else 'FAILED'}")
    return res


def write_weights(tmp, cfg, model, ae):
    """The estimator as MODEL.PRETRAINED (.pth) and the AE as
    AE.PRETRAINED_ROOT/Hybrid/WholeBodyAE_zdim4.pth, under tmp."""
    import os
    import torch
    cfg.MODEL.PRETRAINED = os.path.join(tmp, f"{cfg.MODEL.TYPE}.pth")
    torch.save(model.state_dict(), cfg.MODEL.PRETRAINED)
    cfg.AE.PRETRAINED_ROOT = os.path.join(tmp, "ae")
    os.makedirs(os.path.join(tmp, "ae", "Hybrid"), exist_ok=True)
    torch.save(ae.state_dict(), os.path.join(
        tmp, "ae", "Hybrid", "WholeBodyAE_zdim4.pth"))


def loop_argv(uncertainty="THC+WPU", representativeness="Influence",
              filter="Coreset",
              cfg="configs/posetrack21/al_simple_posetrack.yaml", extra=()):
    """The AL CLI's arguments of the card loops (continual, seedfix) on
    PoseTrack21's video 000001, which `on_video_files` makes phase 3's
    video: no --synthetic, whose video is phase 3's (tests/
    test_torch_library_tail.py) and took 35-45 s to make again."""
    return ["--cfg", cfg, "--video_id", "000001", "--uncertainty",
            uncertainty, "--representativeness", representativeness,
            "--filter", filter, "--continual", "--seedfix", "--memo",
            "chip_smoke", *extra]


def _posetrack_layout(video, root):
    """Phase 3's video under `root` as the CLI's prepare_dataset_paths
    finds PoseTrack21's video 000001: its validation annotation and, for
    --optimize, its train one (symbolic links; the frames' paths are in
    the annotation, relative to the root)."""
    src = Path(video.root)
    root.mkdir()
    for f in src.iterdir():
        (root / f.name).symlink_to(f)
    for ann in ("val/000001_mpii_test.json",
                "train_val/000001_bonn_train.json"):
        link = root / "activelearning" / ann
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(src / video.ann)


def on_video_files(video, cfg, tmp, label):
    """Phase 3's video files laid out under tmp/data (`_posetrack_layout`)
    and set as both splits' ROOT, so that a loop run with prepare=False
    reads them.  The links go with tmp; phase 3's files, and the
    annotation that KEPT copies, stay."""
    root = Path(tmp) / "data"
    _posetrack_layout(video, root)
    for split in ("EVAL", "TRAIN"):
        cfg.DATASET[split].ROOT = str(root)
    log(f"{label}: on phase 3's video files ({video.root} as PoseTrack21's "
        f"000001); no synthetic video made")


@contextlib.contextmanager
def cli_workdir(cfg, argv, tmp, prepare=True):
    """The CLI's set-up in tmp (parse_args, setup_opt, set_dir, and
    prepare_synthetic when `prepare`); yields (cfg, opt).  Afterwards back
    in the old directory, the parity flags (TF32 off) set again and the
    synthetic video removed."""
    import os
    import torch
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    cwd = os.getcwd()
    opt = cli.parse_args(argv)
    os.chdir(tmp)                          # set_dir writes under ./exp
    try:
        opt = cli.setup_opt(opt)
        opt = cli.set_dir(cfg, opt)
        if prepare:
            cfg = cli.prepare_synthetic(cfg, opt)
        yield cfg, opt
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if prepare:
            shutil.rmtree(cfg.DATASET.EVAL.ROOT, ignore_errors=True)


class KeptRuns:
    """The card loops' outputs, kept for phase 12 after their temporary
    directories go: each kept loop's result.json, final predictions
    (predicted_kpt.json), the GT json the loop evaluated against
    (GT_kpt.json), the dataset's annotation file (it has the track ids),
    what set_dir named the run, and the absolute work dir (which lives as
    long as the loop's phase)."""

    def __init__(self):
        self._tmp = None
        self.loops = {}

    @property
    def root(self):
        if self._tmp is None:
            self._tmp = tempfile.TemporaryDirectory()
        return Path(self._tmp.name)

    def add(self, tag, cfg, opt):
        import os
        d = self.root / "loops" / tag
        d.mkdir(parents=True)
        for name in ("result.json", "predicted_kpt.json", "GT_kpt.json"):
            shutil.copy(os.path.join(opt.work_dir, name), d / name)
        shutil.copy(os.path.join(cfg.DATASET.EVAL.ROOT, cfg.DATASET.EVAL.ANN),
                    d / "annotations.json")
        self.loops[tag] = {"dir": d, "model": cfg.MODEL.TYPE,
                           "strategy": opt.strategy, "video": opt.video_id,
                           "timestamp": os.path.basename(opt.work_dir),
                           "work_dir": os.path.abspath(opt.work_dir)}

    def exp_tree(self, tags):
        """The kept runs' result.json files laid out as the CLI's set_dir
        lays them out, exp/AL_<memo>/<model>/<strategy>/<video>/<timestamp>/,
        under one root, with the phase's tag in the video's place
        (<video>-<tag>), so that no run overwrites another.  Returns the
        root and each tag's (strategy, video)."""
        root, where = self.root / "exp", {}
        for tag in tags:
            k = self.loops[tag]
            video = f"{k['video']}-{tag}"
            run = root / "AL_chip_smoke" / k["model"] / k["strategy"] \
                / video / k["timestamp"]
            run.mkdir(parents=True)
            shutil.copy(k["dir"] / "result.json", run / "result.json")
            where[tag] = (k["strategy"], video)
        return root, where


KEPT = KeptRuns()


def run_cli_loop(cfg, argv, tmp, prepare=True, keep=None):
    """The port's CLI loop (cli_workdir's set-up, do_al, save_result) in
    tmp, with the launch counters reset before do_al and read after it;
    its outputs kept under the tag `keep` (KEPT), if given.  Returns
    (result.json, the cycle_times.jsonl lines, launches, launches by
    dtype, CallLog, loop wall s)."""
    import os
    import torch
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    with cli_workdir(cfg, argv, tmp, prepare) as (cfg, opt):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CallLog() as calls:
            reset_launch_counts()
            result = cli.do_al(cfg, opt)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            counts = {k.__name__: k.launches for k in KERNELS}
            by_dtype = {k.__name__: dict(k.launches_by_dtype)
                        for k in KERNELS if hasattr(k, "launches_by_dtype")}
        loop_s = time.perf_counter() - t0
        rj = json.load(open(cli.save_result(cfg, opt, result)))
        cycles = [json.loads(line) for line in
                  open(os.path.join(opt.work_dir, "cycle_times.jsonl"))]
        if keep:
            KEPT.add(keep, cfg, opt)
    return rj, cycles, counts, by_dtype, calls, loop_s


def loop_report(label, rj, cycles, counts, calls, loop_s, n, rounds, card):
    """Each round's wall and phase split; the checks every loop shares:
    result.json's fields, percentages rising to 100, every sample queried
    once, a cycle_times.jsonl line a cycle.  Returns (phase sums, round
    table, failures)."""
    by_round = {}
    for c in cycles:
        r = by_round.setdefault(c["round"], {"total_s": 0.0})
        r["total_s"] += c["total_s"]
        r.update(c["phases"])
    for r, ph in sorted(by_round.items()):
        log(f"{label} round {r}: wall {ph['total_s']:.3f} s = " + ", ".join(
            f"{k} {v:.3f}" for k, v in ph.items() if k != "total_s"))
    phase_sums = {k: sum(ph.get(k, 0.0) for ph in by_round.values())
                  for k in ("score", "map_ospa", "select", "retrain")}
    log(f"{label}: {len(by_round)} cycles in {loop_s:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in phase_sums.items())}); "
        f"{calls.score_calls} scoring passes, {calls.train_steps} optimizer "
        f"steps; launches {counts}; {card}")
    failed = []
    if set(rj) != RESULT_FIELDS:
        failed.append(f"result.json fields {sorted(set(rj) ^ RESULT_FIELDS)}")
    pct = rj["percentages"]
    if not (pct[-1] == 100.0 and all(a < b for a, b in zip(pct, pct[1:]))):
        failed.append(f"percentages {pct}")
    queried = sorted(q for qs in rj["query_list"].values() for q in qs)
    if queried != list(range(n)):
        failed.append(f"{len(queried)} queries, {len(set(queried))} distinct "
                      f"of {n} samples")
    phases = [set(c["phases"]) for c in cycles]
    if len(cycles) != 2 * rounds + 1 or any(
            p not in ({"score", "map_ospa", "select"}, {"retrain"})
            for p in phases) or phases.count({"retrain"}) != rounds:
        failed.append(f"cycle_times.jsonl: {len(cycles)} lines, {phases}")
    return phase_sums, {str(r): ph for r, ph in sorted(by_round.items())}, \
        failed


def phase_al_loop(video, card, seed, speedup=False):
    """The port's AL loop through its CLI's functions (set_dir, do_al,
    save_result): the DUW strategy (THC+WPU, Influence, Coreset,
    continual, seedfix) on AL_CFG over phase 3's video files
    (on_video_files), from phase 3's seeded weights written as a .pth and a
    seeded AE as Hybrid/WholeBodyAE_zdim4.pth; in f32 parity mode, or with
    --speedup (bf16 serving through K1 in bf16, bf16 crops from K3, the
    bf16 retrainer).  The counters are reset before do_al and read after
    it: K1 4x and K2 1x a scoring pass, K3 once a pass and once a step,
    all of K1's and K3's launches in the mode's dtype.  In f32, the
    retrained model then scores once more through K1, K1's plain version,
    the unfused cuDNN graph and an f64 forward (fold_check), and round 0's
    coreset runs again on the card in f32 and on the host in f64."""
    import torch
    from vatl4pose_tpu_torch.al.selection import coreset_selection
    from vatl4pose_tpu_torch.config import Cfg

    label = "AL loop --speedup" if speedup else "AL loop"
    n = len(video.data)
    rounds = len(AL_CFG["VAL"]["QUERY_RATIO"])
    with tempfile.TemporaryDirectory() as tmp:
        model, ae = make_models(seed)
        cfg = Cfg(copy.deepcopy(AL_CFG))
        write_weights(tmp, cfg, model, ae)
        del model, ae
        on_video_files(video, cfg, tmp, label)
        rj, cycles, counts, by_dtype, calls, loop_s = run_cli_loop(
            cfg, loop_argv(extra=["--speedup"] if speedup else []), tmp,
            prepare=False, keep="p6_speedup" if speedup else "p5")
    phase_sums, table, failed = loop_report(label, rj, cycles, counts,
                                            calls, loop_s, n, rounds, card)
    passes, steps = calls.score_calls, calls.train_steps
    want = {"fused_bottleneck_chain": 4 * passes, "fused_postprocess": passes,
            "rot_warp_crop": passes + steps,
            "deform_im2col": 0, "shuffle_conv3x3": 0}
    dt = "bf16" if speedup else "f32"
    want_dtype = {"fused_bottleneck_chain": {dt: 4 * passes},
                  "rot_warp_crop": {dt: passes + steps}}
    log(f"{label}: launches by kernel and dtype {by_dtype}, K2 "
        f"{counts['fused_postprocess']} (f32)")
    if passes != rounds + 1 or steps == 0 or counts != want \
            or by_dtype != want_dtype:
        failed.append(f"launches {counts} {by_dtype}, want {want} "
                      f"{want_dtype} for {passes} passes and {steps} steps")
    res = {"loop_s": loop_s, "passes": passes, "train_steps": steps,
           "launches": counts, "launches_by_dtype": by_dtype,
           "phase_s": phase_sums, "rounds": table}
    if speedup:
        if failed:
            raise AssertionError(f"{label}: " + "; ".join(failed))
        return res

    fold = fold_check(calls.engine.model, video,
                      label="AL loop: retrained weights")
    if not fold["ok"]:
        failed.append(f"K1 or the fold against the unfused graph {fold}")

    # round 0's coreset: the f32 greedy on the card, the f64 one on the host
    (a, kw) = calls.coreset_args
    kw = dict(kw, rng=None)
    t0 = time.perf_counter()
    p32 = coreset_selection(*a, **dict(kw, precision="f32"))
    t32 = time.perf_counter() - t0
    t0 = time.perf_counter()
    p64 = coreset_selection(*a, **dict(kw, precision="f64"))
    t64 = time.perf_counter() - t0
    gaps = [] if p32 == p64 else coreset_gaps(a, kw, p32, p64)
    log(f"AL loop: round-0 coreset, {len(p32)} picks of {len(a[0])} "
        f"({kw['mode']}): f32 on the card {t32 * 1e3:.1f} ms, f64 on the "
        f"host {t64 * 1e3:.1f} ms; same order {p32 == p64}, same set "
        f"{set(p32) == set(p64)}; differing picks (f32, f64, gap/max) "
        f"{gaps}")
    # after the first differing pick the two greedy states differ, so
    # only that pick's gap tells a near tie from a fault
    if set(p32) != set(p64) and not gaps[0][2] < 1e-6:
        failed.append(f"coreset f32 vs f64 {gaps}")
    torch.cuda.synchronize()
    if failed:
        raise AssertionError("AL loop: " + "; ".join(failed))
    return dict(res, fold_check=fold, coreset_same_order=p32 == p64)


def make_wide_video(root, seed):
    """A JRDB-Pose-wide synthetic video: WIDE_VIDEO's stitched frames of
    3760x480 (5.41 MB each), 8 persons a frame, written as .npy frames (the
    card's machine has no cv2) and a COCO json whose annotation ids end in
    3-digit person numbers (JRDB2022's composite ids).  Each frame is drawn
    in bulk: noise in [0, 40) and a Gaussian blob (sigma 3, amplitude 140)
    at every keypoint, in a 25x25 window.  Returns (root, ann)."""
    import os
    import numpy as np
    from vatl4pose_tpu_torch.data.synthetic import _TEMPLATE
    F_, P = WIDE_VIDEO["num_frames"], WIDE_VIDEO["num_persons"]
    W, H = WIDE_VIDEO["width"], WIDE_VIDEO["height"]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    sizes = rng.uniform([60, 200], [140, 400], size=(P, 2))
    base = np.stack([rng.uniform(20, W - 160, P),
                     rng.uniform(10, H - sizes[:, 1] - 10)], 1)
    vel = rng.uniform(-4, 4, size=(P, 2))
    g = np.exp(-np.arange(-12, 13) ** 2 / (2 * 3.0 ** 2))
    blob = (140.0 * g[:, None] * g[None, :]).astype(np.float32)
    images, anns = [], []
    for f in range(F_):
        img = rng.uniform(0, 40, size=(H, W, 3)).astype(np.float32)
        fname = f"images/{f:06d}.npy"
        for p in range(P):
            xy = base[p] + vel[p] * f
            w, h = sizes[p]
            kps = np.clip(_TEMPLATE * np.array([w, h]) + xy, 0,
                          [W - 1, H - 1])
            for kx, ky in kps:
                cx, cy = int(round(kx)), int(round(ky))
                y0, y1 = max(0, cy - 12), min(H, cy + 13)
                x0, x1 = max(0, cx - 12), min(W, cx + 13)
                img[y0:y1, x0:x1, p % 3] += blob[y0 - cy + 12:y1 - cy + 12,
                                                 x0 - cx + 12:x1 - cx + 12]
            vis = (rng.uniform(size=17) > 0.1).astype(np.float32)
            bx, by = max(0.0, xy[0] - 5), max(0.0, xy[1] - 5)
            bw, bh = min(w + 10, W - bx), min(h + 10, H - by)
            anns.append({
                "id": int(f"{f + 1}{p:03d}"), "image_id": 10000 + f,
                "category_id": 1, "bbox": [float(bx), float(by), float(bw),
                                           float(bh)],
                "area": float(bw * bh), "iscrowd": 0, "track_id": p,
                "keypoints": [float(v) for v in np.stack(
                    [kps[:, 0], kps[:, 1], vis], 1).reshape(-1)]})
        np.save(os.path.join(root, fname),
                np.clip(img, 0, 255).astype(np.uint8))
        images.append({"id": 10000 + f, "image_id": 10000 + f,
                       "file_name": fname, "width": W, "height": H,
                       "vid_id": "000001", "frame_id": f})
    ann = "annotations/000001.json"
    with open(os.path.join(root, ann), "w") as fh:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": 1, "name": "person",
             "keypoints": [f"kp{i}" for i in range(17)], "skeleton": []}]},
            fh)
    return root, ann


def phase_streaming_loop(card, seed):
    """The DUW loop in f32 on a video over the frame budget: the
    JRDB-wide video of make_wide_video (96 frames, 0.48 GiB, 768 samples:
    scoring chunks of 512 and 256) as a JRDB2022 dataset, AL_CFG with two
    cuts (VAL.QUERY_RATIO [0.05, 0.5, 1.0], and VAL.HBM_FRAME_BUDGET_GB
    0.25 so that the video streams) and RETRAIN.ALPHA STREAM_ALPHA.
    Checked:
    the loop streams (al.streaming, no frames on the card), every sample
    queried once, result.json and cycle_times.jsonl complete, K1 4x and
    K2 1x a chunk, K3 never (the crops come from the host warp).  The
    streamed scores against the resident ones (the frames on the card,
    K3's crops; streamed_vs_resident) twice: on the seeded weights, as
    the JAX package's test compares them on random ones, and on the
    loop's retrained weights, THC there to its heatmap scale.  The loop
    starts, as a user's does, from weights pre-trained on other videos:
    stream_pretrain on a second wide video (seed + 1), whose training
    accuracy must reach STREAM_PRETRAIN_ACC (the loop's few steps from
    seeded weights leave maps with many near ties, which the host crop's
    uint8 rounding flips); that training and the loop's retrains run on
    deterministic algorithms, so that the retrained weights, and the
    shares, repeat from call to call (ROADMAP C6); a retrain step's cost in
    that mode is printed.  The pre-trained weights are returned beside the
    results, for phase 11.
    Then on the retrained weights also the device time by kernel of one
    streamed pass (profiler), and the streamed path at chunk 256 against
    chunk 512 within 1e-5, with cuDNN held to deterministic algorithms."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.data import build_dataset

    rounds = len(STREAM_QUERY_RATIO)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, ann = make_wide_video(tmp, seed)
        log(f"wide video: {WIDE_VIDEO}, written in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = Cfg(copy.deepcopy(AL_CFG))
        cfg.VAL.QUERY_RATIO = list(STREAM_QUERY_RATIO)
        cfg.VAL.HBM_FRAME_BUDGET_GB = STREAM_BUDGET_GB
        cfg.RETRAIN.ALPHA = STREAM_ALPHA
        for split in ("TRAIN", "EVAL"):
            cfg.DATASET[split].TYPE = "JRDB2022"
            cfg.DATASET[split].ROOT = root
            cfg.DATASET[split].ANN = ann
        ds = build_dataset({"TYPE": "JRDB2022", "ROOT": root, "ANN": ann})
        frames = ds.load_frames()
        d = ds.data
        args = (d.frame_idx, d.bboxes, d.gt_keypoints,
                np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                          d.bboxes[:, 2] - d.bboxes[:, 0],
                          d.bboxes[:, 3] - d.bboxes[:, 1]], 1),
                d.is_prev, d.is_next)
        model, ae = make_models(seed)
        engine = ScoringEngine(
            model.cuda(), ScoringConfig(
                uncertainty="THC+WPU", need_embedding=True,
                input_size=INPUT_SIZE, eval_joints=list(range(17))),
            ae_model=ae.cuda())
        seeded, seeded_failed = streamed_vs_resident(
            "streaming loop, seeded weights", engine, ds.frame_store(),
            frames, args)
        del engine, model
        ae.cpu()
        # a user's model comes pre-trained on other videos: a second wide
        # video (another seed).  Trained on the loop's own video it decodes
        # every query at OKS ~1, and the loop's continual retrains,
        # ALPHA * (1 - mean OKS) epochs, round down to none
        proot, pann = make_wide_video(f"{tmp}/pretrain_video", seed + 1)
        pre = stream_pretrain(proot, pann, f"{tmp}/pretrain", seed)
        model = pre.pop("model")
        jrdb_state = {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}
        pre_failed = []
        if not pre["acc"] >= STREAM_PRETRAIN_ACC:
            pre_failed.append(f"pretraining reached training accuracy "
                              f"{pre['acc']:.4f}, below "
                              f"{STREAM_PRETRAIN_ACC}")
        pre["step_ms"] = deterministic_step_cost(
            model, ds, torch.from_numpy(frames).cuda(), seed)
        write_weights(tmp, cfg, model.cpu(), ae)
        del model, ae
        torch.cuda.empty_cache()
        argv = ["--cfg", "configs/jrdb-pose (JRDB-wide synthetic)",
                "--video_id", "000001", "--uncertainty", "THC+WPU",
                "--representativeness", "Influence", "--filter", "Coreset",
                "--continual", "--seedfix", "--synthetic", "--memo",
                "chip_smoke_stream"]
        with deterministic_retrains():
            rj, cycles, counts, by_dtype, calls, loop_s = run_cli_loop(
                cfg, argv, tmp, prepare=False, keep="p7_stream")
        al = calls.al
        n = al.eval_len
        label = "streaming loop"
        phase_sums, table, failed = loop_report(label, rj, cycles, counts,
                                                calls, loop_s, n, rounds,
                                                card)
        failed += seeded_failed + pre_failed
        if not (al.streaming and al.frames_dev is None):
            failed.append(f"streaming {al.streaming}, frames on the card "
                          f"{al.frames_dev is not None}")
        chunks = -(-n // al.engine.chunk)
        passes, steps = calls.score_calls, calls.train_steps
        want = {"fused_bottleneck_chain": 4 * chunks * passes,
                "fused_postprocess": chunks * passes, "rot_warp_crop": 0,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        log(f"{label}: {n} samples, {chunks} chunks of {al.engine.chunk}, "
            f"frames {al.frame_store.total_bytes / 2 ** 30:.3f} GiB over "
            f"the budget {STREAM_BUDGET_GB} GiB; launches by kernel and "
            f"dtype {by_dtype}, K2 {counts['fused_postprocess']}")
        if passes != rounds + 1 or steps == 0 or counts != want:
            failed.append(f"launches {counts}, want {want} for {passes} "
                          f"passes of {chunks} chunks")
        score_warps = [t for k, t in calls.host_warps if k > RETRAIN[
            "BATCH_SIZE"]]
        train_warps = [t for k, t in calls.host_warps
                       if k <= RETRAIN["BATCH_SIZE"]]
        warp = {"chunks": len(score_warps),
                "ms_per_chunk": 1e3 * statistics.median(score_warps),
                "batches": len(train_warps),
                "ms_per_batch": 1e3 * statistics.median(train_warps)}
        log(f"host warp (native/warp/warp_affine.cpp, mode 1): "
            f"{warp['chunks']} scoring chunks, median "
            f"{warp['ms_per_chunk']:.1f} ms each; {warp['batches']} train "
            f"batches of {RETRAIN['BATCH_SIZE']}, median "
            f"{warp['ms_per_batch']:.1f} ms each (host clock)")

        # one more streamed pass on the retrained weights, profiled
        d = al.data
        args = (d.frame_idx, d.bboxes, d.gt_keypoints,
                np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                          d.bboxes[:, 2] - d.bboxes[:, 0],
                          d.bboxes[:, 3] - d.bboxes[:, 1]], 1),
                d.is_prev, d.is_next)
        engine = al.engine
        t0 = time.perf_counter()
        streamed = engine.score_streaming(al.frame_store, *args)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        log(f"{label}: one streamed pass on the retrained weights "
            f"{pass_s:.3f} s ({n / pass_s:.1f} samples/s)")
        profile_call(
            lambda: engine.score_streaming(al.frame_store, *args),
            "streamed scoring pass")
        retrained, retrained_failed = streamed_vs_resident(
            "streaming loop, retrained weights", engine, al.frame_store,
            frames, args, thc_scale=True)
        failed += retrained_failed
        del frames
        # chunk 256 against 512, with cuDNN held to deterministic
        # algorithms: otherwise it picks them by batch size, and the
        # deconvolutions' f32 sums then move a heatmap by about 1e-6 of its
        # max between the two, enough to move a near-tie local peak in gc
        other = ScoringEngine(engine.model, engine.cfg,
                              ae_model=engine.ae_model, chunk=256)
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            full = engine.score_streaming(al.frame_store, *args)
            half = other.score_streaming(al.frame_store, *args)
        finally:
            torch.backends.cudnn.deterministic = det
    # the halo hides the chunk edges
    keys = ("oks", "unc", "unc2", "det_score", "gc", "kpts", "coords",
            "scores", "embeddings")
    chunk_err = {k: float(np.abs(half[k] - full[k]).max()) for k in keys}
    if not all(np.allclose(half[k], full[k], rtol=1e-5, atol=1e-5)
               for k in keys):
        failed.append(f"chunk 256 vs 512: {chunk_err}")
    log(f"{label}: chunk 256 vs 512 max|diff| {chunk_err} (bar 1e-5)")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return jrdb_state, {
        "loop_s": loop_s, "passes": passes, "train_steps": steps,
        "chunks_per_pass": chunks, "launches": counts,
        "launches_by_dtype": by_dtype, "phase_s": phase_sums,
        "rounds": table, "host_warp": warp, "pass_s": pass_s,
        "pretrain": pre,
        "streamed_vs_resident": {"seeded": seeded, "retrained": retrained},
        "chunk_256_vs_512": chunk_err}


def streamed_vs_resident(label, engine, store, frames, args,
                         thc_scale=False):
    """The streamed scores (engine.score_streaming over the host-RAM frame
    store: host-warp crops) against the resident ones (engine.score with
    the numpy frames uploaded: K3's crops) on the same weights.  The host
    crop is the device crop rounded to uint8 (0.5 LSB); the JAX package's
    bounds for that (tests/test_stream.py, 10 samples of random weights):
    OKS, THC, det_score and gc within rtol = atol = 2e-2, more than 99% of
    kpts within (2e-2, 1.0).  Held as written but for two, whose share
    within the bound as written is printed.  (1) Over hundreds of samples
    a few joints have near ties and decode a heatmap pixel (or the ±0.25
    shift) apart, which moves their sample's OKS by up to 1/17 (the JAX
    test allows such isolated jumps in kpts): OKS and every kpts value are
    held on the samples whose joints all decode to the same heatmap
    position, and they must be at least half of all.  (2) With thc_scale
    (weights that have been trained on the video), THC is held to 2e-2 of
    its heatmap scale 2 sum|H|/K (its two neighbour terms' L1 mass) plus
    the same atol: THC sums |H - H_adj| over every pixel, and the maps of
    neighbouring samples nearly cancel there, so the rounding's noise is
    small beside the maps, not beside THC.  Returns (shares within the
    bounds, failures)."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.ops import get_max_pred, subpixel_refine
    streamed = engine.score_streaming(store, *args, keep_heatmaps=True)
    frames_dev = torch.from_numpy(frames).cuda()
    resident = engine.score(frames_dev, *args, keep_heatmaps=True)
    del frames_dev
    hms = [r.pop("heatmaps").float().cpu() for r in (streamed, resident)]
    mass = (hms[1].abs().sum(dim=(1, 2, 3)) / hms[1].shape[1]).numpy()
    decode = [subpixel_refine(h, get_max_pred(h)[0]).numpy() for h in hms]
    del hms
    alike = (decode[0] == decode[1]).all(axis=(1, 2))      # (N,)
    n = len(alike)
    kp_close = np.isclose(streamed["kpts"], resident["kpts"], rtol=2e-2,
                          atol=1.0)
    cmp, failed = {"kpts": float(kp_close.mean()),
                   "samples_decoded_alike": float(alike.mean())}, []
    if not cmp["kpts"] > 0.99:
        failed.append(f"{label}, streamed vs resident kpts: "
                      f"{cmp['kpts']:.4f} within the bound")
    if not cmp["samples_decoded_alike"] >= 0.5:
        failed.append(f"{label}: {alike.sum()} of {n} samples decode "
                      f"alike, fewer than half")
    if not kp_close[alike].all():
        failed.append(f"{label}: kpts apart on a sample whose joints all "
                      f"decode alike")
    for k in ("oks", "unc", "det_score", "gc"):
        diff = np.abs(streamed[k] - resident[k])
        ok = np.isclose(streamed[k], resident[k], rtol=2e-2, atol=2e-2)
        cmp[k] = float(ok.mean())
        rel = diff / np.maximum(np.abs(resident[k]), 1e-12)
        log(f"{label}: streamed vs resident {k}: |resident| median "
            f"{np.median(np.abs(resident[k])):.4e}, max |diff| "
            f"{diff.max():.4e}, rel diff median {np.median(rel):.3e} max "
            f"{rel.max():.3e}")
        if k == "oks":
            ok = ok[alike]
        if k == "unc" and thc_scale:
            cmp["unc_vs_scale"] = float((diff / (2 * mass)).max())
            ok = diff <= 2e-2 * 2 * mass + 2e-2
        if not ok.all():
            failed.append(f"{label}, streamed vs resident {k}: "
                          f"{ok.mean():.4f} within the bound")
    log(f"{label}: streamed vs resident, share within the JAX bounds {cmp}")
    return cmp, failed


def stream_pretrain(root, ann, work_dir, seed):
    """Phase 7's pre-training on the wide video: the JRDB pre-training
    CLI's trainer (jrdbpose_train's guard, then posetrack_train.train) on
    PRETRAIN_CFG with the wide video as its JRDB2022 set, no flips (the
    synthetic skeleton is not JRDB's), no rotations or scalings (the
    scoring crops have none), STREAM_PRETRAIN_EPOCHS with a linear warmup
    over STREAM_PRETRAIN_WARMUP epochs and the rate cut tenfold at
    STREAM_PRETRAIN_LR_STEP, from the model's own init, frames on the
    card, one validation (validate_gt) at the end; under deterministic
    algorithms.  Returns the model (on the card, in train mode) and the
    last epoch's loss, acc and AP, the first epoch's loss and acc, the
    wall, the K3 launches (one an optimizer step, one the validation) and
    the steps."""
    import argparse
    import torch
    from vatl4pose_tpu_torch.cli import jrdbpose_train, posetrack_train
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    cfg = Cfg(copy.deepcopy(PRETRAIN_CFG))
    cfg.DATASET.TRAIN.update(TYPE="JRDB2022", ROOT=root, ANN=ann)
    cfg.DATASET.TRAIN.AUG.update(FLIP=False, ROT_FACTOR=0, SCALE_FACTOR=0.0)
    cfg.TRAIN.update(END_EPOCH=STREAM_PRETRAIN_EPOCHS,
                     LR_STEP=list(STREAM_PRETRAIN_LR_STEP),
                     WARMUP_EPOCHS=STREAM_PRETRAIN_WARMUP)
    cfg.TRAIN.pop("DPG_MILESTONE")
    jrdbpose_train.check_jrdb(cfg)
    opt = argparse.Namespace(seed=seed, snapshot=STREAM_PRETRAIN_EPOCHS,
                             epochs_override=None, work_dir=work_dir,
                             stream=False, launcher="none", device=None)
    with CallLog() as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_launch_counts()
        with deterministic():
            model, history = posetrack_train.train(cfg, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = calls.train_steps
    first, last = history[0], history[-1]
    for h in history:
        if h["epoch"] % 10 == 9 or h is first or h is last:
            log(f"streaming loop pretraining (jrdbpose_train), epoch "
                f"{h['epoch']}: loss {h['loss']:.6f} acc {h['acc']:.4f} lr "
                f"{h['lr']:.1e} wall {h['wall_s']:.2f} s"
                + (f" AP {h['ap']:.4f}" if "ap" in h else ""))
    log(f"streaming loop pretraining: {len(history)} epochs, {steps} "
        f"optimizer steps at batch {PRETRAIN_TRAIN['BATCH_SIZE']} in "
        f"{wall:.1f} s; training accuracy {last['acc']:.4f} (bar "
        f"{STREAM_PRETRAIN_ACC}); launches {counts}")
    return {"model": model, "epochs": len(history), "steps": steps,
            "wall_s": wall, "first": {"loss": first["loss"],
                                      "acc": first["acc"]},
            "loss": last["loss"], "acc": last["acc"], "ap": last.get("ap"),
            "launches": counts}


def deterministic_step_cost(model, ds, frames_dev, seed, steps=5):
    """ms of one retrain step of the AL loop's retrainer (RETRAIN: batch
    120, AdamW) on a copy of `model`, frames on the card: the median of
    `steps` steps after two warm ones, CUDA events, with the default
    algorithms and with deterministic ones."""
    import types
    import numpy as np
    import torch
    video = types.SimpleNamespace(data=ds.data, joint_pairs=ds.joint_pairs)
    tr = make_retrainer(copy.deepcopy(model), video, seed=seed)
    tr.model.train()
    batch = train_batch(video, RETRAIN["BATCH_SIZE"],
                        np.random.default_rng(seed))
    out = {}
    for mode in ("default", "deterministic"):
        ctx = deterministic() if mode == "deterministic" \
            else contextlib.nullcontext()
        with ctx:
            out[mode] = cuda_ms(lambda: tr.train_step(frames_dev, *batch),
                                reps=steps)
    log(f"retrain step at batch {RETRAIN['BATCH_SIZE']}: "
        f"{out['default']:.1f} ms with the default algorithms, "
        f"{out['deterministic']:.1f} ms with deterministic ones "
        f"(median of {steps}, CUDA events)")
    del tr
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def deterministic_retrains():
    """The AL loop's estimator retrains and AE fine-tunes on deterministic
    algorithms (its scoring passes as they are), for the duration."""
    from vatl4pose_tpu_torch.train import retrain

    def held(method):
        def run(*a, **kw):
            with deterministic():
                return method(*a, **kw)
        return run
    with contextlib.ExitStack() as stack:
        for owner, name in ((retrain.Retrainer, "retrain"),
                            (retrain.Retrainer, "retrain_streaming"),
                            (retrain.AETrainer, "train")):
            stack.enter_context(patched(owner, name, held))
        yield


def pretrain(model, cfg, ds, frames, epochs, seed, aug=AUG):
    """`epochs` of the retrainer (cfg's RETRAIN and DATA_PRESET, aug) on
    the card over every sample of the dataset `ds`, its frames (numpy)
    uploaded, so that a loop starts from weights trained on the video, as
    a user's pretrained model is, and not from random ones.  In place; the
    model is left on the CPU in eval mode.  Returns the final epoch's
    (loss, acc)."""
    import torch
    from vatl4pose_tpu_torch.data import AugCfg
    from vatl4pose_tpu_torch.train import Retrainer
    d = ds.data
    model.cuda().train()
    tr = Retrainer(model, cfg["RETRAIN"], "SimplePose",
                   input_size=tuple(cfg["DATA_PRESET"]["IMAGE_SIZE"]),
                   hm_size=tuple(cfg["DATA_PRESET"]["HEATMAP_SIZE"]),
                   sigma=2.0, aug=AugCfg(**aug), joint_pairs=ds.joint_pairs,
                   seed=seed)
    frames_dev = torch.from_numpy(frames).cuda()
    out = tr.retrain(d, frames_dev, list(range(len(d))), epochs,
                     (d.width, d.height))
    del frames_dev, tr
    model.cpu().eval()
    torch.cuda.empty_cache()
    return out


def c1_pretrain(model, seed):
    """pretrain on the C1 video (the video the CLI's prepare_synthetic
    makes from the same arguments), C1_PRETRAIN_EPOCHS of C1_CFG."""
    from vatl4pose_tpu_torch.data import build_dataset, make_synthetic_video
    with tempfile.TemporaryDirectory() as tmp:
        root, ann = make_synthetic_video(
            tmp, video_id="000001", seed=seed, **C1_VIDEO)
        ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
        frames = ds.load_frames()
    return pretrain(model, C1_CFG, ds, frames, C1_PRETRAIN_EPOCHS, seed)


def phase_c1_loop(card, seed):
    """C1's card check: the DUW loop on a small config (C1_CFG: the
    synthetic config's 128x96 input, 32x24 maps and RETRAIN, with
    SimplePose-R50, whose bottleneck tails go through K1; R18 has none) on
    a 48-sample synthetic video, from the same seeded .pth, --seedfix, on
    the card in f32 parity mode and on the CPU, both through the port, and
    every round's query list compared.  To tell K1's part from the rest of
    f32 arithmetic, the card's loop also runs with K1's plain version (the
    same fold, cuDNN's f32 products) and with the unfused graph, and the
    CPU's with the unfused graph: two exact f32 implementations of one
    model, whose distance is the reference's own f32 noise.  Each run's
    round-0 scores (THC, WPU, influence) are compared with the CPU's
    (max|diff| / max).  Twice: from random weights, and from the same
    weights pretrained on the card on the video (c1_pretrain).  Checked:
    K1 runs in the card's loops; from the pretrained weights every round's
    query list on the card equals the CPU's, with no tolerance; from random
    weights, where the selection rides on f32 noise (a min-max over
    near-equal influence sums) and the CPU's own fused and unfused graphs
    pick apart too (ROADMAP C2), the lists are printed and each of K1's
    round-0 scores lies at most twice as far from the CPU's as the
    farthest of the other three f32 implementations (K1's plain version,
    the card's and the CPU's unfused graphs)."""
    import numpy as np
    import torch
    import vatl4pose_tpu_torch.models.resnet as resnet_mod
    from vatl4pose_tpu_torch.al import active_learning
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.kernels import bottleneck_chain_reference
    from vatl4pose_tpu_torch.models import SimplePose, WholeBodyAE
    gen = torch.Generator().manual_seed(seed + 7)
    mcfg = C1_CFG["MODEL"]
    model = randomize_(SimplePose(
        num_joints=17, num_layers=mcfg["NUM_LAYERS"],
        deconv_dim=tuple(mcfg["NUM_DECONV_FILTERS"]), fused_eval=True,
        device="cpu"), gen)
    ae = randomize_(WholeBodyAE(z_dim=4, input_dim=38, device="cpu"), gen)
    kernel, build = resnet_mod.fused_bottleneck_chain, \
        active_learning.build_sppe
    variants = (("card", "cuda"), ("card, K1's plain version", "cuda"),
                ("card, unfused", "cuda"), ("CPU", "cpu"),
                ("CPU, unfused", "cpu"))

    def round0(rj):
        unc = np.array(list(rj["uncertaity"]["Round0"].values()))
        inf = np.array(list(rj["influence"]["Round0"].values()))
        return {"THC": unc[:, 0], "WPU": unc[:, 1], "influence": inf}

    res, failed = {}, []
    for setting in ("random", "pretrained"):
        if setting == "pretrained":
            t0 = time.perf_counter()
            loss, acc = c1_pretrain(model, seed)
            log(f"C1: pretrained on the card, {C1_PRETRAIN_EPOCHS} epochs in "
                f"{time.perf_counter() - t0:.1f} s: loss {loss:.6f}, acc "
                f"{acc:.4f}")
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Cfg(copy.deepcopy(C1_CFG))
            write_weights(tmp, cfg, model, ae)
            for i, (name, dev) in enumerate(variants):
                argv = ["--cfg", "configs/synthetic/al_simple_synthetic.yaml",
                        "--video_id", "000001", "--uncertainty", "THC+WPU",
                        "--representativeness", "Influence", "--filter",
                        "Coreset", "--continual", "--seedfix", "--synthetic",
                        "--memo", f"c1_{setting}_{i}", "--synth_seed",
                        str(seed),
                        "--synth_frames", str(C1_VIDEO["num_frames"]),
                        "--synth_persons", str(C1_VIDEO["num_persons"]),
                        "--synth_size", str(C1_VIDEO["width"]),
                        str(C1_VIDEO["height"]), "--device", dev]
                if "plain" in name:
                    resnet_mod.fused_bottleneck_chain = \
                        bottleneck_chain_reference
                if "unfused" in name:
                    active_learning.build_sppe = lambda *a, **kw: build(
                        *a, **dict(kw, fused_eval=False))
                try:
                    rj, _, counts, _, _, loop_s = run_cli_loop(
                        copy.deepcopy(cfg), argv, tmp)
                finally:
                    resnet_mod.fused_bottleneck_chain = kernel
                    active_learning.build_sppe = build
                runs[name] = (rj, counts, loop_s)
                log(f"C1 loop ({setting}), {name}: {loop_s:.2f} s, launches "
                    f"{counts}, query lists {rj['query_list']}")
        want = runs["CPU"][0]["query_list"]
        cpu0 = round0(runs["CPU"][0])
        out = {"launches": runs["card"][1]}
        for name, _ in variants:
            if name == "CPU":
                continue
            got = runs[name][0]["query_list"]
            same = {r: got.get(r) == want.get(r) for r in want}
            run0 = round0(runs[name][0])
            dist = {k: float(np.abs(run0[k] - cpu0[k]).max()
                             / max(np.abs(cpu0[k]).max(), 1e-30))
                    for k in cpu0}
            out[name] = {"same_by_round": same, "round0_score_dist": dist}
            log(f"C1 ({setting}): {name} vs CPU, query lists equal by round "
                f"{same}; round-0 scores max|diff|/max {dist}")
        if runs["card"][1]["fused_bottleneck_chain"] == 0:
            failed.append(f"{setting}: K1 never ran in the card's loop")
        spread = {k: max(out[name]["round0_score_dist"][k]
                         for name, _ in variants[1:] if name != "CPU")
                  for k in cpu0}
        out["k1_vs_spread"] = {k: out["card"]["round0_score_dist"][k]
                                  / max(spread[k], 1e-30) for k in cpu0}
        log(f"C1 ({setting}): K1's round-0 distance from the CPU over the "
            f"others' largest {out['k1_vs_spread']} (bar 2)")
        if setting == "random" and max(out["k1_vs_spread"].values()) > 2:
            failed.append(f"random weights: K1's round-0 scores lie over "
                          f"twice the others' spread from the CPU's: "
                          f"{out['k1_vs_spread']}")
        out["query_lists_equal"] = all(out["card"]["same_by_round"].values())
        if setting == "pretrained" and not out["query_lists_equal"]:
            failed.append(f"the card's query lists differ from the CPU's: "
                          f"{runs['card'][0]['query_list']} vs {want}")
        res[setting] = out
    res["launches"] = {k: res["random"]["launches"][k]
                       + res["pretrained"]["launches"][k]
                       for k in res["random"]["launches"]}
    log(f"C1: card vs CPU query lists equal: random weights "
        f"{res['random']['query_lists_equal']}, pretrained "
        f"{res['pretrained']['query_lists_equal']}; {card}")
    if failed:
        raise AssertionError("C1: " + "; ".join(failed))
    return res


OTHER_STRATEGIES = ("TPC", "MPE", "Margin", "Entropy", "VL4Pose")
# the loops of phase 9, as run_active_learning.sh drives them
OTHER_LOOPS = (("MPE", "K-Means"), ("VL4Pose", "weighted"))
STUDY_TRIALS = 2


def phase_other_scoring(video, seed):
    """One ScoringEngine.score pass of each other strategy over phase 3's
    512 samples, SimplePose-R50 at 256x192 in f32 parity mode (phase 3's
    seeded weights; VL4Pose with an AuxNet of the seeded default init):
    K3 once, K1 4 times and K2 once a pass, counted from 0 before each.
    Then stage 2 again on the same pass's heatmaps, on the card (timed) and
    on the CPU: MPE, Margin and Entropy within 1e-5 (rtol; -inf equal;
    Entropy again on the maps' magnitudes, where at least half of the
    samples must have a finite entropy);
    TPC's counts equal on every sample whose joints, and whose
    neighbours' joints, decode alike on both (within 1e-2 px: the same
    heatmap pixel); VL4Pose within 1e-5 (rtol)
    on every sample whose top-5 peaks sit at the same places on both.
    Returns launches, pass walls and stage-2 ms by strategy."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    from vatl4pose_tpu_torch.models import AuxNet
    from vatl4pose_tpu_torch.ops import peak_local_max_topk

    model, _ = make_models(seed)
    model.cuda()
    aux = AuxNet()
    frames, fi, bb, gt, bb_ann, prev, nxt = video.args
    n = len(fi)
    host = [torch.as_tensor(np.asarray(a), dtype=dt) for a, dt in (
        (gt, torch.float32), (bb_ann, torch.float32), (prev, torch.bool),
        (nxt, torch.bool))]
    out, failed = {}, []
    for u in OTHER_STRATEGIES:
        cfg = ScoringConfig(uncertainty=u)
        engine = ScoringEngine(model, cfg, aux_model=aux, chunk=BATCH)
        engine.score(*video.args, keep_heatmaps=False)      # warm
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = engine.score(*video.args, keep_heatmaps=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in KERNELS}
        want = {"fused_bottleneck_chain": 4, "fused_postprocess": 1,
                "rot_warp_crop": 1,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        if counts != want:
            failed.append(f"{u}: launches {counts}, want {want}")
        unc = res["unc"]
        if unc.shape != (n,) or not (np.isfinite(unc) | (
                (u == "Entropy") & (unc == -np.inf))).all():
            failed.append(f"{u}: unc {unc.shape}, not finite")

        hms, _, bbox_crop, params = engine.forward_video(frames, fi, bb)
        dev_args = (hms, bbox_crop, *(h.cuda() for h in host), params)
        cpu_engine = ScoringEngine(model, cfg, aux_model=aux, device="cpu")

        def stage2_pair(maps):
            """Stage 2 on the card and on the CPU on the same maps."""
            return (engine._score_video(maps, *dev_args[1:]),
                    cpu_engine._score_video(
                        maps.cpu(), bbox_crop.cpu(), *host,
                        None if params is None else params.cpu()))

        stage2_ms = cuda_ms(lambda: engine._score_video(*dev_args), reps=5)
        card, cpu = stage2_pair(hms)
        g, w = card["unc"].cpu().numpy(), cpu["unc"].numpy()
        # K2's decode is bit-exact against its plain version; the image
        # coords then differ by the affine's rounding, a heatmap pixel by
        # whole image pixels
        alike = ((card["coords"].cpu() - cpu["coords"]).abs()
                 .amax(dim=(1, 2)) < 1e-2).numpy()
        if u == "TPC":
            ok = alike & np.roll(alike, 1) & np.roll(alike, -1)
        elif u == "VL4Pose":
            pk = [peak_local_max_topk(h) for h in (hms.float(),
                                                   hms.float().cpu())]
            ok = ((pk[0][2].cpu() == pk[1][2]) & (pk[0][3].cpu() == pk[1][3])
                  & (pk[0][1].cpu() == pk[1][1])).all(dim=(1, 2)).numpy()
        else:
            ok = np.ones(n, bool)
        with np.errstate(invalid="ignore"):       # -inf - -inf (Entropy)
            diff = np.where(np.isinf(w) & (g == w), 0.0, np.abs(g - w))
        if u == "TPC":
            bad = (g != w) & ok
        else:
            bad = ok & ~(diff <= 1e-5 * np.where(np.isinf(w), 0, np.abs(w))
                         + 1e-6)
        scan_ms = cuda_ms(lambda: peak_local_max_topk(hms.float()), reps=5) \
            if u in ("MPE", "Margin", "VL4Pose") else None
        log(f"  {u}: pass {wall:.3f} s, launches {counts}; stage 2 "
            f"{stage2_ms:.3f} ms on the card"
            + (f" (peak scan {scan_ms:.3f} ms)" if scan_ms else "")
            + f"; card vs CPU stage 2: max|diff| {diff.max():.3e} "
            f"(|unc|max {np.where(np.isinf(w), 0, np.abs(w)).max():.3e})"
            f", samples compared {ok.mean():.3f}, outside the bound "
            f"{int(bad.sum())}")
        if bad.any() or ok.mean() < 0.5:
            failed.append(f"{u}: card and CPU stage 2 apart on {bad.sum()} "
                          f"samples, {ok.mean():.3f} compared")
        out[u] = {"pass_s": wall, "stage2_ms": stage2_ms,
                  "peak_scan_ms": scan_ms, "launches": counts,
                  "compared_share": float(ok.mean())}
        if u == "Entropy":
            # the seeded maps hold negative values, whose entropy is -inf
            # on both sides; their magnitudes give finite entropies
            gp, wp = (r["unc"].cpu().numpy() for r in stage2_pair(hms.abs()))
            finite = np.isfinite(gp) & np.isfinite(wp)
            diff_p = np.where(finite, np.abs(gp - wp), 0.0)
            scale = np.where(finite, np.abs(wp), 0.0)
            bad_p = finite & ~(diff_p <= 1e-5 * scale + 1e-6)
            log(f"  Entropy on |maps|: card vs CPU stage 2 max|diff| "
                f"{diff_p.max():.3e} (|unc|max {scale.max():.3e}), finite "
                f"share {finite.mean():.3f}, outside the bound "
                f"{int(bad_p.sum())}")
            if finite.mean() < 0.5 or bad_p.any():
                failed.append(f"Entropy on |maps|: {int(bad_p.sum())} apart, "
                              f"finite share {finite.mean():.3f}")
            out[u]["finite_share_abs_maps"] = float(finite.mean())
        del hms, params, dev_args, card
    del model, aux
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("other strategies: " + "; ".join(failed))
    return out


def phase_other_loops(video, card, seed):
    """The AL loop through the CLI's functions on MPE with the K-Means
    filter and on VL4Pose with the weighted filter, as phase 5 drives DUW
    (AL_CFG, 9 rounds and the final evaluation, RETRAIN.ALPHA 4, phase 3's
    seeded weights, --continual --seedfix, f32).  Checked as phase 5's
    loop (fields, percentages to 100, every sample queried once, K1 4x and
    K2 1x a pass, K3 once a pass and once a step, all f32), and every
    round's query holds query_size distinct members of that round's
    candidate list."""
    from vatl4pose_tpu_torch.config import Cfg
    n = len(video.data)
    rounds = len(AL_CFG["VAL"]["QUERY_RATIO"])
    out = {}
    for unc, flt in OTHER_LOOPS:
        label = f"AL loop {unc} + {flt}"
        with tempfile.TemporaryDirectory() as tmp:
            model, ae = make_models(seed)
            cfg = Cfg(copy.deepcopy(AL_CFG))
            write_weights(tmp, cfg, model, ae)
            del model, ae
            on_video_files(video, cfg, tmp, label)
            rj, cycles, counts, by_dtype, calls, loop_s = run_cli_loop(
                cfg, loop_argv(unc, "None", flt), tmp, prepare=False,
                keep=f"p9_{unc.lower()}")
        phase_sums, table, failed = loop_report(
            label, rj, cycles, counts, calls, loop_s, n, rounds, card)
        passes, steps = calls.score_calls, calls.train_steps
        want = {"fused_bottleneck_chain": 4 * passes,
                "fused_postprocess": passes, "rot_warp_crop": passes + steps,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        want_dtype = {"fused_bottleneck_chain": {"f32": 4 * passes},
                      "rot_warp_crop": {"f32": passes + steps}}
        if passes != rounds + 1 or steps == 0 or counts != want \
                or by_dtype != want_dtype:
            failed.append(f"launches {counts} {by_dtype}, want {want} "
                          f"{want_dtype}")
        for r, (cands, size, q, sec) in enumerate(calls.filters):
            log(f"{label} round {r}: {flt} filter {sec * 1e3:.1f} ms, "
                f"{len(q)} of {len(cands)} candidates (query size {size})")
            # the final evaluation has no candidates: nothing to query
            if cands and (len(q) != size or len(set(q)) != len(q)
                          or not set(q) <= set(cands)):
                failed.append(f"round {r}: query {q} for size {size}")
        if failed:
            raise AssertionError(f"{label}: " + "; ".join(failed))
        out[f"{unc}_{flt}"] = {
            "loop_s": loop_s, "passes": passes, "train_steps": steps,
            "launches": counts, "phase_s": phase_sums, "rounds": table,
            "filter_ms": [1e3 * r[3] for r in calls.filters]}
    return out


def phase_study(video, seed):
    """optimize_alc (run_study: the objective, the grid sampler and
    Study.optimize, then its two plots, with matplotlib, cv2 and PIL
    refused) for STUDY_TRIALS trials, each the DUW loop over phase 3's
    video files with the study's own QUERY_RATIO (6 rounds), from phase
    3's seeded weights; counters from 0 before it.  Checked: each trial's
    ALC is finite, the trials took the grid's first values, K1, K2 and K3
    ran, optuna_history.png (896x672) and optuna_slice.png (700x560) read
    back, not one colour."""
    import math
    from vatl4pose_tpu_torch.al import optuna_lite
    import torch
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    with tempfile.TemporaryDirectory() as tmp:
        model, ae = make_models(seed)
        cfg = Cfg(copy.deepcopy(AL_CFG))
        write_weights(tmp, cfg, model, ae)
        del model, ae
        on_video_files(video, cfg, tmp, "study")
        argv = loop_argv(extra=["--optimize", "--search", "grid"])
        with cli_workdir(cfg, argv, tmp, prepare=False) as (cfg, opt):
            reset_launch_counts()
            t0 = time.perf_counter()
            with refusing(), FigureTimes(optuna_lite.Study, (
                    "plot_history", "plot_slice")) as figs:
                study = cli.optimize_alc(cfg, opt, [opt.video_id],
                                         n_trials=STUDY_TRIALS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k.__name__: k.launches for k in KERNELS}
            import os
            for name, size in (("optuna_history.png", (896, 672)),
                               ("optuna_slice.png", (700, 560))):
                png_pixels(os.path.join(opt.work_dir, name), size)
    hist = study.history()
    log(f"study: {len(hist)} trials in {wall:.2f} s: " + ", ".join(
        f"unc_lambda {p['unc_lambda']} ALC {v:.4f}" for _, p, v in hist)
        + f"; best ALC {study.best_value:.4f} at {study.best_params}; "
        f"launches {counts}; the two plots, ms each: "
        + json.dumps(figs.summary()))
    if [p["unc_lambda"] for _, p, _ in hist] != [0.001, 0.01][:STUDY_TRIALS] \
            or not all(math.isfinite(v) for _, _, v in hist) \
            or 0 in (counts["fused_bottleneck_chain"],
                     counts["fused_postprocess"], counts["rot_warp_crop"]) \
            or counts["deform_im2col"] or counts["shuffle_conv3x3"]:
        raise AssertionError(f"study: {hist}, launches {counts}")
    return {"wall_s": wall, "trials": [[p, v] for _, p, v in hist],
            "best_value": study.best_value, "best_params": study.best_params,
            "launches": counts, "figures": figs.summary()}


# phase 10: the other pose models: configs/posetrack21/
# al_hrnet_posetrack.yaml as the AL loop reads it (HRNet-W32, the stages
# of hrnetw32_posetrack21.yaml:36-57; HRNET_CFG) and configs/posetrack21/
# fastpose_posetrack21.yaml's MODEL (SE-ResNet-50, CONV_DIM 128 by
# default) for FastPose's passes
FASTPOSE_MODEL = FASTPOSE_CFG.get("MODEL")
# (label, MODEL section, K1 launches a scoring pass)
ZOO = (("HRNet-W32", HRNET_CFG.get("MODEL"), 0),
       ("FastPose-R50", FASTPOSE_MODEL, 4))


def make_zoo_model(model_cfg, seed):
    """The estimator of a MODEL section at full width (17 joints,
    fused_eval) through the builder, and a WholeBodyAE (z=4, 38 inputs),
    seeded random weights (randomize_), on the CPU."""
    import torch
    from vatl4pose_tpu_torch.models import WholeBodyAE, build_sppe
    gen = torch.Generator().manual_seed(seed)
    model = randomize_(build_sppe(model_cfg, {"NUM_JOINTS": 17},
                                  fused_eval=True, device="cpu"), gen)
    ae = randomize_(WholeBodyAE(z_dim=4, input_dim=38, device="cpu"), gen)
    return model, ae


def phase_zoo_passes(video, seed):
    """HRNet-W32 and FastPose-R50 (phase 3's video, 512 samples, 256x192,
    seeded random weights): one THC+WPU scoring pass in f32 and one in
    bf16, counters from 0 before each (K3 1, K2 1 and K1 4 for FastPose,
    0 for HRNet, whose builder ignores fused_eval; K5 2 a chunk for
    FastPose's f32 pass, one a DUC, 0 in bf16); warm samples/s
    (median of 3) and a profile of one warm pass, which must run no
    aten::einsum; the first 32 samples' heatmaps and embeddings against
    the same port on the CPU (phase 3's bounds).  FastPose also: one
    VL4Pose pass (one backbone pass a chunk through K1 feeds the head, the
    AuxNet of the seeded default init and the embedding: K1 4, K2 1, K3 1,
    K5 2) and fold_check on its f32 pass (K1 and K5 at most twice cuDNN's
    f32 distance from f64)."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    from vatl4pose_tpu_torch.models import AuxNet
    frame_idx, bboxes = video.args[1], video.args[2]
    n = len(frame_idx)
    out, failed = {}, []

    def one_pass(engine, what, want):
        reset_launch_counts()
        res = engine.score(*video.args)
        torch.cuda.synchronize()
        counts = {k.__name__: k.launches for k in KERNELS}
        log(f"{what}: launches {counts}")
        if counts != want:
            failed.append(f"{what}: launches {counts}, want {want}")
        return res, counts

    for label, mcfg, k1 in ZOO:
        model, ae = make_zoo_model(mcfg, seed)
        model_cpu, ae_cpu = copy.deepcopy(model), copy.deepcopy(ae)
        model.cuda()
        ae.cuda()
        # K5 (FastPose's two DUCs) 2 a chunk of f32, none in bf16
        k5 = 2 * -(-n // BATCH) if k1 else 0
        want = {"fused_bottleneck_chain": k1, "fused_postprocess": 1,
                "rot_warp_crop": 1,
                "deform_im2col": 0, "shuffle_conv3x3": k5}
        r, hms = {}, {}
        for mode in ("f32", "bf16"):
            engine = ScoringEngine(model, ScoringConfig(
                uncertainty="THC+WPU", bf16=mode == "bf16"), ae_model=ae,
                chunk=BATCH)
            res, counts = one_pass(
                engine, f"{label} scoring {mode}",
                dict(want, shuffle_conv3x3=k5 if mode == "f32" else 0))
            check_outputs(res, n)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                engine.score(*video.args, keep_heatmaps=False)
                times.append(time.perf_counter() - t0)
            rate = n / statistics.median(times)
            log(f"{label} scoring {mode}: warm {rate:.1f} samples/s ({n} "
                f"samples, median of 3: {statistics.median(times):.3f} s)")
            einsums = profile_call(
                lambda: engine.score(*video.args, keep_heatmaps=False),
                f"{label} scoring pass {mode}")
            if einsums:
                failed.append(f"{label} {mode}: the pass ran an einsum")
            r[mode] = {"samples_per_s": rate, "launches": counts}
            hms[mode] = (res["heatmaps"][:32].float().cpu(),
                         torch.as_tensor(res["embeddings"][:32]))
            del res
        ref = ScoringEngine(model_cpu, ScoringConfig(uncertainty="THC+WPU"),
                            ae_model=ae_cpu, chunk=32, device="cpu")
        hm_cpu, emb_cpu, _, _ = ref.forward_video(video.frames,
                                                  frame_idx[:32], bboxes[:32])
        for mode, tol in (("f32", 1e-3), ("bf16", 0.25)):
            hm, emb = hms[mode]
            e_hm = ((hm - hm_cpu).abs().max() / hm_cpu.abs().max()).item()
            e_emb = ((emb - emb_cpu).abs().max()
                     / emb_cpu.abs().max()).item()
            log(f"{label} {mode} vs CPU (32 samples): heatmaps max|err|/max "
                f"{e_hm:.3e}, embeddings {e_emb:.3e} (tolerance {tol})")
            r[mode].update(vs_cpu_heatmaps=e_hm, vs_cpu_embeddings=e_emb)
            if not (e_hm <= tol and e_emb <= tol):
                failed.append(f"{label} {mode}: the card disagrees with the "
                              "CPU")
        del ref, model_cpu, ae_cpu
        if k1:
            engine = ScoringEngine(model, ScoringConfig(uncertainty="VL4Pose"),
                                   aux_model=AuxNet(), chunk=BATCH)
            t0 = time.perf_counter()
            res, counts = one_pass(engine, f"{label} VL4Pose", want)
            wall = time.perf_counter() - t0
            if not np.isfinite(res["unc"]).all() or res["unc"].shape != (n,):
                failed.append(f"{label} VL4Pose: unc not finite")
            r["vl4pose"] = {"pass_s": wall, "launches": counts}
            fold = fold_check(model, video, label=f"{label} seeded weights")
            r["fold_check"] = fold
            if not fold["ok"]:
                failed.append(f"{label}: K1 or the fold {fold}")
            del res
        out[label] = r
        del model, ae
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("other models: " + "; ".join(failed))
    return out


def phase_zoo_retrain(video, seed):
    """Each model's retrain (phase 4's: RETRAIN of al_simple_posetrack.
    yaml, batch 120, AdamW with the model's LR groups, 3 epochs = 15
    steps, every crop through K3, counters from 0 before it): ms a step
    (median of epochs 2-3); then FastPose's train step on the card
    against the CPU (phase_step_check)."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    d = video.data
    n = len(d)
    steps_per_epoch = -(-n // RETRAIN["BATCH_SIZE"])
    out = {}
    for label, mcfg, _ in ZOO:
        model = make_zoo_model(mcfg, seed)[0].cuda()
        tr = make_retrainer(model, video, model_type=mcfg["TYPE"])
        walls, curve = [], []
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(RETRAIN_EPOCHS):
            t0 = time.perf_counter()
            curve.append(tr.retrain(d, video.frames_dev, np.arange(n), 1,
                                    (d.width, d.height)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = {k.__name__: k.launches for k in KERNELS}
        steps = RETRAIN_EPOCHS * steps_per_epoch
        ms = statistics.median(walls[1:]) / steps_per_epoch * 1e3
        log(f"{label} retrain: {steps} steps, {ms:.1f} ms/step warm, loss "
            f"and acc by epoch {curve}, launches {counts}")
        want = {"fused_bottleneck_chain": 0, "fused_postprocess": 0,
                "rot_warp_crop": steps,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        if counts != want or not np.isfinite(curve).all():
            raise AssertionError(f"{label} retrain: launches {counts}, want "
                                 f"{want}; curve {curve}")
        out[label] = {"ms_per_step": ms, "steps": steps, "launches": counts}
        del model, tr
        torch.cuda.empty_cache()
    phase_step_check(video, seed, model_cfg=FASTPOSE_MODEL)
    return out


def phase_hrnet_loop(video, card, seed):
    """The port's AL loop on HRNet-W32 through its CLI's functions, as
    phase 5 drives SimplePose: DUW (THC+WPU, Influence, Coreset,
    continual, seedfix, f32) on HRNET_CFG over phase 3's video, from
    seeded weights written as a reference-layout .pth and a seeded AE
    .pth; 9 rounds and the final evaluation.  Checked as phase 5's loop
    (fields, percentages to 100, every sample queried once, a
    cycle_times.jsonl line a cycle), result.json's model, and the
    counters (reset before do_al): K2 once and K3 once a scoring pass, K3
    once an optimizer step, all f32, and K1 never."""
    from vatl4pose_tpu_torch.config import Cfg
    label = "AL loop HRNet-W32"
    n = len(video.data)
    rounds = len(HRNET_CFG["VAL"]["QUERY_RATIO"])
    with tempfile.TemporaryDirectory() as tmp:
        model, ae = make_zoo_model(HRNET_CFG["MODEL"], seed)
        cfg = Cfg(copy.deepcopy(HRNET_CFG))
        write_weights(tmp, cfg, model, ae)
        del model, ae
        on_video_files(video, cfg, tmp, label)
        rj, cycles, counts, by_dtype, calls, loop_s = run_cli_loop(
            cfg, loop_argv(cfg="configs/posetrack21/al_hrnet_posetrack.yaml"),
            tmp, prepare=False, keep="p10_hrnet")
    phase_sums, table, failed = loop_report(label, rj, cycles, counts,
                                            calls, loop_s, n, rounds, card)
    passes, steps = calls.score_calls, calls.train_steps
    want = {"fused_bottleneck_chain": 0, "fused_postprocess": passes,
            "rot_warp_crop": passes + steps,
            "deform_im2col": 0, "shuffle_conv3x3": 0}
    want_dtype = {"fused_bottleneck_chain": {},
                  "rot_warp_crop": {"f32": passes + steps}}
    if passes != rounds + 1 or steps == 0 or counts != want \
            or by_dtype != want_dtype:
        failed.append(f"launches {counts} {by_dtype}, want {want} "
                      f"{want_dtype} for {passes} passes and {steps} steps")
    if rj["model"] != "PoseHighResolutionNet":
        failed.append(f"result.json model {rj['model']}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"loop_s": loop_s, "passes": passes, "train_steps": steps,
            "launches": counts, "phase_s": phase_sums, "rounds": table}


def phase_plain_kernels(seed):
    """The JAX package's plain kernels in eager PyTorch (no hand kernel):
    deform_conv2d v1 and v2 (forward and the gradients of a weighted sum)
    and DeformConv2d at a FastPose DCN stage-2 block's shape, roi_align,
    deform_roi_pool with and without offsets, at the CPU tests' shapes
    (tests/test_torch_plain_kernels.py), on the card against the CPU on
    the same inputs, values within 1e-5 and gradients within 1e-4 of the
    CPU's max magnitude (f32 sums in another order, the gathers' backward
    by atomics; no TF32); each forward's CUDA-event time."""
    import torch
    from vatl4pose_tpu_torch.kernels import (deform_conv2d, deform_roi_pool,
                                             roi_align)
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen)
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    rois = torch.tensor([[0, 1.2, 0.7, 9.5, 7.3], [1, -3.0, -2.5, 4.0, 3.0],
                         [1, 6.0, 5.0, 14.0, 12.5], [0, 4.2, 3.1, 4.6, 3.3],
                         [1, 20.0, 15.0, 24.0, 19.0]])
    cases = {}
    for name, (n, cin, h, w, cout, stride, groups, modulated) in {
            "deform_conv2d_v1": (2, 4, 7, 6, 5, 1, 1, False),
            "deform_conv2d_v2_g2_s2": (2, 4, 7, 6, 5, 2, 2, True),
            "deform_conv2d_fastpose_stage2": (8, 128, 32, 24, 128, 1, 1,
                                              False)}.items():
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        args = [rnd(n, cin, h, w), rnd(n, 18 * groups, ho, wo, lo=-3, hi=3),
                rnd(cout, cin, 3, 3) * (2 / (9 * cin)) ** 0.5]
        if modulated:                                  # the masks, last
            args.append(rnd(n, 9 * groups, ho, wo, lo=0.05, hi=0.95))

        def dcn(x, off, k, *mask, s=stride, g=groups):
            return deform_conv2d(x, off, k, s, 1, *(mask or (None,)), g)
        cases[name] = (dcn, args, rnd(n, cout, ho, wo))
    cases["roi_align"] = (lambda f: roi_align(f, rois, (4, 3), 1.0, 2),
                          [rnd(2, 6, 9, 11)], None)
    for no_trans in (True, False):
        cases[f"deform_roi_pool_{'plain' if no_trans else 'trans'}"] = (
            lambda d, o, nt=no_trans: deform_roi_pool(
                d, rois, o, 0.8, 3, 2, nt, 2, 2, 0.2),
            [rnd(2, 8, 10, 12), rnd(5, 2, 3, 3)], None)
    out, failed = {}, []
    for name, (fn, args, grad_w) in cases.items():
        res = {}
        for dev in ("cpu", "cuda"):
            a = [t.detach().to(dev).requires_grad_(grad_w is not None)
                 for t in args]
            y = fn(*a)
            grads = []
            if grad_w is not None:
                (y * grad_w.to(dev)).sum().backward()
                grads = [t.grad.cpu() for t in a]
            res[dev] = [y.detach().cpu()] + grads
        errs = [((c - g).abs().max() / g.abs().max()).item()
                for g, c in zip(res["cpu"], res["cuda"])]
        with torch.no_grad():
            a = [t.cuda() for t in args]
            ms = cuda_ms(lambda: fn(*a), reps=20)
        log(f"plain kernel {name}: card {ms:.4f} ms at "
            f"{[tuple(t.shape) for t in args]}; card vs CPU max|err|/max "
            f"{errs[0]:.3e}" + (f", gradients {max(errs[1:]):.3e}"
                                 if len(errs) > 1 else ""))
        if errs[0] > 1e-5 or max(errs[1:], default=0.0) > 1e-4:
            failed.append(f"{name}: {errs}")
        out[name] = {"ms": ms, "vs_cpu": max(errs),
                     "shapes": [list(t.shape) for t in args]}
    if failed:
        raise AssertionError("plain kernels, card vs CPU: "
                             + "; ".join(failed))
    return out


# Fast Pose (DCN): AlphaPose's configs/coco/resnet/
# 256x192_res50_lr1e-3_2x-dcn.yaml, FastPose's SE-ResNet-50 with a
# deformable 3x3 in every block of stages 2-4, the strided ones included
# (FALLBACK_ON_STRIDE false): 13 a forward
FASTPOSE_DCN_MODEL = {"TYPE": "FastPose", "NUM_LAYERS": 50,
                      "DCN": {"MODULATED": False, "DEFORM_GROUP": 1,
                              "FALLBACK_ON_STRIDE": False},
                      "STAGE_WITH_DCN": [False, True, True, True]}
DCN_CONVS = 13


def phase_fastpose_dcn(video, seed):
    """Fast Pose (DCN) (phase 3's video, 512 samples, 256x192, seeded
    random weights, the deformable 3x3s' kernels He-scaled too): one
    THC+WPU scoring pass in f32 in chunks of 512 with the counters reset
    just before it (K4 13 a chunk, K1 1 a chunk on stage 1's tail, K5 2
    a chunk, K2 1, K3 1), whose 13 deformable 3x3s' inputs are kept; at
    each of those 13 shapes K4's columns against the eager route's
    (`deform_columns`) bit for bit, at the model's own offsets and at 8
    times them (taps off the maps' edges), K4's time (CUDA events) beside
    the eager route's and K4's bound (bytes: the columns written, the
    input and the offsets read once, over the HBM rate); the pass in
    chunks of 256 (K4 26, K1
    2, K5 4); the pass with the deformable 3x3s on the eager route (K4 0),
    whose heatmaps must equal K4's within 1e-6 of their max magnitude (the
    same columns, the same product), warm samples/s (median of 3); then
    with the DUCs on the eager route too (K5 0), within 1e-4 of K5's."""
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import (KERNELS, DeformConv2d,
                                             deform_columns, deform_im2col,
                                             reset_launch_counts)
    from vatl4pose_tpu_torch.models.layers import DUC
    n = len(video.args[1])
    chunks = -(-n // BATCH)
    failed = []
    model, ae = make_zoo_model(FASTPOSE_DCN_MODEL, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    convs = [m for m in model.modules() if isinstance(m, DeformConv2d)]
    with torch.no_grad():
        for m in convs:
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * (2.0 / m.weight[0].numel()) ** 0.5)
    model.cuda()
    ae.cuda()
    if len(convs) != DCN_CONVS or not all(m.fused_eval for m in convs):
        raise AssertionError(f"{len(convs)} deformable 3x3s, fused_eval "
                             f"{[m.fused_eval for m in convs]}")
    engine = ScoringEngine(model, ScoringConfig(uncertainty="THC+WPU"),
                           ae_model=ae, chunk=BATCH)
    engine.score(*video.args)             # K4 built and every shape met
    kept = []

    def keep(m, args):
        if args[0].shape[0] == BATCH:
            kept.append((m, args[0], args[1]))
    hooks = [m.register_forward_pre_hook(keep) for m in convs]
    reset_launch_counts()
    res = engine.score(*video.args)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in KERNELS}
    for h in hooks:
        h.remove()
    check_outputs(res, n)
    want = {"fused_bottleneck_chain": chunks, "fused_postprocess": 1,
            "rot_warp_crop": 1, "deform_im2col": DCN_CONVS * chunks,
            "shuffle_conv3x3": 2 * chunks}
    log(f"Fast Pose (DCN) scoring f32, chunks of {BATCH}: launches {counts} "
        f"(want {want})")
    if counts != want:
        failed.append(f"launches {counts}, want {want}")
    hm_k4 = res["heatmaps"].float()
    del res

    rows, k4_ms, eager_ms, bound_ms = [], 0.0, 0.0, 0.0
    with torch.no_grad():
        for m, x, off in kept:
            k = m.weight.shape[-1]
            s, g = m.stride, m.deform_groups
            same = [torch.equal(deform_im2col(x, o, k, s, 1, None, g),
                                deform_columns(x, o, k, s, 1, None, g))
                    for o in (off, off * 8)]
            t_k4 = cuda_ms(lambda: deform_im2col(x, off, k, s, 1, None, g),
                           reps=20)
            t_eager = cuda_ms(
                lambda: deform_columns(x, off, k, s, 1, None, g), reps=5)
            N, C, H, W = x.shape
            Ho, Wo = off.shape[-2:]
            t_bound = dcn_bounds.k4_bound_s(
                N, [(C, H, W, Ho, Wo, s, g, False)]) * 1e3
            rows.append({"shape": [N, C, H, W, Ho, Wo, s],
                         "bit_for_bit": same, "ms": t_k4,
                         "eager_ms": t_eager, "bound_ms": t_bound,
                         "mean_abs_offset_px": off.abs().mean().item()})
            k4_ms, eager_ms, bound_ms = (k4_ms + t_k4, eager_ms + t_eager,
                                         bound_ms + t_bound)
            log(f"K4 at {rows[-1]['shape']}: columns bit for bit (offsets, "
                f"x8) {same}, {t_k4:.4f} ms (bound {t_bound:.4f}, eager "
                f"{t_eager:.4f}), mean |offset| "
                f"{rows[-1]['mean_abs_offset_px']:.4f} px")
            if not all(same):
                failed.append(f"K4 columns differ at {rows[-1]['shape']}")
    del kept
    torch.cuda.empty_cache()
    if len(rows) != DCN_CONVS:
        failed.append(f"{len(rows)} deformable 3x3s kept, want {DCN_CONVS}")
    log(f"K4 over the {len(rows)} deformable 3x3s of a chunk of {BATCH}: "
        f"{k4_ms:.3f} ms, bound {bound_ms:.3f} ({bound_ms / k4_ms:.1%}), "
        f"eager route {eager_ms:.3f} ms")

    halves = ScoringEngine(model, ScoringConfig(uncertainty="THC+WPU"),
                           ae_model=ae, chunk=BATCH // 2)
    reset_launch_counts()
    halves.score(*video.args, keep_heatmaps=False)
    torch.cuda.synchronize()
    by_half = {k.__name__: k.launches for k in KERNELS}
    n_half = -(-n // (BATCH // 2))
    log(f"Fast Pose (DCN) scoring f32, chunks of {BATCH // 2}: launches "
        f"{by_half}")
    if (by_half["deform_im2col"], by_half["fused_bottleneck_chain"],
            by_half["shuffle_conv3x3"]) != (DCN_CONVS * n_half, n_half,
                                            2 * n_half):
        failed.append(f"chunks of {BATCH // 2}: launches {by_half}")
    del halves

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.score(*video.args, keep_heatmaps=False)
        times.append(time.perf_counter() - t0)
    rate = n / statistics.median(times)
    for m in convs:
        m.fused_eval = False
    reset_launch_counts()
    res = engine.score(*video.args)
    torch.cuda.synchronize()
    eager_counts = {k.__name__: k.launches for k in KERNELS}
    hm_eager = res["heatmaps"].float()
    del res
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.score(*video.args, keep_heatmaps=False)
        times.append(time.perf_counter() - t0)
    rate_eager = n / statistics.median(times)
    gap = ((hm_k4 - hm_eager).abs().max() / hm_eager.abs().max()).item()
    bit = torch.equal(hm_k4, hm_eager)
    log(f"Fast Pose (DCN) scoring f32: warm {rate:.1f} samples/s through "
        f"K4, {rate_eager:.1f} on the eager route (launches "
        f"{eager_counts}); heatmaps K4 against eager max|err|/max "
        f"{gap:.3e}, bit for bit {bit}")
    if eager_counts["deform_im2col"] or gap > 1e-6 \
            or eager_counts["shuffle_conv3x3"] != 2 * chunks:
        failed.append(f"eager route: launches {eager_counts}, heatmaps "
                      f"{gap:.3e} from K4's")
    # the DUCs on the eager route too: K5 0, the heatmaps within f32
    # summation order of K5's (1e-4 of their max: a wrong column order or
    # store moves them by O(1))
    ducs = [m for m in model.modules() if isinstance(m, DUC)]
    for m in ducs:
        m.fused_eval = False
    reset_launch_counts()
    res = engine.score(*video.args)
    torch.cuda.synchronize()
    eager_duc_counts = {k.__name__: k.launches for k in KERNELS}
    gap_duc = ((hm_eager - res["heatmaps"].float()).abs().max()
               / hm_eager.abs().max()).item()
    del res
    log(f"Fast Pose (DCN) scoring f32, eager DUCs too: launches "
        f"{eager_duc_counts}; heatmaps against K5's max|err|/max "
        f"{gap_duc:.3e}")
    if eager_duc_counts["shuffle_conv3x3"] or len(ducs) != 2 \
            or gap_duc > 1e-4:
        failed.append(f"eager DUCs: launches {eager_duc_counts}, heatmaps "
                      f"{gap_duc:.3e} from K5's")
    del engine, model, ae, hm_k4, hm_eager
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("Fast Pose (DCN): " + "; ".join(failed))
    return {"launches": counts, "launches_halves": by_half,
            "launches_eager": eager_counts, "samples_per_s": rate,
            "samples_per_s_eager": rate_eager, "heatmaps_vs_eager": gap,
            "heatmaps_bit_for_bit": bit, "convs": rows, "k4_ms": k4_ms,
            "eager_ms": eager_ms, "bound_ms": bound_ms,
            "launches_eager_duc": eager_duc_counts,
            "heatmaps_k5_vs_eager_duc": gap_duc}


def pretrain_schedule(epoch):
    """The rate PRETRAIN_TRAIN's schedule gives an epoch: MultiStepLR on
    LR_STEP, restarted on DPG_STEP at DPG_MILESTONE."""
    t = PRETRAIN_TRAIN
    steps = t["DPG_STEP"] if epoch >= t["DPG_MILESTONE"] else t["LR_STEP"]
    return t["LR"] * t["LR_FACTOR"] ** sum(epoch >= m for m in steps)


def eval_heatmaps(model, frames_dev, d, n=32):
    """The first n samples' scoring crops through `model` in eval mode
    (K1 on its tails), on deterministic algorithms."""
    import torch
    from vatl4pose_tpu_torch.ops import crop_batch
    crops = crop_batch(frames_dev, d.frame_idx[:n], d.bboxes[:n],
                       INPUT_SIZE)[0].permute(0, 3, 1, 2)
    was = model.training
    model.eval()
    try:
        with deterministic(), torch.no_grad():
            return model(crops)
    finally:
        model.train(was)


def phase_pretraining(video, card, seed, init_state=None):
    """The pre-training, evaluation and AE-training entry points of a
    user's workflow before the AL loop, through their functions
    (PRETRAIN_CFG: the config file with its CONFIG_CUTS):
      - posetrack_train.train at full width on phase 3's video (512
        samples, frames on the card, K3 once an optimizer step at batch
        180), PRETRAIN_TRAIN's cut schedule with its DPG stage, from
        `init_state` (phase 7's pre-trained weights) as MODEL.PRETRAINED;
        checked:
        every epoch's rate is the schedule's, the loss finite every epoch
        and lower at the last than at the first, K3 launched once a step,
        every validate_gt pass K1 4, K2 1 and K3 1, the checkpoints
        written, model_best.pth and the last model_{epoch}.pth loaded
        strictly into a fresh SimplePose give heatmaps (32 samples) bit-
        equal to the model's in memory at those epochs; printed: ms a step
        (CUDA events, warm), each epoch's wall, each validation's wall and
        AP, the device time by kernel of one profiled epoch;
      - the streaming branch: train on a three-size make_synthetic_multivideo
        set (240 samples), which forces the host-RAM frames and host-warp
        crops; checked: it streams, K3 never launches, the loss is finite;
        printed: the host warp's ms a batch, the device time by kernel of
        a profiled epoch;
      - jrdbpose_train's guard refuses the Posetrack21 set;
      - poseestimator_eval.validate on model_best.pth with the video as
        its TEST split; checked: its AP equals validate_gt's on the same
        weights, predicted_kpt_TEST.json holds one entry a sample with a
        finite OKS, K1 4, K2 1 and K3 1; printed: samples/s;
      - wholebodyAE_train.train_ae on the Wholebody features of the
        video's annotation (validation: the multi-video set's), z 4, batch
        10000, AE_PRETRAIN_EPOCHS; checked: finite losses, the best
        checkpoint written;
      - the hand-off: ActiveLearning's own loaders read model_best.pth and
        the AE checkpoint; one THC+WPU scoring pass of its engine equals
        (every output) the same pass from the models in memory.
    Returns the numbers and the launches of each path."""
    import argparse
    import os
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ActiveLearning, ScoringEngine
    from vatl4pose_tpu_torch.cli import jrdbpose_train, poseestimator_eval
    from vatl4pose_tpu_torch.cli import posetrack_train as pt
    from vatl4pose_tpu_torch.cli import wholebodyAE_train as ae_cli
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.data import (Wholebody, build_dataset,
                                          make_synthetic_multivideo)
    from vatl4pose_tpu_torch.data.stream import CropStreamer
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    from vatl4pose_tpu_torch.models import SimplePose
    from vatl4pose_tpu_torch.models.convert import read_weights
    from vatl4pose_tpu_torch.train import Retrainer

    failed, out = [], {}
    root, ann = video.root, video.ann
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Cfg(copy.deepcopy(PRETRAIN_CFG))
        if init_state is not None:
            cfg.MODEL.PRETRAINED = f"{tmp}/init.pth"
            torch.save(init_state, cfg.MODEL.PRETRAINED)
        for split in ("TRAIN", "TEST"):
            cfg.DATASET[split].update(ROOT=root, ANN=ann)
        work = f"{tmp}/pretrain"
        opt = argparse.Namespace(seed=seed, snapshot=PRETRAIN_SNAPSHOT,
                                 epochs_override=None, work_dir=work,
                                 stream=False, launcher="none", device=None)

        # ---- resident pre-training ---------------------------------------
        passes, events = [], []

        def recorded(validate):
            def run(cfg_, model, *a, **kw):
                torch.cuda.synchronize()
                before, t0 = launch_counts(), time.perf_counter()
                ap = validate(cfg_, model, *a, **kw)
                torch.cuda.synchronize()
                passes.append({
                    "ap": ap, "wall_s": time.perf_counter() - t0,
                    "launches": {k: v - before[k]
                                 for k, v in launch_counts().items()},
                    "state": {k: v.detach().clone()
                              for k, v in model.state_dict().items()}})
                return ap
            return run

        def timed(step):
            def run(self, *a, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = step(self, *a, **kw)
                ev[1].record()
                events.append(ev)
                return res
            return run

        with patched(pt, "validate_gt", recorded), \
                patched(Retrainer, "train_step", timed):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            model, history = pt.train(cfg, opt)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = launch_counts()
        label = "pretraining"
        ds = build_dataset(cfg.DATASET.TRAIN)
        steps = len(events)
        step_ms = [a.elapsed_time(b) for a, b in events]
        per_epoch = steps // len(history)
        for h in history:
            if h["epoch"] and "ap" not in h:
                continue
            log(f"{label} epoch {h['epoch']}: lr {h['lr']:.1e} loss "
                f"{h['loss']:.6f} acc {h['acc']:.4f} wall {h['wall_s']:.3f} "
                f"s" + (f", validate_gt AP {h['ap']:.4f}" if "ap" in h
                        else ""))
        for p in passes:
            log(f"{label}: validate_gt pass {p['wall_s']:.3f} s "
                f"({len(ds) / p['wall_s']:.1f} samples/s), AP "
                f"{p['ap']:.4f}, launches {p['launches']}")
        warm = statistics.median(step_ms[per_epoch:])
        log(f"{label}: {len(history)} epochs, {steps} optimizer steps at "
            f"batch {PRETRAIN_TRAIN['BATCH_SIZE']} in {train_s:.2f} s; warm "
            f"step {warm:.1f} ms (median of steps {per_epoch + 1}-{steps}, "
            f"CUDA events); launches {counts}; {card}")
        want_lr = [pretrain_schedule(h["epoch"]) for h in history]
        if [h["lr"] for h in history] != want_lr:
            failed.append(f"rates {[h['lr'] for h in history]}, schedule "
                          f"{want_lr}")
        losses = [h["loss"] for h in history]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            failed.append(f"losses {losses}")
        k3_passes = sum(p["launches"]["rot_warp_crop"] for p in passes)
        if counts["rot_warp_crop"] - k3_passes != steps:
            failed.append(f"K3 {counts['rot_warp_crop']} launches for "
                          f"{steps} steps and {len(passes)} passes")
        want_pass = {"fused_bottleneck_chain": 4, "fused_postprocess": 1,
                     "rot_warp_crop": 1,
                     "deform_im2col": 0, "shuffle_conv3x3": 0}
        if not passes or any(p["launches"] != want_pass for p in passes):
            failed.append(f"validate_gt launches "
                          f"{[p['launches'] for p in passes]}")
        aps = [p["ap"] for p in passes]
        best = int(np.argmax(aps)) if aps and max(aps) > 0 else None
        files = sorted(os.listdir(work))
        want_files = [f"model_{h['epoch']}.pth" for h in history
                      if "ap" in h] + ["model_best.pth"] * (best is not None)
        if sorted(want_files) != files:
            failed.append(f"checkpoints {files}, want {sorted(want_files)}")
        frames_dev = video.frames_dev
        # the checkpoints against the model in memory at their epochs
        bit_equal = {}
        for name, p in ((f"model_{history[-1]['epoch']}.pth", passes[-1]),
                        ("model_best.pth",
                         passes[best] if best is not None else None)):
            if p is None:
                continue
            fresh = SimplePose(**MODEL, fused_eval=True, device="cpu")
            fresh.load_state_dict(read_weights(f"{work}/{name}",
                                               "SimplePose"))
            model.load_state_dict(p["state"])
            bit_equal[name] = bool(torch.equal(
                eval_heatmaps(fresh.cuda(), frames_dev, ds.data),
                eval_heatmaps(model, frames_dev, ds.data)))
        log(f"{label}: checkpoints {files}; heatmaps of 32 samples from "
            f"the file bit-equal to the model in memory: {bit_equal}")
        if not all(bit_equal.values()) or "model_best.pth" not in bit_equal:
            failed.append(f"checkpoints vs memory {bit_equal}")
        # one more epoch of a fresh trainer, profiled
        _, trainer = pt.build_trainer(cfg, ds, seed, None)
        idx = np.arange(len(ds))
        profile_call(
            lambda: trainer.retrain(ds.data, frames_dev, idx, 1,
                                    (ds.data.width, ds.data.height)),
            f"{label} epoch (batch {PRETRAIN_TRAIN['BATCH_SIZE']}, "
            f"{per_epoch} steps)")
        del trainer
        out["resident"] = {
            "epochs": len(history), "steps": steps, "train_s": train_s,
            "ms_per_step": warm, "epoch_wall_s": [h["wall_s"]
                                                  for h in history],
            "lr": [h["lr"] for h in history], "loss": losses,
            "acc": [h["acc"] for h in history],
            "validate": [{k: p[k] for k in ("ap", "wall_s")}
                         for p in passes],
            "best_epoch": history[[i for i, h in enumerate(history)
                                   if "ap" in h][best]]["epoch"]
            if best is not None else None,
            "checkpoints_bit_equal": bit_equal,
            "launches": counts}

        # ---- the streaming branch ------------------------------------------
        sroot, sann = make_synthetic_multivideo(
            f"{tmp}/multi", seed=seed, **PRETRAIN_STREAM_SET)
        scfg = Cfg(copy.deepcopy(PRETRAIN_CFG))
        scfg.DATASET.TRAIN.update(ROOT=sroot, ANN=sann)
        scfg.TRAIN.update(END_EPOCH=PRETRAIN_STREAM_EPOCHS, LR_STEP=[])
        scfg.TRAIN.pop("DPG_MILESTONE")
        sopt = argparse.Namespace(**dict(vars(opt), work_dir=f"{tmp}/stream",
                                         snapshot=PRETRAIN_STREAM_EPOCHS))
        modes = []

        def noted(method):
            def run(self, *a, **kw):
                modes.append(method.__name__)
                return method(self, *a, **kw)
            return run
        with CallLog() as calls, \
                patched(Retrainer, "retrain", noted), \
                patched(Retrainer, "retrain_streaming", noted):
            reset_launch_counts()
            t0 = time.perf_counter()
            _, shistory = pt.train(scfg, sopt)
            torch.cuda.synchronize()
            stream_s = time.perf_counter() - t0
            scounts = launch_counts()
        sds = build_dataset(scfg.DATASET.TRAIN)
        train_warps = [t for k, t in calls.host_warps
                       if k <= PRETRAIN_TRAIN["BATCH_SIZE"]]
        warp_ms = 1e3 * statistics.median(train_warps) if train_warps \
            else None
        log(f"{label}, streaming branch: {len(sds)} samples of "
            f"{len(np.unique(sds.data.frame_sizes, axis=0))} frame sizes, "
            f"{len(shistory)} epochs in {stream_s:.2f} s ({modes}); losses "
            f"{[h['loss'] for h in shistory]}; host warp "
            f"{len(train_warps)} batches, median {warp_ms} ms each (host "
            f"clock); launches {scounts}")
        if not (sds.data.mixed_sizes and modes == ["retrain_streaming"]
                * PRETRAIN_STREAM_EPOCHS and scounts["rot_warp_crop"] == 0
                and np.isfinite([h["loss"] for h in shistory]).all()):
            failed.append(f"streaming branch: modes {modes}, launches "
                          f"{scounts}, losses {shistory}")
        _, strainer = pt.build_trainer(scfg, sds, seed, None)
        streamer = CropStreamer(sds.data, sds.frame_store(),
                                strainer.input_size, strainer.aug,
                                sds.joint_pairs, strainer.batch_size,
                                seed=seed)
        profile_call(
            lambda: strainer.retrain_streaming(streamer, np.arange(len(sds)),
                                               1),
            f"{label} streamed epoch")
        del strainer, streamer
        out["streaming"] = {
            "samples": len(sds), "epochs": len(shistory),
            "wall_s": stream_s, "loss": [h["loss"] for h in shistory],
            "host_warp_ms_per_batch": warp_ms,
            "launches": scounts}

        # ---- jrdbpose_train's guard ------------------------------------------
        try:
            jrdbpose_train.check_jrdb(cfg)
            failed.append("jrdbpose_train accepted a Posetrack21 set")
        except AssertionError as e:
            log(f"jrdbpose_train refuses a Posetrack21 set: {e}")

        # ---- evaluation --------------------------------------------------------
        best_path = f"{work}/model_best.pth"
        if best is not None:
            emodel = poseestimator_eval.load_model(cfg, best_path)
            evals = []
            for _ in range(2):
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                res, kpt_json = poseestimator_eval.validate(cfg, emodel,
                                                            "TEST")
                torch.cuda.synchronize()
                evals.append((time.perf_counter() - t0, launch_counts()))
            os.makedirs(f"{tmp}/eval", exist_ok=True)
            with open(f"{tmp}/eval/predicted_kpt_TEST.json", "w") as f:
                json.dump(kpt_json, f)
            with open(f"{tmp}/eval/predicted_kpt_TEST.json") as f:
                written = json.load(f)
            n = len(ds)
            ecounts = evals[0][1]
            log(f"poseestimator_eval.validate on model_best.pth: AP "
                f"{res['AP']:.4f} (validate_gt's {aps[best]:.4f}), AP.5 "
                f"{res['AP .5']:.4f}; {n} samples in {evals[0][0]:.3f} s "
                f"cold, {evals[1][0]:.3f} s warm ({n / evals[1][0]:.1f} "
                f"samples/s, the annotation and frames read from disk "
                f"included); launches {ecounts}")
            if res["AP"] != aps[best]:
                failed.append(f"eval AP {res['AP']} != validate_gt's "
                              f"{aps[best]}")
            if len(written) != n or not all(
                    np.isfinite(e["OKS"]) for e in written):
                failed.append(f"predicted_kpt_TEST.json: {len(written)} "
                              f"entries for {n} samples")
            if ecounts != want_pass:
                failed.append(f"eval launches {ecounts}")
            out["eval"] = {"ap": res["AP"], "wall_s": evals[1][0],
                           "samples_per_s": n / evals[1][0],
                           "launches": ecounts}
            del emodel

        # ---- the AE ------------------------------------------------------------
        wb_train = Wholebody(f"{root}/{ann}", "Posetrack21")
        wb_val = Wholebody(f"{sroot}/{sann}", "Posetrack21")
        aopt = ae_cli.parse_args([
            "--ann_train", f"{root}/{ann}", "--ann_val", f"{sroot}/{sann}",
            "--epochs", str(AE_PRETRAIN_EPOCHS),
            "--work_dir", f"{tmp}/ae/Hybrid"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ae, ae_log, ae_best = ae_cli.train_ae(aopt, wb_train.features,
                                              wb_val.features)
        torch.cuda.synchronize()
        ae_s = time.perf_counter() - t0
        ae_losses = [[e["train_loss"], e["val_loss"]] for e in ae_log]
        log(f"wholebodyAE_train: {len(wb_train)} training and "
            f"{len(wb_val)} validation features, {len(ae_log)} epochs in "
            f"{ae_s:.3f} s ({1e3 * ae_s / len(ae_log):.2f} ms an epoch), "
            f"best epoch {ae_best}, val loss {ae_log[0]['val_loss']:.6f} -> "
            f"{ae_log[ae_best]['val_loss']:.6f}")
        ae_path = f"{tmp}/ae/Hybrid/WholeBodyAE_zdim4.pth"
        if not (np.isfinite(ae_losses).all() and os.path.exists(ae_path)):
            failed.append(f"AE: losses {ae_losses}, checkpoint "
                          f"{os.path.exists(ae_path)}")
        out["ae"] = {"epochs": len(ae_log), "wall_s": ae_s,
                     "ms_per_epoch": 1e3 * ae_s / len(ae_log),
                     "best_epoch": ae_best,
                     "val_loss": [ae_log[0]["val_loss"],
                                  ae_log[ae_best]["val_loss"]]}

        # ---- the hand-off to the AL loop -------------------------------------
        if best is not None:
            hcfg = Cfg(copy.deepcopy(AL_CFG))
            for split in ("TRAIN", "EVAL"):
                hcfg.DATASET[split].update(ROOT=root, ANN=ann)
            hcfg.MODEL.PRETRAINED = best_path
            hcfg.AE.PRETRAINED_ROOT = f"{tmp}/ae"
            argv = ["--cfg", "configs/posetrack21/al_simple_posetrack.yaml",
                    "--video_id", "000001", "--uncertainty", "THC+WPU",
                    "--representativeness", "Influence", "--filter",
                    "Coreset", "--continual", "--seedfix", "--memo",
                    "chip_smoke_handoff"]
            os.makedirs(f"{tmp}/al")
            with cli_workdir(hcfg, argv, f"{tmp}/al", prepare=False) as \
                    (hcfg, hopt):
                al = ActiveLearning(hcfg, hopt)
            d = al.data
            args = (d.frame_idx, d.bboxes, d.gt_keypoints,
                    np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                              d.bboxes[:, 2] - d.bboxes[:, 0],
                              d.bboxes[:, 3] - d.bboxes[:, 1]], 1),
                    d.is_prev, d.is_next)
            model.load_state_dict(passes[best]["state"])
            mine = ScoringEngine(model, al.engine.cfg, ae_model=ae,
                                 chunk=al.engine.chunk)
            reset_launch_counts()
            with deterministic():
                res_al = al.engine.score(al.frames_dev, *args)
                res_mem = mine.score(al.frames_dev, *args)
            torch.cuda.synchronize()
            hcounts = launch_counts()
            differ = [k for k in res_mem if not (
                torch.equal(res_al[k], res_mem[k]) if k == "heatmaps"
                else np.array_equal(res_al[k], res_mem[k]))]
            log(f"hand-off: ActiveLearning loaded {best_path} and "
                f"{ae_path}; its THC+WPU pass against the models in memory: "
                f"{'equal' if not differ else 'apart in ' + str(differ)} "
                f"(every output); launches of the two passes {hcounts}")
            if differ:
                failed.append(f"hand-off: passes apart in {differ}")
            check_outputs(res_al, len(d))
            out["handoff"] = {"equal": not differ, "launches": hcounts}
            del al, mine
        else:
            failed.append("no validate_gt pass reached an AP above 0: no "
                          "model_best.pth to evaluate and hand off")
        del model, frames_dev
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return out


# phase 12: the analysis and tracking-evaluation CLIs and the --vis paths.
# The loops whose result.json the analysis CLIs read (phases 5, 6, 9, 10
# and 12's --vis loop) and the two whose predictions the tracking
# evaluation reads (5 and 12)
ANALYSIS_RUNS = ("p5", "p6_speedup", "p9_mpe", "p9_vl4pose", "p10_hrnet",
                 "p12_vis")
TRACKING_RUNS = ("p5", "p12_vis")
# heatmaps decoded on the host against the round's predictions: the JAX
# package's bounds (phase 7's), on more than this share of values
VIS_KPTS_SHARE = 0.99


def decode_maps(hms, bboxes):
    """Heatmaps (N, K, h, w) decoded on the host as the post-process
    kernel's plain version decodes them (argmax, the ±0.25 shift), through
    the scoring crop's inverse geometry: (N, 3K) kpts as the loop's
    predictions hold them."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.data.pipeline import eval_sample_geometry
    from vatl4pose_tpu_torch.ops import (crop_to_image, get_max_pred,
                                         subpixel_refine)
    hm = torch.from_numpy(np.asarray(hms, np.float32))
    _, bbox_crop = eval_sample_geometry(np.asarray(bboxes, np.float32),
                                        INPUT_SIZE)
    coords, scores = get_max_pred(hm)
    coords = crop_to_image(subpixel_refine(hm, coords),
                           torch.from_numpy(bbox_crop),
                           (hm.shape[-1], hm.shape[-2]))
    return torch.cat([coords, scores[..., None]], -1).reshape(
        len(hm), -1).numpy()


def phase_vis_loop(video, card, seed, al):
    """The DUW loop with --vis through the CLI's functions, as phase 5
    drives it (AL_CFG, phase 3's video and seeded weights, f32, the main
    path's flags, --filter Coreset included, 9 rounds and the final
    evaluation), with matplotlib, cv2 and PIL refused: --vis draws
    Coreset's cluster figure every round through the port's figure layer.
    Checked: one cluster figure a round with a non-empty query, each a PNG
    that image_io reads back at 640x480, not one colour, with the red of
    the query markers; and as phase 5's loop (fields, every sample queried once, K1 4x,
    K2 1x and K3 1x a pass, K3 once a step, all f32), and every pass's
    dumps: heatmap/Round{r}/heatmaps.npy (N, 17, 64, 48) float16, bit for
    bit the pass's f32 heatmaps rounded to float16 (each pass's heatmaps
    are kept on the card by a wrapper of ScoringEngine.score); its
    ann_ids.npy the video's; prediction/Round{r}/predicted_kpt.json the
    round's predictions, which the pass's f32 heatmaps, decoded on the
    host (decode_maps), hold to the JAX package's bounds (rtol 2e-2, atol
    1 px) on more than VIS_KPTS_SHARE of the values.  The share that the
    float16 dumps decoded the same way reach is printed beside it: on
    near-flat maps float16 rounding moves the argmax to another of
    several near-equal maxima.  The loop's wall and split are printed
    beside phase 5's (`al`)."""
    import os
    import numpy as np
    from vatl4pose_tpu_torch.al import scoring
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.utils import vis as vis_mod
    label = "AL loop --vis"
    d = video.data
    n = len(d)
    rounds = len(AL_CFG["VAL"]["QUERY_RATIO"])
    with tempfile.TemporaryDirectory() as tmp:
        model, ae = make_models(seed)
        cfg = Cfg(copy.deepcopy(AL_CFG))
        write_weights(tmp, cfg, model, ae)
        del model, ae
        on_video_files(video, cfg, tmp, label)
        argv = loop_argv(extra=["--vis"])
        passes_hms = []

        def keeping(score):
            def wrapper(*a, **kw):
                res = score(*a, **kw)
                passes_hms.append(res["heatmaps"])
                return res
            return wrapper
        with patched(scoring.ScoringEngine, "score", keeping), \
                refusing(), FigureTimes(vis_mod, (
                    "plot_embedding_selection",)) as figs:
            rj, cycles, counts, by_dtype, calls, loop_s = run_cli_loop(
                cfg, argv, tmp, prepare=False, keep="p12_vis")
        phase_sums, table, failed = loop_report(
            label, rj, cycles, counts, calls, loop_s, n, rounds, card)
        passes, steps = calls.score_calls, calls.train_steps
        want = {"fused_bottleneck_chain": 4 * passes,
                "fused_postprocess": passes, "rot_warp_crop": passes + steps,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        want_dtype = {"fused_bottleneck_chain": {"f32": 4 * passes},
                      "rot_warp_crop": {"f32": passes + steps}}
        if passes != rounds + 1 or steps == 0 or counts != want \
                or by_dtype != want_dtype:
            failed.append(f"launches {counts} {by_dtype}, want {want} "
                          f"{want_dtype} for {passes} passes and {steps} "
                          f"steps")
        work_dir = KEPT.loops["p12_vis"]["work_dir"]
        # the cluster figures: one a round that queried
        queried = sum(1 for q in rj["query_list"].values() if len(q))
        cdir = os.path.join(work_dir, "cluster")
        names = sorted(os.listdir(cdir)) if os.path.isdir(cdir) else []
        red = []
        for name in names:
            img = png_pixels(os.path.join(cdir, name), (640, 480))
            red.append(int((img == (255, 0, 0)).all(2).sum()))
        if len(names) != queried or not all(
                x.startswith("Coreset_round") for x in names) \
                or min(red, default=0) == 0:
            failed.append(f"cluster figures {names} (red pixels {red}), "
                          f"want one for each of {queried} queried rounds")
        log(f"{label}: {len(names)} cluster figures (Coreset), 640x480, "
            f"query-marker red pixels {red}; host ms a figure "
            + json.dumps(figs.summary()))
        # what the analysis phase renders: the final predictions, round
        # 0's dumps and the cluster figures
        keep = KEPT.root / "p12_work"
        (keep / "heatmap").mkdir(parents=True)
        shutil.copytree(os.path.join(work_dir, "heatmap", "Round0"),
                        keep / "heatmap" / "Round0")
        shutil.copy(os.path.join(work_dir, "predicted_kpt.json"), keep)
        if names:
            shutil.copytree(cdir, keep / "cluster")
        dumped, shares, shares16, exact = 0, [], [], []
        for r in range(passes):
            hm_dir = os.path.join(work_dir, "heatmap", f"Round{r}")
            pred = os.path.join(work_dir, "prediction", f"Round{r}",
                                "predicted_kpt.json")
            files = [os.path.join(hm_dir, f)
                     for f in ("heatmaps.npy", "ann_ids.npy")] + [pred]
            if not all(os.path.exists(f) for f in files):
                failed.append(f"Round{r}: dumps missing")
                continue
            dumped += sum(os.path.getsize(f) for f in files)
            hms = np.load(files[0])
            ann_ids = np.load(files[1])
            entries = json.load(open(pred))
            if hms.dtype != np.float16 or hms.shape != (n, 17) + HM_SIZE \
                    or not np.isfinite(hms).all():
                failed.append(f"Round{r}: heatmaps {hms.dtype} {hms.shape}")
                continue
            if not np.array_equal(ann_ids, d.ann_ids) \
                    or [e["id"] for e in entries] != d.ann_ids.tolist():
                failed.append(f"Round{r}: ann ids differ from the video's")
                continue
            kpts = np.array([e["keypoints"] for e in entries])
            hm32 = passes_hms[r].float().cpu().numpy()
            exact.append(np.array_equal(hms.view(np.uint16), hm32.astype(
                np.float16).view(np.uint16)))
            for maps, out in ((hm32, shares), (hms, shares16)):
                out.append(float(np.isclose(decode_maps(maps, d.bboxes),
                                            kpts, rtol=2e-2,
                                            atol=1.0).mean()))
        del passes_hms
        log(f"{label}: {passes} passes dumped {dumped / 1e6:.1f} MB "
            f"(heatmaps float16, ann ids, predictions); the dumps are the "
            f"passes' f32 heatmaps rounded to float16 bit for bit: {exact}; "
            f"each round's predicted kpts within (rtol 2e-2, atol 1 px) of "
            f"the pass's f32 heatmaps decoded on the host: "
            f"{[round(x, 5) for x in shares]} (bar > {VIS_KPTS_SHARE}), of "
            f"the float16 dumps decoded: {[round(x, 5) for x in shares16]}")
        if len(exact) != passes or not all(exact):
            failed.append(f"dumps vs the passes' heatmaps {exact}")
        if len(shares) != passes or min(shares) <= VIS_KPTS_SHARE:
            failed.append(f"decoded heatmaps vs predictions {shares}")
    log(f"{label} wall and split, s: " + json.dumps(
        dict(phase_sums, wall=loop_s)) + "; phase 5's in this call: "
        + json.dumps(dict(al["phase_s"], wall=al["loop_s"]))
        + f"; {card}")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"loop_s": loop_s, "passes": passes, "train_steps": steps,
            "launches": counts, "phase_s": phase_sums, "rounds": table,
            "dumped_bytes": dumped, "decoded_kpts_share": shares,
            "decoded_dump_kpts_share": shares16,
            "cluster_figures": figs.summary()}


def phase_vis_hooks(video, seed):
    """The arrays the --vis_thc and --vis_wpu hooks draw, on the card: a
    phase-3 THC+WPU pass over the 512 samples with keep_heatmaps (the
    counters reset before it and read after), then vis_thc_inputs on its
    heatmaps and vis_wpu_inputs on its decoded keypoints with the AE on
    the card.  Checked: vis_thc_inputs takes the samples with both
    neighbours, their middle stack is the kept heatmaps at eval_joints bit
    for bit and the outer ones the neighbours'; each sample's
    reconstruction MSE from vis_wpu_inputs is the pass's WPU within 1e-5
    relative (the JAX hook calls compute_hybrid with its defaults, the
    scorer with ScoringConfig.hybrid_drop_ears, True for both here)."""
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.al.active_learning import (vis_thc_inputs,
                                                        vis_wpu_inputs)
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts
    d = video.data
    model, ae = make_models(seed)
    model.cuda()
    ae.cuda()
    cfg = ScoringConfig(uncertainty="THC+WPU", input_size=INPUT_SIZE)
    engine = ScoringEngine(model, cfg, ae_model=ae, chunk=BATCH)
    reset_launch_counts()
    res = engine.score(*video.args, keep_heatmaps=True)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in KERNELS}
    check_scoring_launches(counts, "the hooks' pass")
    failed = []
    t0 = time.perf_counter()
    thc = vis_thc_inputs(res["heatmaps"], cfg.eval_joints, d.is_prev,
                         d.is_next, d.ann_ids, res["unc"])
    thc_s = time.perf_counter() - t0
    kept = res["heatmaps"][:, list(cfg.eval_joints)].cpu().numpy()
    both = [j for j in range(len(d)) if d.is_prev[j] and d.is_next[j]]
    if [a for a, *_ in thc] != [int(d.ann_ids[j]) for j in both]:
        failed.append("vis_thc_inputs took other samples than those with "
                      "both neighbours")
    exact = all(np.array_equal(cur, kept[j])
                and np.array_equal(prev, kept[j - 1])
                and np.array_equal(nxt, kept[j + 1])
                and score == float(res["unc"][j])
                for j, (_, prev, cur, nxt, score) in zip(both, thc))
    if not exact:
        failed.append("vis_thc_inputs' stacks are not the kept heatmaps")
    t0 = time.perf_counter()
    ann_ids, feats, recon, wpu = vis_wpu_inputs(
        ae, res["bbox_crop"], res["kpts"], d.ann_ids, res["unc2"],
        next(ae.parameters()).device)
    torch.cuda.synchronize()
    wpu_s = time.perf_counter() - t0
    mse = np.mean((recon.astype(np.float64) - feats) ** 2, axis=1)
    rel = np.abs(mse - wpu) / np.abs(wpu)
    log(f"--vis_thc inputs: {len(thc)} of {len(d)} samples have both "
        f"neighbours, stacks {thc[0][2].shape} equal to the kept heatmaps "
        f"bit for bit: {exact} ({thc_s * 1e3:.1f} ms); --vis_wpu inputs: "
        f"features {feats.shape}, reconstruction MSE vs the pass's WPU "
        f"max relative {rel.max():.3e} (bar 1e-5; WPU {wpu.min():.4g}.."
        f"{wpu.max():.4g}; {wpu_s * 1e3:.1f} ms on the card); launches "
        f"{counts}")
    if not (rel.max() <= 1e-5) or not np.array_equal(ann_ids, d.ann_ids):
        failed.append(f"vis_wpu_inputs' MSE vs WPU {rel.max():.3e}")
    del engine, model, ae, res
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("vis hooks: " + "; ".join(failed))
    return {"launches": counts, "thc_samples": len(thc),
            "wpu_mse_rel_err": float(rel.max()), "thc_ms": 1e3 * thc_s,
            "wpu_ms": 1e3 * wpu_s}


def finite(*xs):
    import math
    return all(math.isfinite(x) for x in xs)


def phase_analysis(source, card):
    """The analysis CLIs over the kept loops' result.json (ANALYSIS_RUNS,
    laid out by KEPT.exp_tree): summarize_result.main, detailed_result's
    collect, metric_json and summarize_sc, and wacv_result's latex_table;
    then, with matplotlib, cv2 and PIL refused, the figures:
    detailed_result.main and wacv_result.main (PNG and PDF),
    visualize_result.main --heatmaps on phase 12's work directory (a
    skeleton PNG a frame, round 0's heatmap grids) and convert_to_eps.main
    on the figure directory.  Checked: a row a strategy, every ALC finite,
    each run's 1001-point curve ending at its loop's last AP (raw and with
    annotations), a LaTeX row a strategy; every PNG read back, not one
    colour; every PDF parsed (xref, MediaBox 460.8 x 345.6, its image
    inflated); every EPS's hex body decoded to its PNG's pixels; a
    skeleton PNG a predicted frame at the frame's size."""
    import os
    from vatl4pose_tpu_torch.cli import (detailed_result, summarize_result,
                                         wacv_result)
    t0 = time.perf_counter()
    root, where = KEPT.exp_tree(ANALYSIS_RUNS)
    strategies = {s for s, _ in where.values()}
    out = summarize_result.main(["--exp_root", str(root), "--out",
                                 str(KEPT.root / "summary.json")])
    rd, empty = detailed_result.collect(str(root), sc_thresh="AP .75")
    mj = {m: detailed_result.metric_json(rd, m)
          for m in detailed_result.DEFAULT_METRICS}
    sc = detailed_result.summarize_sc(rd)
    tex = wacv_result.latex_table(summarize_result.summarize(str(root)))
    wall = time.perf_counter() - t0
    failed = []
    if set(out["alc"]) != strategies or set(rd) != strategies \
            or set(sc) != strategies:
        failed.append(f"strategies {sorted(out['alc'])}, want "
                      f"{sorted(strategies)}")
    alcs = [v["mean_ALC"] for v in out["alc"].values()] + [
        x for d in rd.values() for m in detailed_result.DEFAULT_METRICS
        for k in (f"{m}_ALC", f"{m}_ALC_ann") for x in d[k].values()] + [
        e[f"{m}_ALC"] for m, v in mj.items() for e in v.values()]
    if not finite(*alcs):
        failed.append(f"an ALC is not finite: {alcs}")
    ends = {}
    for tag, (strategy, video) in where.items():
        rj = json.load(open(KEPT.loops[tag]["dir"] / "result.json"))
        got = (rd[strategy]["AP"][video][-1],
               rd[strategy]["AP_ann"][video][-1])
        want = (rj["performances"][-1]["AP"] * 100,
                rj["performances_ann"][-1]["AP"] * 100)
        ends[tag] = got
        if any(abs(g - w) > 1e-9 for g, w in zip(got, want)):
            failed.append(f"{tag}: curve ends {got}, last AP {want}")
    body = tex.split(r"\midrule")[1].split(r"\bottomrule")[0]
    rows = [line for line in body.splitlines() if line.strip()]
    if len(rows) != len(strategies):
        failed.append(f"LaTeX table rows {len(rows)}")
    log(f"analysis CLIs over {len(where)} card loops' result.json, "
        f"{len(strategies)} strategies: summarize_result ALC "
        + json.dumps({k: round(v["mean_ALC"], 6)
                      for k, v in out["alc"].items()})
        + "; collect curves' last points (AP, AP ann) "
        + json.dumps({k: [round(x, 4) for x in v] for k, v in ends.items()})
        + f"; empty ids {empty['union']}; SC "
        + json.dumps(sc) + f"; LaTeX rows {len(rows)}; {wall:.3f} s host; "
        f"{card}")
    if not os.path.exists(KEPT.root / "summary.json"):
        failed.append("summarize_result wrote no --out")
    figures = analysis_figures(source, root, failed)
    log(f"analysis figures (host s, counts): {json.dumps(figures)}; {card}")
    if failed:
        raise AssertionError("analysis CLIs: " + "; ".join(failed))
    return {"wall_s": wall, "alc": {k: v["mean_ALC"]
                                    for k, v in out["alc"].items()},
            "curve_ends": ends, "sc": sc, "latex_rows": len(rows),
            "figures": figures}


def analysis_figures(source, root, failed):
    """phase_analysis's figures (see there), phase 12's frames read from
    the video `source`; appends to `failed`.
    Returns each step's host s and what it wrote."""
    import numpy as np
    from vatl4pose_tpu_torch.cli import (convert_to_eps, detailed_result,
                                         visualize_result, wacv_result)
    from vatl4pose_tpu_torch.data.image_io import read_images
    ana, figs, vis = (KEPT.root / x for x in ("analysis", "figures", "vis"))
    out, t0 = {}, time.perf_counter()
    with refusing():
        detailed_result.main(["--exp_root", str(root), "--out_dir",
                              str(ana)])
        out["detailed_result_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wacv_result.main(["--exp_root", str(root), "--out_dir", str(figs)])
        out["wacv_result_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        visualize_result.main([
            "--work_dir", str(KEPT.root / "p12_work"), "--dataset_root",
            str(source.root), "--ann_file",
            str(KEPT.loops["p12_vis"]["dir"] / "annotations.json"),
            "--out_dir", str(vis), "--heatmaps", "--round", "0"])
        out["visualize_result_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        eps = convert_to_eps.main(["--dir", str(figs)])
        out["convert_to_eps_s"] = time.perf_counter() - t0
    pngs = sorted(ana.rglob("*.png")) + sorted(figs.glob("*.png"))
    pdfs = sorted(ana.rglob("*.pdf")) + sorted(figs.glob("*.pdf"))
    for p in pngs:
        try:
            png_pixels(p)
        except AssertionError as e:
            failed.append(str(e))
    for p in pdfs:
        box, _ = pdf_image(p)
        if [round(v, 3) for v in box] != [0, 0, 460.8, 345.6]:
            failed.append(f"{p}: MediaBox {box}")
    for p in eps:
        png = Path(p).with_suffix(".png")
        if not np.array_equal(eps_pixels(p), read_images([str(png)])[0]):
            failed.append(f"{p}: its hex body is not {png.name}'s pixels")
    preds = json.load(open(KEPT.root / "p12_work" / "predicted_kpt.json"))
    frames = sorted(vis.glob("*.png"))
    if len(frames) != len({e["image_id"] for e in preds}):
        failed.append(f"{len(frames)} skeleton frames")
    for p in frames[:4]:
        png_pixels(p, (VIDEO["width"], VIDEO["height"]))
    grids = sorted((vis / "heatmaps").glob("hm_*.png"))
    if len(grids) != 8:
        failed.append(f"{len(grids)} heatmap grids, want 8")
    for p in grids:
        png_pixels(p)
    if len(eps) != len(list(figs.glob("*.png"))) or not pdfs:
        failed.append(f"{len(eps)} EPS files, {len(pdfs)} PDFs")
    out.update(pngs=len(pngs), pdfs=len(pdfs), eps=len(eps),
               skeleton_frames=len(frames), heatmap_grids=len(grids))
    return out


def tracked_sequence(tag, dest):
    """A kept loop's final predictions with the GT track ids (the loop
    scores GT boxes: each entry's id is its annotation's), and the GT
    annotation file, written as dest/{gt,pred}/<tag>.json."""
    gt = json.load(open(KEPT.loops[tag]["dir"] / "annotations.json"))
    track = {a["id"]: a["track_id"] for a in gt["annotations"]}
    preds = json.load(open(KEPT.loops[tag]["dir"] / "predicted_kpt.json"))
    for e in preds:
        e["track_id"] = track[e["id"]]
    for sub, obj in (("gt", gt), ("pred", preds)):
        (dest / sub).mkdir(parents=True, exist_ok=True)
        json.dump(obj, open(dest / sub / f"{tag}.json", "w"))
    return dest / "gt" / f"{tag}.json", dest / "pred" / f"{tag}.json"


def phase_tracking(card):
    """pose_track_eval over the kept loops' final predictions given the
    GT track ids: single-sequence mode on phase 12's loop, directory mode
    over phases 5 and 12 (the COMBINED row), and the GT fed back as
    predictions (tests/test_tracking.py: HOTA = MOTA = IDF1 = 1, OSPA 0).
    Then eval.jrdb_ap.average_precision_for_loc on phase 7's JRDB-wide
    loop's final predictions against its GT, and the GT fed back (AP and
    recall 100).  Checked: HOTA, DetA, AssA, MOTA and IDF1 finite, IDSW at
    least 0, the AP and recall finite."""
    from vatl4pose_tpu_torch.cli import pose_track_eval
    from vatl4pose_tpu_torch.eval import average_precision_for_loc
    t0 = time.perf_counter()
    dest = KEPT.root / "tracking"
    seqs = {tag: tracked_sequence(tag, dest) for tag in TRACKING_RUNS}
    gt, pred = seqs["p12_vis"]
    _, single = pose_track_eval.main(["--gt", str(gt), "--pred", str(pred),
                                      "--out", str(dest / "single.json")])
    per_seq, combined = pose_track_eval.main([
        "--gt", str(dest / "gt"), "--pred", str(dest / "pred"), "--out",
        str(dest / "dataset.json")])
    _, self_res = pose_track_eval.main(["--gt", str(gt), "--pred", str(gt)])
    track_s = time.perf_counter() - t0
    failed = []
    for name, r in [("single", single), ("COMBINED", combined)] + list(
            per_seq.items()):
        if not finite(*(r[k] for k in ("HOTA", "DetA", "AssA", "MOTA",
                                       "IDF1"))) or r["IDSW"] < 0:
            failed.append(f"{name}: {r}")
    if set(per_seq) != set(TRACKING_RUNS) or combined is per_seq.get(
            "p12_vis"):
        failed.append(f"directory mode sequences {sorted(per_seq)}")
    if not (abs(self_res["HOTA"] - 1) < 1e-6 and abs(self_res["MOTA"] - 1)
            < 1e-6 and abs(self_res["IDF1"] - 1) < 1e-6
            and self_res["OSPA"] < 1e-9):
        failed.append(f"GT as predictions: {self_res}")
    t1 = time.perf_counter()
    jdir = KEPT.loops["p7_stream"]["dir"]
    jgt = json.load(open(jdir / "GT_kpt.json"))
    ap, rec = average_precision_for_loc(jgt, json.load(
        open(jdir / "predicted_kpt.json")))
    ap_gt, rec_gt = average_precision_for_loc(jgt, jgt["annotations"])
    jrdb_s = time.perf_counter() - t1
    if not finite(ap[-1], rec[-1]):
        failed.append(f"JRDB AP {ap[-1]}, recall {rec[-1]}")
    if abs(ap_gt[-1] - 100) > 1e-6 or abs(rec_gt[-1] - 100) > 1e-6:
        failed.append(f"JRDB AP of the GT {ap_gt[-1]}, recall {rec_gt[-1]}")
    keys = ("HOTA", "DetA", "AssA", "MOTA", "IDF1", "IDSW", "OSPA")
    log("pose_track_eval: " + json.dumps(
        {name: {k: r[k] for k in keys} for name, r in
         [("p12_vis single", single), ("COMBINED p5+p12", combined),
          ("GT as predictions", self_res)]})
        + f"; {track_s:.3f} s host; JRDB AP of phase 7's final "
        f"predictions ({len(jgt['annotations'])} samples): AP {ap[-1]:.4f}"
        f", recall {rec[-1]:.4f}; the GT as predictions AP {ap_gt[-1]}, "
        f"recall {rec_gt[-1]}; {jrdb_s:.3f} s host; {card}")
    if failed:
        raise AssertionError("tracking evaluation: " + "; ".join(failed))
    return {"tracking_s": track_s, "jrdb_ap_s": jrdb_s,
            "single": {k: single[k] for k in keys},
            "combined": {k: combined[k] for k in keys},
            "jrdb_ap": ap[-1], "jrdb_recall": rec[-1]}


# ---- phase 13: data parallel over two gloo ranks on the one card ---------
# Two ranks share the card (NCCL will not put two ranks on one device, so
# the port's backend rule picks gloo): what they measure is what the
# collectives cost on this card, not a scale-out rate.
DP_RANKS = 2
DP_VALID = 100          # of the step's batch of RETRAIN["BATCH_SIZE"]
DP_TIMED = 5            # timed steps and all-reduces after the checked one
# the loop of step 4 is phase 5's with one cut: QUERY_RATIO's 9 rounds ->
# 3 (round 0 as phase 5's, then 10% and the rest), to keep the phase
# inside about 3 minutes (9 rounds took 145 s on two ranks sharing the
# card, and the whole script runs near the 1200-s limit)
DP_QUERY_RATIO = (0.05, 0.1, 1.0)
# the globals a rank process takes from its parent (a rehearsal on the
# CPU shrinks them)
DP_CONSTS = ("MODEL", "INPUT_SIZE", "HM_SIZE", "BATCH", "RETRAIN", "AUG",
             "AL_CFG", "VIDEO", "DP_VALID", "DP_QUERY_RATIO")


def _dp_spec(device, **kw):
    return dict(kw, device=str(device),
                consts={k: globals()[k] for k in DP_CONSTS})


def _dp_adopt(spec):
    """In a rank process: the parent's constants, and the parity flags."""
    import torch
    globals().update(spec["consts"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device(spec["device"])


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(module):
    """sha256 of every parameter and buffer, in order."""
    import hashlib
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dp_video(spec, dev):
    """Phase 3's video rebuilt from its files, its frames on `dev`."""
    import types
    import numpy as np
    import torch
    from vatl4pose_tpu_torch.data import build_dataset
    ds = build_dataset({"TYPE": "Posetrack21", "ROOT": spec["root"],
                        "ANN": spec["ann"]})
    d = ds.data
    frames_dev = torch.from_numpy(ds.load_frames()).to(dev)
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    return types.SimpleNamespace(
        data=d, joint_pairs=ds.joint_pairs, frames_dev=frames_dev,
        args=(frames_dev, d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann,
              d.is_prev, d.is_next))


def _dp_step_batch(video, seed):
    """The checked step's batch: RETRAIN's 120 samples, the last 20 rows
    padding (`valid` False), so the last rank holds every padded row."""
    import numpy as np
    batch = train_batch(video, RETRAIN["BATCH_SIZE"],
                        np.random.default_rng(seed + 13))
    batch[4][DP_VALID:] = False
    return batch


def _dp_rank(rank, spec):
    """One of the DP_RANKS ranks of steps 2 and 3 (spawned, a FileStore):
    the Retrainer(mesh=) step on this rank's block of the batch, then the
    step and the gradient all-reduce timed; a THC+WPU pass of
    ScoringEngine(mesh=), then timed.  The counters are reset before the
    checked step and before the checked pass and read after each."""
    import torch
    import torch.distributed as dist
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    from vatl4pose_tpu_torch.parallel import (Sharding, all_reduce_grads,
                                              make_mesh)
    dev = _dp_adopt(spec)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], DP_RANKS), rank=rank,
        world_size=DP_RANKS)
    mesh = make_mesh(DP_RANKS, device=dev)
    group = mesh.group("data")
    video = _dp_video(spec, dev)
    out = {"device": str(mesh.device), "backend": dist.get_backend()}

    def timed(fn):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        dist.barrier()
        return (time.perf_counter() - t0) * 1e3

    # step 2: the train step
    model = make_models(spec["seed"])[0].to(dev).train()
    tr = make_retrainer(model, video, device=dev, mesh=mesh)
    local = [Sharding(mesh, ("data",)).local(a)
             for a in _dp_step_batch(video, spec["seed"])]
    _sync(dev)
    reset_launch_counts()
    stats = tr.train_step(video.frames_dev, *local)
    _sync(dev)
    out["step_launches"] = launch_counts()
    out["step_valid"] = int(local[4].sum())
    out["loss"] = stats[0].item()
    out["grads"] = {k: p.grad.double().cpu()
                    for k, p in model.named_parameters()} if rank == 0 \
        else None
    out["bn"] = {k: v.double().cpu() for k, v in model.state_dict().items()
                 if "running_" in k} if rank == 0 else None
    out["digest"] = _digest(model)
    out["step_ms"] = statistics.median(
        timed(lambda: tr.train_step(video.frames_dev, *local))
        for _ in range(DP_TIMED))
    out["all_reduce_ms"] = statistics.median(
        timed(lambda: all_reduce_grads(model.parameters(), group))
        for _ in range(DP_TIMED))
    out["grad_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                            for p in model.parameters())
    del model, tr

    # step 3: the scoring pass
    model, ae = (m.to(dev) for m in make_models(spec["seed"]))
    engine = ScoringEngine(model, ScoringConfig(uncertainty="THC+WPU",
                                                input_size=INPUT_SIZE),
                           ae_model=ae, chunk=BATCH, device=dev, mesh=mesh)
    _sync(dev)
    reset_launch_counts()
    res = engine.score(*video.args)
    _sync(dev)
    out["pass_launches"] = launch_counts()
    res["heatmaps"] = res["heatmaps"].float().cpu()
    out["scores"] = res
    out["pass_ms"] = statistics.median(
        timed(lambda: engine.score(*video.args, keep_heatmaps=False))
        for _ in range(3))
    torch.save(out, f"{spec['out']}_{rank}.pt")
    dist.destroy_process_group()


def _dp_one_process(video, seed):
    """Steps 2 and 3 in this process on the card, from the same weights:
    the step on the whole batch (loss, gradients, BN statistics, ms) and
    the pass (its scores)."""
    import torch
    dev = video.frames_dev.device
    model = make_models(seed)[0].to(dev).train()
    tr = make_retrainer(model, video, device=dev)
    batch = _dp_step_batch(video, seed)
    loss = tr.train_step(video.frames_dev, *batch)[0].item()
    ref = {"loss": loss,
           "grads": {k: p.grad.double().cpu()
                     for k, p in model.named_parameters()},
           "bn": {k: v.double().cpu() for k, v in model.state_dict().items()
                  if "running_" in k}}
    times = []
    for _ in range(DP_TIMED):
        _sync(dev)
        t0 = time.perf_counter()
        tr.train_step(video.frames_dev, *batch)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    ref["step_ms"] = statistics.median(times)
    # the exact step (f64), to tell the f32 steps' rounding from a fault
    model = make_models(seed)[0].double().to(dev).train()
    make_retrainer(model, video, device=dev).train_step(video.frames_dev,
                                                        *batch)
    ref["grads_f64"] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    del model, tr
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    model, ae = (m.to(dev) for m in make_models(seed))
    ref["scores"] = ScoringEngine(
        model, ScoringConfig(uncertainty="THC+WPU", input_size=INPUT_SIZE),
        ae_model=ae, chunk=BATCH, device=dev).score(*video.args)
    ref["scores"]["heatmaps"] = ref["scores"]["heatmaps"].cpu()
    del model, ae
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def _cos_norm(a, b):
    a, b = a.ravel(), b.ravel()
    na, nb = a.norm().item(), b.norm().item()
    return ((a @ b).item() / (na * nb) if na > 0 and nb > 0 else 1.0), na, nb


def _dp_scores_agree(got, ref, label):
    """Two passes over the same samples, each a dict of host arrays with
    its heatmaps, held to tests/test_sharding.py's bounds (rtol 2e-4, atol
    1e-5): the heatmaps (:30's eval-step bound) and what is continuous in
    them (the embeddings, THC `unc`, det_score, gc) on every sample; what
    follows a heatmap's argmax (kpts, oks, WPU `unc2`) on every sample
    whose argmaxes agree.  Where the two maps of a joint put their
    argmaxes on different pixels, the two pixels were within twice the
    maps' own difference of each other (the heatmap bound holds that): a
    near tie of the seeded weights' maps, decided by the f32 rounding of
    two runs, which moves a decoded keypoint by pixels.  Returns the
    failures and, per key, the max |difference| and the flipped samples
    with their largest lead."""
    import numpy as np
    import torch
    g = torch.as_tensor(got["heatmaps"]).flatten(2).double()
    w = torch.as_tensor(ref["heatmaps"]).flatten(2).double()
    ag, aw = g.argmax(-1), w.argmax(-1)
    flipped = (ag != aw).any(-1).numpy()
    lead = (w.gather(-1, aw[..., None]) - w.gather(-1, ag[..., None]))
    failed, worst = [], {"flipped_samples": int(flipped.sum()),
                         "flip_lead_max": float(lead.max())}
    keep = ~flipped
    for k, rows in (("heatmaps", None), ("embeddings", None), ("unc", None),
                    ("det_score", None), ("gc", None), ("kpts", keep),
                    ("oks", keep), ("unc2", keep)):
        a = np.asarray(torch.as_tensor(got[k]).double().cpu())
        b = np.asarray(torch.as_tensor(ref[k]).double().cpu())
        if a.shape != b.shape:
            failed.append(f"{label} {k}: shapes {a.shape} {b.shape}")
            continue
        if rows is not None:
            a, b = a[rows], b[rows]
        worst[k] = float(np.abs(a - b).max()) if a.size else 0.0
        if not np.allclose(a, b, rtol=2e-4, atol=1e-5):
            failed.append(f"{label} {k}: max |err| {worst[k]:.3e}")
    return failed, worst


def phase_dp_steps(video, card, seed):
    """Steps 2 and 3: DP_RANKS gloo ranks (torch.multiprocessing spawn, a
    FileStore) on the card against this process's one-process step and
    pass from the same weights."""
    import torch
    import torch.multiprocessing as mp
    ref = _dp_one_process(video, seed)
    with tempfile.TemporaryDirectory() as tmp:
        spec = _dp_spec(video.frames_dev.device, root=video.root,
                        ann=video.ann, seed=seed, store=f"{tmp}/store",
                        out=f"{tmp}/rank")
        t0 = time.perf_counter()
        mp.start_processes(_dp_rank, args=(spec,), nprocs=DP_RANKS,
                           start_method="spawn")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank_{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
    failed = []
    r0 = ranks[0]
    log(f"DP: {DP_RANKS} ranks on {[r['device'] for r in ranks]}, backend "
        f"{r0['backend']}, spawned and run in {spawn_s:.1f} s ({card})")

    # step 2
    loss_err = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    # a gradient tensor passes at tests/test_sharding.py:113's bar
    # against the one-process step (cosine > 0.9999, norm within 1e-2),
    # or where it is no further from the exact (f64) step's than twice
    # the one-process f32 step's is (relative Frobenius distance, floor
    # 1e-3): two f32 steps of these seeded weights part by more than the
    # bar (phase_step_check's rule for the card against the CPU)
    worst_cos, worst_norm, arbitrated = 1.0, 0.0, []
    f64 = {"DP": 0.0, "one process": 0.0}
    for k, g in ref["grads"].items():
        cos, na, nb = _cos_norm(g, r0["grads"][k])
        worst_cos = min(worst_cos, cos)
        rel = abs(nb - na) / na if na > 0 else abs(nb)
        worst_norm = max(worst_norm, rel)
        exact = ref["grads_f64"][k]
        e_dp, e_one = ((x - exact).norm().item()
                       / max(exact.norm().item(), 1e-30)
                       for x in (r0["grads"][k], g))
        f64 = {"DP": max(f64["DP"], e_dp),
               "one process": max(f64["one process"], e_one)}
        if not (cos > 0.9999 and rel <= 1e-2):
            if e_dp > max(1e-3, 2 * e_one):
                failed.append(f"gradient {k}: cosine {cos:.6f}, norm rel "
                              f"{rel:.3e}; from f64 {e_dp:.3e}, the one "
                              f"process's {e_one:.3e}")
            arbitrated.append(k)
    bn_err = max(((r0["bn"][k] - v).abs().max() / v.abs().max()).item()
                 for k, v in ref["bn"].items())
    same = len({r["digest"] for r in ranks}) == 1
    log(f"DP step (batch {RETRAIN['BATCH_SIZE']}, "
        f"{RETRAIN['BATCH_SIZE'] // DP_RANKS} a rank, valid rows a rank "
        f"{[r['step_valid'] for r in ranks]}): loss {r0['loss']:.7e} vs one "
        f"process {ref['loss']:.7e}, rel {loss_err:.3e} (bar 1e-3); "
        f"gradients: worst cosine {worst_cos:.7f} (bar > 0.9999), worst "
        f"norm rel {worst_norm:.3e} (bar 1e-2); {len(arbitrated)} of "
        f"{len(ref['grads'])} tensors past the bar, each held to the f64 "
        f"step instead; worst relative distance from the f64 step's "
        f"gradient {f64}; BN running statistics "
        f"max rel {bn_err:.3e} (bar 1e-4); ranks' parameters bit-identical "
        f"{same}; launches {[r['step_launches'] for r in ranks]}")
    log(f"DP step: {r0['step_ms']:.2f} ms (median of {DP_TIMED}; one "
        f"process {ref['step_ms']:.2f} ms); the gradient all-reduce alone "
        f"{r0['all_reduce_ms']:.2f} ms for {r0['grad_bytes'] / 1e6:.1f} MB "
        f"through gloo, the ranks sharing one card ({card})")
    if loss_err > 1e-3 or bn_err > 1e-4 or not same:
        failed.append(f"step: loss rel {loss_err:.3e}, BN {bn_err:.3e}, "
                      f"ranks identical {same}")
    for r in ranks:
        if r["step_launches"]["rot_warp_crop"] != 1:
            failed.append(f"step launches {r['step_launches']}")

    # step 3
    n = len(video.data)
    for i, r in enumerate(ranks):
        check_outputs(r["scores"], n)
        f, worst = _dp_scores_agree(r["scores"], ref["scores"], f"rank {i}")
        failed += f
        want = {"fused_bottleneck_chain": 4, "fused_postprocess": 1,
                "rot_warp_crop": 1,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        if r["pass_launches"] != want:
            failed.append(f"rank {i} pass launches {r['pass_launches']}")
    rate = n / (r0["pass_ms"] / 1e3)
    log(f"DP pass (THC+WPU, f32, {n} samples, {n // DP_RANKS} a rank): "
        f"against one process {worst} (bars rtol 2e-4, atol 1e-5; a "
        f"flipped sample's decode apart); launches a rank "
        f"{[r['pass_launches'] for r in ranks]}; "
        f"{rate:.1f} samples/s over the pass (median of 3, {card})")
    if failed:
        raise AssertionError("DP steps: " + "; ".join(failed))
    return {"step": {"loss_rel": loss_err, "worst_cosine": worst_cos,
                     "worst_rel_from_f64": f64,
                     "past_the_bar": len(arbitrated),
                     "worst_norm_rel": worst_norm, "bn_rel": bn_err,
                     "ms": r0["step_ms"], "one_process_ms": ref["step_ms"],
                     "all_reduce_ms": r0["all_reduce_ms"],
                     "grad_mb": r0["grad_bytes"] / 1e6,
                     "launches": {k: sum(r["step_launches"][k]
                                         for r in ranks)
                                  for k in r0["step_launches"]}},
            "pass": {"samples_per_s": rate, "ms": r0["pass_ms"],
                     "max_abs_err": worst,
                     "launches": {k: sum(r["pass_launches"][k]
                                         for r in ranks)
                                  for k in r0["pass_launches"]}}}


def _keep_first_pass(store):
    """A wrapper maker for ScoringEngine.score (`patched`): every pass
    keeps its heatmaps, and the first pass's result is stored on the host
    in `store`."""
    import torch

    def make(score):
        def wrapper(self, *a, **kw):
            res = score(self, *a, **dict(kw, keep_heatmaps=True))
            if not store:
                store.append({k: v.float().cpu() if torch.is_tensor(v)
                              else v for k, v in res.items()})
            return res
        return wrapper
    return make


def _round0_gap(got, want):
    """Round 0's THC and WPU scores (result.json's `uncertaity`) of two
    runs: each criterion's max |difference| and the samples outside the
    scoring pass's bounds (rtol 2e-4, atol 1e-5)."""
    import numpy as np
    keys = sorted(want, key=int)
    if sorted(got, key=int) != keys:
        return {"samples": (len(got), len(want))}
    a = np.array([got[k] for k in keys], np.float64).reshape(len(keys), -1)
    b = np.array([want[k] for k in keys], np.float64).reshape(len(keys), -1)
    out = {}
    for j, name in enumerate(("unc", "unc2")[:a.shape[1]]):
        d = np.abs(a[:, j] - b[:, j])
        out[name] = {"max_abs": float(d.max()),
                     "outside": int((d > 1e-5 + 2e-4 * np.abs(b[:, j]))
                                    .sum())}
    return out


def phase_dp_noop(video, seed, card):
    """Step 1: ActiveLearning with --data_parallel in this process (no
    WORLD_SIZE) on phase 3's video files: no mesh, and round 0's scores
    and query list bit-identical to a round 0 without the flag, both on
    deterministic algorithms; each against phase 5's round 0 (KEPT).
    Returns the summary and round 0's pass (its scores and heatmaps on the
    host), step 4's reference."""
    import os
    import torch
    from vatl4pose_tpu_torch.al import scoring
    from vatl4pose_tpu_torch.al.active_learning import ActiveLearning
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    if os.environ.get("WORLD_SIZE") not in (None, "1"):
        raise AssertionError("step 1 needs a process without WORLD_SIZE")
    p5 = json.load(open(KEPT.loops["p5"]["dir"] / "result.json"))
    rounds, counts = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        model, ae = make_models(seed)
        base = Cfg(copy.deepcopy(AL_CFG))
        write_weights(tmp, base, model, ae)
        del model, ae
        for split in ("EVAL", "TRAIN"):
            base.DATASET[split].update(ROOT=video.root, ANN=video.ann)
        for dp in (True, False):
            # two work dirs, whatever the clock says
            extra = ["--memo", f"dp_{dp}"] + (["--data_parallel"] if dp
                                               else [])
            passes = []
            with cli_workdir(copy.deepcopy(base), loop_argv(extra=extra),
                             tmp, prepare=False) as (cfg, opt), \
                    deterministic(), \
                    patched(scoring.ScoringEngine, "score",
                            _keep_first_pass(passes)):
                al = ActiveLearning(cfg, opt)
                if al.mesh is not None:
                    raise AssertionError("--data_parallel on one process "
                                         "made a mesh")
                reset_launch_counts()
                al.eval_and_query()
                _sync(al.device)
                if dp:
                    counts = launch_counts()
                rounds[dp] = (
                    {str(k): v for k, v in
                     al.uncertainty_dict["Round0"].items()},
                    al.query_list_list["Round0"])
                if dp:
                    round0 = passes[0]
                del al
                torch.cuda.empty_cache()
    same = rounds[True] == rounds[False]
    gap = {dp: _round0_gap(rounds[dp][0], p5["uncertaity"]["Round0"])
           for dp in rounds}
    same_query = {dp: r[1] == p5["query_list"]["Round0"]
                  for dp, r in rounds.items()}
    log(f"DP step 1: --data_parallel without WORLD_SIZE: mesh None; round "
        f"0's scores and query list bit-identical to a round without the "
        f"flag (both deterministic) {same}; against phase 5's round 0 "
        f"(flag: True/False) query equal {same_query}, scores {gap}; "
        f"launches {counts} ({card})")
    if not same:
        raise AssertionError("--data_parallel on one process changed "
                             "round 0")
    return {"launches": counts, "query": rounds[True][1],
            "against_phase5": gap[True]}, round0


class _WriteLog:
    """Records the paths this process opens for writing and the
    directories it makes, for the duration."""

    def __init__(self):
        self.paths = []

    def __enter__(self):
        import builtins
        import os
        self._orig = (builtins.open, os.mkdir)
        orig_open, orig_mkdir = self._orig

        def opening(file, mode="r", *a, **kw):
            if isinstance(file, (str, bytes, os.PathLike)) \
                    and any(c in mode for c in "wax+"):
                self.paths.append(os.path.abspath(os.fsdecode(file)))
            return orig_open(file, mode, *a, **kw)

        def making(path, *a, **kw):
            self.paths.append(os.path.abspath(os.fsdecode(path)))
            return orig_mkdir(path, *a, **kw)
        builtins.open, os.mkdir = opening, making
        return self

    def __exit__(self, *exc):
        import builtins
        import os
        builtins.open, os.mkdir = self._orig


def dp_loop_rank(spec_path):
    """A rank of step 4, under torchrun: the CLI's `run` (set_dir,
    prepare_synthetic, do_al, save_result; the process group from
    torchrun's environment) on phase 5's config with --data_parallel,
    every write of this process recorded.  Writes its report (rank,
    launches, passes and steps, digests of the final estimator and AE,
    the written paths) under the spec's `out`."""
    import os
    import torch
    from vatl4pose_tpu_torch.al import scoring
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    from vatl4pose_tpu_torch.config import Cfg
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    spec = json.load(open(spec_path))
    dev = _dp_adopt(spec)
    rank = int(os.environ["RANK"])
    opt = cli.setup_opt(cli.parse_args(spec["argv"]))
    writes = _WriteLog()
    walls = []

    def timed(out, seconds):
        walls.append(seconds)
    first = []
    with writes, CallLog() as calls, \
            patched(scoring.ScoringEngine, "score", _keep_first_pass(first)):
        # the loop's wall is do_al's, as phase 5's (its set-up apart)
        calls.wrap(cli, "do_al", lambda *a, **kw: None, timed)
        reset_launch_counts()
        cli.run(Cfg(spec["cfg"]), opt)
        _sync(dev)
    if rank == 0:
        torch.save(first[0], os.path.join(spec["out"], "round0.pt"))
    report = {"rank": rank, "launches": launch_counts(), "loop_s": walls[0],
              "passes": calls.score_calls, "steps": calls.train_steps,
              "model": _digest(calls.al.model), "ae": _digest(calls.al.ae),
              "device": str(calls.al.device), "writes": writes.paths}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def phase_dp_loop(video, seed, card, round0):
    """Step 4: the DUW loop (phase 5's, f32, QUERY_RATIO cut to
    DP_QUERY_RATIO, on phase 3's video files laid out as a PoseTrack21
    video) under `torchrun --standalone --nproc_per_node DP_RANKS` with
    --data_parallel, each rank this script's
    `dp_loop_rank`; checked as phase 5's loop, with every file of the run
    written by rank 0, the launches of every rank (K1 4, K2 1 and K3 1 a
    pass, K3 once a step), round 0's pass against step 1's round 0
    (`round0`: phase 5's configuration in one process) as step 3 holds the
    pass (_dp_scores_agree), and every rank's estimator and AE
    bit-identical to rank 0's at the end; round 0's scores against phase
    5's result.json are printed beside."""
    import os
    import torch
    from vatl4pose_tpu_torch.config import Cfg
    n = VIDEO["num_frames"] * VIDEO["num_persons"]
    rounds = len(DP_QUERY_RATIO)
    p5 = json.load(open(KEPT.loops["p5"]["dir"] / "result.json"))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for d in ("run", "tmpdir", "out"):
            (tmp / d).mkdir()
        model, ae = make_models(seed)
        cfg = Cfg(copy.deepcopy(AL_CFG))
        cfg.VAL.QUERY_RATIO = list(DP_QUERY_RATIO)
        write_weights(str(tmp), cfg, model, ae)
        del model, ae
        _posetrack_layout(video, tmp / "data")
        for split in ("EVAL", "TRAIN"):
            cfg.DATASET[split].ROOT = str(tmp / "data")
        spec = _dp_spec("cuda" if torch.cuda.is_available() else "cpu",
                        cfg=dict(cfg),
                        argv=loop_argv(extra=["--data_parallel"]),
                        out=str(tmp / "out"))
        if spec["device"] == "cpu":
            spec["argv"] += ["--device", "cpu"]
        (tmp / "spec.json").write_text(json.dumps(spec))
        env = dict(os.environ, TMPDIR=str(tmp / "tmpdir"),
                   PYTHONPATH=os.pathsep.join(
                       [str(Path(__file__).resolve().parent),
                        os.environ.get("PYTHONPATH", "")]))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(DP_RANKS),
               str(Path(__file__).resolve()), "--dp-loop-rank",
               str(tmp / "spec.json")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=tmp / "run", env=env,
                              capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines()[-25:]:
            log(f"  | {line}")
        if proc.returncode != 0:
            log(proc.stderr[-6000:])
            raise AssertionError(f"the torchrun loop exited "
                                 f"{proc.returncode}")
        reports = sorted((json.loads(p.read_text())
                          for p in (tmp / "out").glob("rank*.json")),
                         key=lambda r: r["rank"])
        loop_round0 = torch.load(tmp / "out" / "round0.pt",
                                 weights_only=False)
        (result,) = list((tmp / "run").glob("exp/**/result.json"))
        rj = json.loads(result.read_text())
        cycles = [json.loads(line) for line in
                  (result.parent / "cycle_times.jsonl").read_text()
                  .splitlines()]
        under = str(tmp)
        foreign = {r["rank"]: [p for p in r["writes"] if p.startswith(under)]
                   for r in reports if r["rank"] != 0}
        own = [p for p in reports[0]["writes"] if p.startswith(under)]
    r0 = reports[0]
    calls = type("Calls", (), {"score_calls": r0["passes"],
                               "train_steps": r0["steps"]})
    label = "AL loop --data_parallel"
    phase_sums, table, failed = loop_report(
        label, rj, cycles, r0["launches"], calls, r0["loop_s"], n, rounds,
        card)
    if len(reports) != DP_RANKS:
        failed.append(f"{len(reports)} rank reports")
    for r in reports:
        p, s = r["passes"], r["steps"]
        want = {"fused_bottleneck_chain": 4 * p, "fused_postprocess": p,
                "rot_warp_crop": p + s,
                "deform_im2col": 0, "shuffle_conv3x3": 0}
        if p != rounds + 1 or s == 0 or r["launches"] != want:
            failed.append(f"rank {r['rank']}: launches {r['launches']}, "
                          f"want {want}")
        if (r["model"], r["ae"]) != (r0["model"], r0["ae"]):
            failed.append(f"rank {r['rank']}'s final weights differ from "
                          f"rank 0's")
    same = all((r["model"], r["ae"]) == (r0["model"], r0["ae"])
               for r in reports)
    if any(foreign.values()) or not own:
        failed.append(f"writes by other ranks {foreign}; rank 0 wrote "
                      f"{len(own)} paths")
    f, agree = _dp_scores_agree(loop_round0, round0, "round 0")
    failed += f
    gap = _round0_gap(rj["uncertaity"]["Round0"], p5["uncertaity"]["Round0"])
    log(f"{label}: round 0's pass against step 1's round 0 (phase 5's "
        f"configuration, one process) {agree} (bars rtol 2e-4, atol 1e-5; "
        f"a flipped sample's decode apart); its scores against phase 5's "
        f"result.json {gap}; round 0's query "
        f"{sorted(rj['query_list']['Round0'])} / phase 5's "
        f"{sorted(p5['query_list']['Round0'])} (not required equal: "
        f"random weights put DUW's selection on f32 noise, ROADMAP C2); "
        f"rank 0 wrote {len(own)} paths, the other ranks "
        f"{sum(map(len, foreign.values()))}; final estimator and AE the "
        f"same on every rank {same}; devices "
        f"{[r['device'] for r in reports]}; torchrun wall "
        f"{wall:.1f} s, the loop {r0['loop_s']:.2f} s on rank 0 ({card})")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"loop_s": r0["loop_s"], "torchrun_s": wall,
            "phase_s": phase_sums, "rounds": table,
            "round0_against_step1": agree,
            "round0_against_phase5": gap,
            "launches": {k: sum(r["launches"][k] for r in reports)
                         for k in r0["launches"]},
            "passes": r0["passes"], "train_steps": r0["steps"]}


# ---- phase 15: the entry points as a user starts them ----------------------
# the committed JPEG video and what the AL CLI's main() reads, on a copy of
# al_simple_posetrack.yaml whose only changes are entry_cuts (RETRAIN.ALPHA
# 250 -> AL_ALPHA, both ROOTs -> the video's layout, MODEL.PRETRAINED and
# AE.PRETRAINED_ROOT -> phase 3's seeded weights written to disk)
JPEG_VIDEO = "tests/data/jpeg_video"
JPEG_VIDEO_ANN = "annotations/000001.json"
ENTRY_CONFIG = "configs/posetrack21/al_simple_posetrack.yaml"
DECODE_REPEATS = 5


def entry_cuts(root, pretrained, ae_root):
    return {("RETRAIN", "ALPHA"): AL_ALPHA,
            ("DATASET", "TRAIN", "ROOT"): root,
            ("DATASET", "EVAL", "ROOT"): root,
            ("MODEL", "PRETRAINED"): pretrained,
            ("AE", "PRETRAINED_ROOT"): ae_root}


def yaml_with(text, cuts):
    """YAML text with the scalar at each key path of `cuts` replaced, line
    for line (comments and layout kept); a path that is not found, or not
    on a 'key: scalar' line, raises KeyError."""
    out, stack, done = [], [], set()
    for line in text.splitlines():
        body = line.lstrip(" ")
        if body and not body.startswith(("#", "-")) and ":" in body:
            indent = len(line) - len(body)
            key = body.split(":", 1)[0].strip().strip("'\"")
            while stack and stack[-1][0] >= indent:
                stack.pop()
            stack.append((indent, key))
            path = tuple(k for _, k in stack)
            if path in cuts and body.split(":", 1)[1].strip():
                value = cuts[path]
                if isinstance(value, str):
                    value = "'" + value.replace("'", "''") + "'"
                line = f"{' ' * indent}{key}: {value}"
                done.add(path)
        out.append(line)
    if set(cuts) - done:
        raise KeyError(f"no 'key: scalar' line for {set(cuts) - done}")
    return "\n".join(out) + "\n"


def phase_configs():
    """Every configs/**/*.yaml read by update_config, as the CLIs read
    them.  Returns (count, ms)."""
    from vatl4pose_tpu_torch.config import Cfg, update_config
    paths = sorted((HERE / "configs").rglob("*.yaml"))
    t0 = time.perf_counter()
    cfgs = [update_config(str(p)) for p in paths]
    ms = (time.perf_counter() - t0) * 1e3
    bad = [str(p.relative_to(HERE)) for p, c in zip(paths, cfgs)
           if not isinstance(c, Cfg) or not c.get("MODEL")]
    if len(paths) < 11 or bad:
        raise AssertionError(f"configs: {len(paths)} read, without a MODEL "
                             f"section: {bad}")
    log(f"configs: {len(paths)} files of configs/ read through the port's "
        f"YAML reader in {ms:.2f} ms")
    return len(paths), ms


def phase_jpeg_decode():
    """The committed JPEG video decoded by the port (data/image_io.py,
    csrc/jpeg_decode.cpp built with g++ here at first use), each frame's
    RGB held against the SHA-256 of cv2's decode recorded where cv2 is;
    the first decode's wall (the build included), and the decoder's ms a
    frame on one thread and on all of them (median of DECODE_REPEATS
    decodes of the 16 frames)."""
    import hashlib
    import os
    from vatl4pose_tpu_torch.data import image_io
    root = HERE / JPEG_VIDEO
    recorded = json.loads((root / "decoded_sha256.json").read_text())
    paths = [str(root / name) for name in recorded]
    t0 = time.perf_counter()
    frames = image_io.read_images(paths, num_threads=1)
    first_s = time.perf_counter() - t0
    wrong = [name for (name, digest), img in zip(recorded.items(), frames)
             if img.shape != (360, 640, 3) or hashlib.sha256(
                 img.tobytes()).hexdigest() != digest]
    if len(frames) != 16 or wrong:
        raise AssertionError(f"JPEG video: {len(frames)} frames, decodes "
                             f"unlike cv2's: {wrong}")
    per_frame = {}
    threads = os.cpu_count() or 1
    for label, n in (("1_thread", 1), (f"{threads}_threads", threads)):
        times = []
        for _ in range(DECODE_REPEATS):
            t0 = time.perf_counter()
            image_io.read_images(paths, num_threads=n)
            times.append(time.perf_counter() - t0)
        per_frame[label] = statistics.median(times) / len(paths) * 1e3
    log(f"JPEG video: 16 frames of 640x360 decode to cv2's SHA-256; the "
        f"first decode, the g++ build included, {first_s:.2f} s; ms a frame "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items()))
    return {"frames": len(frames), "first_decode_s": first_s,
            "ms_per_frame": per_frame}


# phase 15 (a): the port's JPEG encoder writes the committed video again.
# Phase 3's video (VIDEO, seed 0) begins with the 16 frames of
# tests/data/jpeg_video (the generator's frames do not depend on how many
# follow), which cv2.imwrite wrote at quality 90, 4:2:0
ENCODE_FRAMES = 16
ENCODE_QUALITY, ENCODE_SAMPLING = 90, "420"
# phase 15 (c): the format fixtures and the frames timed among them
FORMATS_DIR = "tests/data/formats"
FORMAT_TIMED = ("frame_640x360_prog.jpg", "frame_640x360_lzw.tif")


def _sha(a):
    """SHA-256 of bytes or of an array's elements (bool as 0/1), as
    tests/test_torch_formats.py records them."""
    import hashlib
    if not isinstance(a, bytes):
        a = ((a != 0).astype("uint8") if a.dtype == bool else a).tobytes()
    return hashlib.sha256(a).hexdigest()


def phase_jpeg_encode(frames, dest):
    """The first ENCODE_FRAMES frames of phase 3's video written by the
    port's encoder (data/image_io.encode_jpeg, csrc/jpeg_encode.cpp built
    with g++ here at first use) at ENCODE_QUALITY and ENCODE_SAMPLING,
    with cv2, PIL and matplotlib refused: each file must equal the
    committed tests/data/jpeg_video frame byte for byte.  The files and
    the committed annotation are laid out under `dest` as the committed
    video is.  Returns the first encode's wall (the build included) and
    the median ms a 640x360 frame over DECODE_REPEATS encodes of all."""
    from vatl4pose_tpu_torch.data import image_io
    src = HERE / JPEG_VIDEO
    ann = json.loads((src / JPEG_VIDEO_ANN).read_text())
    names = [im["file_name"] for im in ann["images"]]
    if len(names) != ENCODE_FRAMES or len(frames) < ENCODE_FRAMES:
        raise AssertionError(f"JPEG encode: {len(names)} committed frames, "
                             f"{len(frames)} generated")
    wrong = []
    with refusing():
        t0 = time.perf_counter()
        datas = [image_io.encode_jpeg(rgb, ENCODE_QUALITY, ENCODE_SAMPLING)
                 for rgb in frames[:ENCODE_FRAMES]]
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(DECODE_REPEATS):
            t0 = time.perf_counter()
            for rgb in frames[:ENCODE_FRAMES]:
                image_io.encode_jpeg(rgb, ENCODE_QUALITY, ENCODE_SAMPLING)
            times.append(time.perf_counter() - t0)
    for name, data in zip(names, datas):
        if data != (src / name).read_bytes():
            wrong.append(name)
        out = Path(dest) / name
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(data)
    (Path(dest) / JPEG_VIDEO_ANN).parent.mkdir(parents=True, exist_ok=True)
    (Path(dest) / JPEG_VIDEO_ANN).write_bytes((src / JPEG_VIDEO_ANN)
                                              .read_bytes())
    if wrong:
        raise AssertionError(f"JPEG encode: {len(wrong)} of "
                             f"{ENCODE_FRAMES} files differ from the "
                             f"committed ones: {wrong}")
    ms = statistics.median(times) / ENCODE_FRAMES * 1e3
    log(f"JPEG encode: {ENCODE_FRAMES} frames of 640x360 at quality "
        f"{ENCODE_QUALITY}, {ENCODE_SAMPLING}, equal to the committed "
        f"files byte for byte; the first encode, the g++ build included, "
        f"{first_s:.2f} s; {ms:.3f} ms a frame (one thread)")
    return {"frames": ENCODE_FRAMES, "first_encode_s": first_s,
            "ms_per_frame": ms}


def phase_formats(card):
    """Every fixture of tests/data/formats decoded by the port in cv2's
    view (read_images, image_size) and PIL's view (read_image_mode) and
    converted by convert_to_eps.main alone in a directory, with cv2, PIL
    and matplotlib refused; each result held against the SHA-256 that
    expected.json records from cv2, PIL and the JAX package's main, and
    each recorded refusal raised.  The FORMAT_TIMED frames' decode is
    timed: median ms of DECODE_REPEATS decodes."""
    import shutil
    from vatl4pose_tpu_torch.cli import convert_to_eps
    from vatl4pose_tpu_torch.data import image_io
    root = HERE / FORMATS_DIR
    expected = json.loads((root / "expected.json").read_text())
    failed, checked = [], {"cv2": 0, "pil": 0, "eps": 0, "refusals": 0}

    def expect(name, kind, fn, want, refusal):
        try:
            got = fn()
        except ValueError as e:
            # the readers name the file; the EPS writer's refusal is PIL's
            # message as it is
            if refusal and refusal in str(e) and (
                    kind == "eps" or name in str(e)):
                checked["refusals"] += 1
            else:
                failed.append(f"{name} {kind}: {e}")
            return
        if refusal:
            failed.append(f"{name} {kind}: read, not refused ({refusal})")
        elif got != want:
            failed.append(f"{name} {kind}: {got} != {want}")
        else:
            checked[kind] += 1

    ms = {}
    with refusing(), tempfile.TemporaryDirectory() as tmp:
        for name, want in expected.items():
            path = str(root / name)
            cv_refusal = want.get("refused") or want.get("refused_cv2")
            expect(name, "cv2", lambda: (
                _sha(image_io.read_images([path])[0]),
                list(image_io.image_size(path))),
                None if cv_refusal else (want["cv2"]["sha256"],
                                         want["size"]), cv_refusal)

            def pil():
                mode, px, palette = image_io.read_image_mode(path)
                return mode, _sha(px)
            expect(name, "pil", pil, None if "refused" in want else (
                want["pil"]["mode"], want["pil"]["sha256"]),
                want.get("refused"))
            d = Path(tmp) / name
            d.mkdir()
            shutil.copy(path, d)
            eps_error = want["eps"].get("error", "")
            eps_refusal = want.get("refused") or (
                eps_error[len("ValueError: "):]
                if eps_error.startswith("ValueError: ") else None)

            def eps():
                import io
                with contextlib.redirect_stdout(io.StringIO()):
                    (out,) = convert_to_eps.main(["--dir", str(d)])
                return _sha(Path(out).read_bytes())
            expect(name, "eps", eps, want["eps"].get("sha256"), eps_refusal)
        for name in FORMAT_TIMED:
            path = str(root / name)
            times = []
            for _ in range(DECODE_REPEATS):
                t0 = time.perf_counter()
                image_io.read_images([path], num_threads=1)
                times.append(time.perf_counter() - t0)
            ms[name] = statistics.median(times) * 1e3
    # three checks a fixture (cv2's view, PIL's view, the EPS), each a
    # match or a recorded refusal
    if failed or sum(checked.values()) != 3 * len(expected):
        raise AssertionError("format fixtures: " + "; ".join(failed[:20]))
    log(f"format fixtures: {len(expected)} files of {FORMATS_DIR} ({checked})"
        f" match cv2's, PIL's and the JAX convert_to_eps's recorded hashes "
        f"and refusals, cv2, PIL and matplotlib refused; ms a 640x360 frame "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; {card}")
    return {"files": len(expected), "checked": checked,
            "ms_per_frame": ms}


# the second main() of phase 15 draws every figure of the loop: its rounds
# cut to QUERY_RATIO's first two entries (9 rounds -> 2)
ENTRY_VIS_QUERY_RATIO = [0.05, 0.1]
ENTRY_VIS_FLAGS = ["--vis", "--vis_thc", "--vis_wpu"]


def phase_entry_main(card, seed, vis=False, video_root=None):
    """run_active_learning.main(argv) in this process on the JPEG video
    (`video_root`, laid out as tests/data/jpeg_video, or that directory
    itself) laid out as PoseTrack21's video 000001, from phase 3's seeded
    weights written to disk, --cfg a copy of ENTRY_CONFIG with entry_cuts
    only, matplotlib, cv2 and PIL refused; checked as phase 5's loop, each
    round's query within the pool and disjoint from the earlier rounds'.
    With `vis`, the loop runs with ENTRY_VIS_FLAGS, QUERY_RATIO cut to
    ENTRY_VIS_QUERY_RATIO: the figures of each kind are counted (a THC grid
    a sample with both neighbours a pass, a WPU scatter a sample a pass, a
    cluster figure a round that queried), timed, and a few read back."""
    import os
    from vatl4pose_tpu_torch.utils import vis as vis_mod
    import types
    import torch
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    from vatl4pose_tpu_torch.config import Cfg, parse_yaml
    from vatl4pose_tpu_torch.data import build_dataset
    from vatl4pose_tpu_torch.kernels import KERNELS, reset_launch_counts

    video_root = Path(video_root or HERE / JPEG_VIDEO)
    label = "AL main() on JPEG frames" + (
        " " + " ".join(ENTRY_VIS_FLAGS) if vis else "") + (
        "" if video_root == HERE / JPEG_VIDEO else " written by the port")
    failed = []
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        _posetrack_layout(types.SimpleNamespace(
            root=str(video_root), ann=JPEG_VIDEO_ANN), root)
        model, ae = make_models(seed)
        weights = Cfg({"MODEL": {"TYPE": "SimplePose"}, "AE": {}})
        write_weights(tmp, weights, model, ae)
        del model, ae
        cuts = entry_cuts(str(root), weights.MODEL.PRETRAINED,
                          weights.AE.PRETRAINED_ROOT)
        if vis:
            cuts[("VAL", "QUERY_RATIO")] = list(ENTRY_VIS_QUERY_RATIO)
        text = (HERE / ENTRY_CONFIG).read_text()
        cfg_path = Path(tmp) / Path(ENTRY_CONFIG).name
        cfg_path.write_text(yaml_with(text, cuts))
        want = with_cuts(parse_yaml(text, ENTRY_CONFIG), cuts, ENTRY_CONFIG)
        if parse_yaml(cfg_path.read_text(), str(cfg_path)) != want:
            raise AssertionError(f"{label}: the config copy differs from "
                                 f"{ENTRY_CONFIG} beyond its cuts")
        n = len(build_dataset({"TYPE": "Posetrack21",
                               "ROOT": str(video_root),
                               "ANN": JPEG_VIDEO_ANN}))
        # a QUERY_RATIO short of 1.0 ends in one more round that queries
        # the rest
        ratios = want["VAL"]["QUERY_RATIO"]
        rounds = len(ratios) + (ratios[-1] < 1)
        argv = loop_argv(cfg=str(cfg_path),
                         extra=ENTRY_VIS_FLAGS if vis else ())
        log(f"{label}: main({' '.join(argv)})")
        timing = FigureTimes(vis_mod, ("visualize_thc", "visualize_wpu",
                                       "plot_embedding_selection"))
        cwd = os.getcwd()
        os.chdir(tmp)                       # set_dir writes under ./exp
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CallLog() as calls, contextlib.ExitStack() as stack:
                stack.enter_context(refusing())
                if vis:
                    stack.enter_context(timing)
                reset_launch_counts()
                cli.main(argv)
                torch.cuda.synchronize()
                counts = {k.__name__: k.launches for k in KERNELS}
            loop_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        runs = sorted((Path(tmp) / "exp").glob(
            "AL_chip_smoke/SimplePose/*/000001/*/result.json"))
        if len(runs) != 1:
            raise AssertionError(f"{label}: {len(runs)} result.json files")
        rj = json.loads(runs[0].read_text())
        cycles = [json.loads(line) for line in
                  (runs[0].parent / "cycle_times.jsonl").read_text()
                  .splitlines()]
        if vis:
            figures = entry_figures(runs[0].parent, rj, timing, failed)
            log(f"{label}: figures " + json.dumps(figures) + f"; {card}")
    phase_sums, table, bad = loop_report(label, rj, cycles, counts, calls,
                                         loop_s, n, rounds, card)
    failed += bad
    labeled = set()
    for r, query in rj["query_list"].items():
        outside = [q for q in query if not 0 <= q < n]
        again = sorted(set(query) & labeled)
        if outside or again or len(set(query)) != len(query):
            failed.append(f"round {r}'s query: outside the pool {outside}, "
                          f"labeled before {again}, {len(query)} entries "
                          f"for {len(set(query))} samples")
        labeled |= set(query)
    passes, steps = calls.score_calls, calls.train_steps
    want_n = {"fused_bottleneck_chain": 4 * passes,
              "fused_postprocess": passes, "rot_warp_crop": passes + steps,
              "deform_im2col": 0, "shuffle_conv3x3": 0}
    if passes != rounds + 1 or steps == 0 or counts != want_n:
        failed.append(f"launches {counts}, want {want_n} for {passes} "
                      f"passes and {steps} steps")
    if failed:
        raise AssertionError(f"{label}: " + "; ".join(failed))
    return {"loop_s": loop_s, "passes": passes, "train_steps": steps,
            "samples": n, "launches": counts, "phase_s": phase_sums,
            "rounds": table, "figures": figures}


def entry_figures(work_dir, rj, timing, failed):
    """The figures a --vis --vis_thc --vis_wpu loop wrote under work_dir:
    counted by kind against the calls the loop made, the first of each
    kind read back at its size.  Returns {kind: count, ms each}."""
    kinds = {"visualize_thc": ("vis_thc", "thc_*.png", None),
             "visualize_wpu": ("vis_wpu", "wpu_*.png", (640, 480)),
             "plot_embedding_selection": ("cluster", "*.png", (640, 480))}
    summary = timing.summary()
    out = {}
    for name, (sub, pattern, size) in kinds.items():
        files = sorted((work_dir / sub).rglob(pattern))
        calls = summary[name]["count"]
        out[sub] = {"files": len(files), "calls": calls,
                    "ms_each": summary[name]["ms_each"]}
        if not files or len(files) > calls:
            failed.append(f"{sub}: {len(files)} files for {calls} calls")
            continue
        png_pixels(files[0], size)
    queried = sum(1 for q in rj["query_list"].values() if len(q))
    if out["cluster"]["files"] != queried:
        failed.append(f"{out['cluster']['files']} cluster figures for "
                      f"{queried} queried rounds")
    return out


# phase 14: the library tail.  The card's f32 reductions sum in another
# order than the CPU's: the decoded coordinates (in [-0.5, 0.5)) and the
# maxima within LIB_COORD_ATOL, the loss within LIB_LOSS_RTOL, its
# gradient within LIB_GRAD_RTOL of the gradient's largest element
LIB_NORMS = ("softmax", "sigmoid", "divide_sum")
LIB_COORD_ATOL = 1e-5
LIB_LOSS_RTOL = 1e-5
LIB_GRAD_RTOL = 1e-4


def phase_library_tail(video, seed, card):
    """The port's library functions that no CLI path calls, at full width.
    (1) On seeded (512, 17, 64, 48) f32 maps (uniform in [0, 1): divide_sum
    divides by the sum), made on the CPU and moved to the card, with
    seeded (u, v) targets and weights: integral_coords and
    l1_joint_regression_loss forward and backward for each norm type, the
    card against the CPU (LIB_*), the card's ms of a loss forward and
    backward printed.  (2) flip_heatmap with and without the shift
    bit-identical to the CPU; unshifted, applied twice, the input.
    (3) Phase 3's seeded R50 state_dict through save_checkpoint (no .pkl
    suffix: the file is path + .pkl) and load_checkpoint; try_load onto a
    SimplePose-R50 of 14 joints loads every entry but the final layer's
    weight and bias, onto R50 itself every entry (num_batches_tracked
    not counted); a THC+WPU pass of 512 with the reloaded weights, on
    deterministic algorithms, gives heatmaps bit-identical to the same
    pass before the save, with K1 4, K2 1 and K3 1 launches (counters
    reset before it)."""
    import os
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import reset_launch_counts
    from vatl4pose_tpu_torch.models import (SimplePose,
                                            l1_joint_regression_loss)
    from vatl4pose_tpu_torch.ops import flip_heatmap, integral_coords
    from vatl4pose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint,
                                                      try_load)
    t_phase = time.perf_counter()
    failed = []
    gen = torch.Generator().manual_seed(seed)
    hms = torch.rand(HM_SHAPE, generator=gen)
    n, k = HM_SHAPE[:2]
    uv = torch.rand(n, 2 * k, generator=gen) - 0.5
    w = (torch.rand(n, 2 * k, generator=gen) > 0.2).float()
    hms_dev, uv_dev, w_dev = hms.cuda(), uv.cuda(), w.cuda()

    def decode_and_loss(h, uv, w, norm):
        h = h.detach().requires_grad_(True)
        coords, maxvals = integral_coords(h.detach(), norm)
        loss = l1_joint_regression_loss(h, uv, w, norm)
        loss.backward()
        return coords, maxvals, loss.detach(), h.grad

    decode = {}
    for norm in LIB_NORMS:
        cpu = decode_and_loss(hms, uv, w, norm)
        dev = [t.cpu() for t in decode_and_loss(hms_dev, uv_dev, w_dev,
                                                norm)]
        err = {"coords": (dev[0] - cpu[0]).abs().max().item(),
               "maxvals": (dev[1] - cpu[1]).abs().max().item(),
               "loss_rel": ((dev[2] - cpu[2]).abs() / cpu[2].abs()).item(),
               "grad_rel": ((dev[3] - cpu[3]).abs().max()
                            / cpu[3].abs().max()).item()}
        err["ms"] = cuda_ms(lambda: decode_and_loss(hms_dev, uv_dev, w_dev,
                                                    norm), reps=5)
        decode[norm] = err
        log(f"library tail {norm}: card vs CPU on {tuple(HM_SHAPE)} f32: "
            f"coords {err['coords']:.3e}, maxvals {err['maxvals']:.3e} "
            f"(bar {LIB_COORD_ATOL}), loss rel {err['loss_rel']:.3e} (bar "
            f"{LIB_LOSS_RTOL}), grad max|err|/max {err['grad_rel']:.3e} "
            f"(bar {LIB_GRAD_RTOL}); decode + loss forward and backward "
            f"{err['ms']:.3f} ms on the card")
        if not (err["coords"] <= LIB_COORD_ATOL
                and err["maxvals"] <= LIB_COORD_ATOL
                and err["loss_rel"] <= LIB_LOSS_RTOL
                and err["grad_rel"] <= LIB_GRAD_RTOL):
            failed.append(f"{norm}: card vs CPU {err}")

    flips = {}
    for shift in (True, False):
        got = flip_heatmap(hms_dev, video.joint_pairs, shift)
        flips[shift] = torch.equal(
            got.cpu(), flip_heatmap(hms, video.joint_pairs, shift))
    inverse = torch.equal(flip_heatmap(flip_heatmap(
        hms_dev, video.joint_pairs, False), video.joint_pairs, False),
        hms_dev)
    log(f"library tail flip_heatmap: card bit-identical to the CPU (shift "
        f"True/False) {flips}; unshifted twice gives the input {inverse}")
    if not all(flips.values()) or not inverse:
        failed.append(f"flip_heatmap {flips}, inverse {inverse}")
    del hms_dev, uv_dev, w_dev

    model, ae = make_models(seed)
    sd = model.state_dict()
    entries = sum(not key.endswith("num_batches_tracked") for key in sd)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_checkpoint(os.path.join(tmp, "simplepose_r50"), sd)
        size = os.path.getsize(path)
        back = load_checkpoint(path)
    if not path.endswith("simplepose_r50.pkl") or sorted(back) != sorted(sd):
        failed.append(f"save/load: {path}, {len(back)} of {len(sd)} keys")
    m14 = SimplePose(**dict(MODEL, num_joints=14), fused_eval=True,
                     device="cpu").state_dict()
    merged14, n14 = try_load(m14, back)
    kept = [key for key in m14 if merged14[key].shape != sd[key].shape
            or not torch.equal(merged14[key], sd[key])]
    fresh = SimplePose(**MODEL, fused_eval=True, device="cpu")
    merged, n_all = try_load(fresh.state_dict(), back)
    same = all(torch.equal(merged[key], sd[key]) for key in sd)
    log(f"library tail checkpoint: {len(sd)} entries ({entries} without "
        f"num_batches_tracked), {size / 1e6:.1f} MB at {path}; try_load "
        f"onto 14 joints loaded {n14}, kept {kept}; onto R50 loaded "
        f"{n_all}, equal to the saved weights {same}")
    if n14 != entries - 2 or sorted(kept) != ["final_layer.bias",
                                              "final_layer.weight"]:
        failed.append(f"try_load onto 14 joints: {n14} of {entries}, kept "
                      f"{kept}")
    if n_all != entries or not same:
        failed.append(f"try_load onto R50: {n_all} of {entries}, equal "
                      f"{same}")
    fresh.load_state_dict(merged)

    ae.cuda()
    passes, counts = {}, None
    for label, net in (("before the save", model), ("reloaded", fresh)):
        net.cuda()
        engine = ScoringEngine(net, ScoringConfig(uncertainty="THC+WPU",
                                                  input_size=INPUT_SIZE),
                               ae_model=ae, chunk=BATCH)
        with deterministic():
            reset_launch_counts()
            res = engine.score(*video.args, keep_heatmaps=True)
            torch.cuda.synchronize()
        counts = launch_counts()
        passes[label] = res["heatmaps"]
        net.cpu()
        del engine, res
    bit = torch.equal(passes["before the save"], passes["reloaded"])
    want = {"fused_bottleneck_chain": 4, "fused_postprocess": 1,
            "rot_warp_crop": 1,
            "deform_im2col": 0, "shuffle_conv3x3": 0}
    log(f"library tail reload: THC+WPU pass of {len(video.data)} with the "
        f"reloaded weights, heatmaps bit-identical to the pass before the "
        f"save {bit}; launches {counts} (want {want})")
    if not bit:
        failed.append("the reloaded weights' heatmaps differ")
    if counts != want:
        failed.append(f"reload pass launches {counts}, want {want}")
    del passes, model, fresh, ae
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"library tail: {wall:.1f} s ({card})")
    if failed:
        raise AssertionError("library tail: " + "; ".join(failed))
    return {"launches": counts, "decode": decode, "flip_exact": flips,
            "checkpoint_bytes": size, "try_load_14_joints": n14,
            "try_load_r50": n_all, "wall_s": wall}


def check_outputs(res, n):
    import numpy as np
    shapes = {"coords": (n, 17, 2), "scores": (n, 17), "kpts": (n, 51),
              "oks": (n,), "det_score": (n,), "unc": (n,), "unc2": (n,),
              "gc": (n,), "embeddings": (n, 2048), "bbox_crop": (n, 4)}
    for k, shape in shapes.items():
        v = res[k]
        if v.shape != shape or not np.isfinite(v).all():
            raise AssertionError(f"output {k}: shape {v.shape}, finite "
                                 f"{np.isfinite(v).all()}")
    hm = res["heatmaps"]
    if tuple(hm.shape) != (n, 17, 64, 48) or not hm.isfinite().all():
        raise AssertionError("heatmaps: wrong shape or not finite")


def main(argv=None):
    import os
    argv = sys.argv[1:] if argv is None else argv
    # deterministic cuBLAS (phases 7 and 11) needs its workspace fixed
    # before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "vatl4pose_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    if argv[:1] == ["--dp-loop-rank"]:
        return dp_loop_rank(argv[1])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # parity mode: no TF32 anywhere (the JAX tests pin 'highest')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = 0

    t_run = time.perf_counter()
    t0 = t_run

    def phase(title):
        nonlocal t0
        now = time.perf_counter()
        log(f"   (phase wall {now - t0:.1f} s)")
        t0 = now
        log(f"== {title}")

    log("== phase 1: card and build")
    card = phase_card_and_build()
    video = make_video(seed)
    phase("phase 2: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1 = {"f32": phase_chain_kernel(torch.float32, gen),
          "bf16": phase_chain_kernel(torch.bfloat16, gen)}
    k2 = phase_postprocess_kernel(gen)
    k3 = phase_rot_warp_kernel(video, seed)
    phase("phase 3: scoring path")
    counts, rates, model, ae, hm_f32 = phase_main_path(video, seed)
    phase("phase 4: training path")
    train = phase_retrain(video, model, ae, hm_f32, seed)
    phase_step_check(video, seed)
    del model, ae, hm_f32
    torch.cuda.empty_cache()
    phase("phase 5: AL loop")
    al = phase_al_loop(video, card, seed)
    phase("phase 6: AL loop --speedup")
    al_bf16 = phase_al_loop(video, card, seed, speedup=True)
    log("AL loop wall and split, s: f32 " + json.dumps(
        dict(al["phase_s"], wall=al["loop_s"])) + "; --speedup "
        + json.dumps(dict(al_bf16["phase_s"], wall=al_bf16["loop_s"])))
    torch.cuda.empty_cache()
    phase("phase 7: streaming AL loop")
    jrdb_state, stream = phase_streaming_loop(card, seed)
    phase("phase 8: C1, the loop on the card against the CPU")
    c1 = phase_c1_loop(card, seed)
    phase("phase 9: the other strategies")
    other = {"scoring": phase_other_scoring(video, seed),
             "loops": phase_other_loops(video, card, seed),
             "study": phase_study(video, seed)}
    phase("phase 10: the other models, the plain kernels, Fast Pose (DCN)")
    zoo = {"passes": phase_zoo_passes(video, seed),
           "retrain": phase_zoo_retrain(video, seed),
           "hrnet_loop": phase_hrnet_loop(video, card, seed),
           "plain_kernels": phase_plain_kernels(seed),
           "fastpose_dcn": phase_fastpose_dcn(video, seed)}
    hr = zoo["hrnet_loop"]
    log("AL loop HRNet-W32 wall and split, s: " + json.dumps(
        dict(hr["phase_s"], wall=hr["loop_s"])) + "; scoring samples/s "
        + json.dumps({m: {p: r["samples_per_s"] for p, r in v.items()
                          if p in ("f32", "bf16")}
                      for m, v in zoo["passes"].items()})
        + "; retrain ms/step " + json.dumps(
            {m: r["ms_per_step"] for m, r in zoo["retrain"].items()}))
    torch.cuda.empty_cache()
    phase("phase 11: the pre-training, evaluation and AE-training paths")
    pre = phase_pretraining(video, card, seed, init_state=jrdb_state)
    del jrdb_state
    torch.cuda.empty_cache()
    phase("phase 12: analysis, tracking evaluation and --vis")
    vis = {"loop": phase_vis_loop(video, card, seed, al),
           "hooks": phase_vis_hooks(video, seed)}
    t12 = time.perf_counter()
    vis["analysis"] = phase_analysis(video, card)
    vis["tracking"] = phase_tracking(card)
    vis["host_s"] = time.perf_counter() - t12
    log(f"phase 12, the analysis CLIs, pose_track_eval and JRDB AP: "
        f"{vis['host_s']:.3f} s on the host ({card})")
    torch.cuda.empty_cache()
    phase("phase 13: data parallel, two gloo ranks on the card")
    dp = {}
    dp["noop"], round0 = phase_dp_noop(video, seed, card)
    dp.update(phase_dp_steps(video, card, seed))
    torch.cuda.empty_cache()
    dp["loop"] = phase_dp_loop(video, seed, card, round0)
    del round0
    log("AL loop --data_parallel wall and split, s: " + json.dumps(
        dict(dp["loop"]["phase_s"], wall=dp["loop"]["loop_s"])) + "; phase "
        "5's " + json.dumps(dict(al["phase_s"], wall=al["loop_s"])))
    torch.cuda.empty_cache()
    phase("phase 14: the library tail")
    lib = phase_library_tail(video, seed, card)
    first_frames = video.frames[:ENCODE_FRAMES].copy()
    del video
    torch.cuda.empty_cache()
    phase("phase 15: the entry points as a user starts them")
    written = tempfile.TemporaryDirectory()
    entry = {"configs": phase_configs(), "jpeg": phase_jpeg_decode(),
             "jpeg_encode": phase_jpeg_encode(first_frames, written.name)}
    del first_frames
    entry["main"] = phase_entry_main(card, seed, video_root=written.name)
    written.cleanup()
    entry["main_vis"] = phase_entry_main(card, seed, vis=True)
    entry["formats"] = phase_formats(card)
    log("AL main() on JPEG frames, wall and split, s: " + json.dumps(
        dict(entry["main"]["phase_s"], wall=entry["main"]["loop_s"]))
        + "; phase 5's " + json.dumps(dict(al["phase_s"], wall=al["loop_s"]))
        + "; with " + " ".join(ENTRY_VIS_FLAGS) + " (QUERY_RATIO "
        + f"{ENTRY_VIS_QUERY_RATIO}: 3 rounds) "
        + json.dumps(dict(entry["main_vis"]["phase_s"],
                          wall=entry["main_vis"]["loop_s"]))
        + f"; {card}")
    phase("phase 16: result")

    # launches by main path, each counted from 0: the scoring passes
    # (phase 3), the retrain (phase 4), the AL loops (phase 5 in f32, 6
    # with --speedup, 7 streaming) and the card's C1 loop (phase 8)
    al_n, bf_n, st_n, c1_n = (r["launches"] for r in (al, al_bf16, stream,
                                                      c1))
    # phase 9's paths, f32: the five scoring passes, the two loops, the study
    other_n = {"other_scoring": {
        k: sum(r["launches"][k] for r in other["scoring"].values())
        for k in counts["f32"]}}
    other_n.update({f"al_loop_{key}": r["launches"]
                    for key, r in other["loops"].items()})
    other_n["optimize_study"] = other["study"]["launches"]
    # phase 10's paths: each model's passes (the bf16 ones apart),
    # FastPose's VL4Pose pass, the retrains and the HRNet loop
    zoo_bf16 = {}
    for label, r in zoo["passes"].items():
        key = label.split("-")[0].lower()
        other_n[f"{key}_scoring_f32"] = r["f32"]["launches"]
        zoo_bf16[f"{key}_scoring_bf16"] = r["bf16"]["launches"]
        if "vl4pose" in r:
            other_n[f"{key}_scoring_vl4pose"] = r["vl4pose"]["launches"]
    for label, r in zoo["retrain"].items():
        other_n[f"{label.split('-')[0].lower()}_retrain"] = r["launches"]
    other_n["al_loop_hrnet"] = zoo["hrnet_loop"]["launches"]
    dcn = zoo["fastpose_dcn"]
    other_n["fastpose_dcn_scoring_f32"] = dcn["launches"]
    other_n["fastpose_dcn_scoring_f32_halves"] = dcn["launches_halves"]
    other_n["fastpose_dcn_scoring_eager"] = dcn["launches_eager"]
    other_n["fastpose_dcn_scoring_eager_duc"] = dcn["launches_eager_duc"]
    # phase 7's pre-training (jrdbpose_train) and phase 11's paths
    other_n["pretrain_jrdb_wide"] = stream["pretrain"]["launches"]
    for key in ("resident", "streaming", "eval", "handoff"):
        other_n[f"pretrain_{key}"] = pre[key]["launches"]
    # phase 12's paths: the --vis loop and the hooks' scoring pass
    other_n["al_loop_vis"] = vis["loop"]["launches"]
    other_n["vis_hooks_scoring"] = vis["hooks"]["launches"]
    # phase 13's paths, each summed over the ranks: the one-process
    # --data_parallel round, the DP step, the DP pass and the DP loop
    other_n["dp_noop_round0"] = dp["noop"]["launches"]
    other_n["dp_train_step"] = dp["step"]["launches"]
    other_n["dp_scoring"] = dp["pass"]["launches"]
    other_n["dp_al_loop"] = dp["loop"]["launches"]
    # phase 14's pass with the weights reloaded through the checkpoint
    other_n["library_tail_reload"] = lib["launches"]
    # phase 15's loops, started through run_active_learning.main
    other_n["entry_main_al_loop"] = entry["main"]["launches"]
    other_n["entry_main_vis_al_loop"] = entry["main_vis"]["launches"]
    k1_launches = {"f32": {"scoring_f32": counts["f32"]["fused_bottleneck_chain"],
                           "al_loop": al_n["fused_bottleneck_chain"],
                           "al_loop_streaming":
                           st_n["fused_bottleneck_chain"],
                           "c1_loop": c1_n["fused_bottleneck_chain"],
                           **{k: v["fused_bottleneck_chain"]
                              for k, v in other_n.items()}},
                   "bf16": {"scoring_bf16":
                            counts["bf16"]["fused_bottleneck_chain"],
                            "al_loop_speedup":
                            bf_n["fused_bottleneck_chain"],
                            **{k: v["fused_bottleneck_chain"]
                               for k, v in zoo_bf16.items()}}}
    kernels = []
    for mode in ("f32", "bf16"):
        kernels.append({
            "name": f"fused_bottleneck_chain_{mode}", "route": "cuda",
            "source": "vatl4pose_tpu_torch/csrc/fused_bottleneck.cu",
            "replaces": "vatl4pose_tpu/kernels/fused_bottleneck.py:111",
            "launches": sum(k1_launches[mode].values()),
            "launches_by_path": k1_launches[mode],
            "max_abs_err": k1[mode]["max_abs_err"], "ms": k1[mode]["ms"],
            "plain_ms": k1[mode]["plain_ms"],
            "bound_ms": k1[mode]["bound_ms"],
            "bound_by": k1[mode]["bound_by"], "library_ms": None})
    k2_launches = {"scoring_f32": counts["f32"]["fused_postprocess"],
                   "scoring_bf16": counts["bf16"]["fused_postprocess"],
                   "al_loop": al_n["fused_postprocess"],
                   "al_loop_speedup": bf_n["fused_postprocess"],
                   "al_loop_streaming": st_n["fused_postprocess"],
                   "c1_loop": c1_n["fused_postprocess"],
                   **{k: v["fused_postprocess"]
                      for k, v in {**other_n, **zoo_bf16}.items()}}
    kernels.append({
        "name": "heatmap_postprocess_f32", "route": "cuda",
        "source": "vatl4pose_tpu_torch/csrc/postprocess.cu",
        "replaces": "vatl4pose_tpu/kernels/pallas_postprocess.py:129",
        "launches": sum(k2_launches.values()),
        "launches_by_path": k2_launches,
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None})
    # K3's instances on the main paths (the float32-frame instances and the
    # copy variants run in phase 2 only); both replace the shear kernels of
    # rot_warp.py:459 and :162 (one function).  ms and bound at the shape
    # the instance launches at most: the retrain batch for u8_f32, the
    # scoring chunk for u8_bf16
    k3_launches = {"u8_f32": {"retrain": train["k3_launches"],
                              "scoring_f32": counts["f32"]["rot_warp_crop"],
                              "al_loop": al_n["rot_warp_crop"],
                              "al_loop_streaming": st_n["rot_warp_crop"],
                              "c1_loop": c1_n["rot_warp_crop"],
                              **{k: v["rot_warp_crop"]
                                 for k, v in other_n.items()}},
                   "u8_bf16": {"scoring_bf16":
                               counts["bf16"]["rot_warp_crop"],
                               "al_loop_speedup": bf_n["rot_warp_crop"],
                               **{k: v["rot_warp_crop"]
                                  for k, v in zoo_bf16.items()}}}
    for inst, shape in (("u8_f32", "retrain_f32"),
                        ("u8_bf16", "scoring_bf16")):
        r = k3[shape]
        kernels.append({
            "name": f"rot_warp_{inst}", "route": "cuda",
            "source": "vatl4pose_tpu_torch/csrc/rot_warp.cu",
            "replaces": "vatl4pose_tpu/kernels/rot_warp.py:459",
            "launches": sum(k3_launches[inst].values()),
            "launches_by_path": k3_launches[inst],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K4 on the Fast Pose (DCN) passes (phase 10); ms and bound over the
    # 13 deformable 3x3s of a chunk of 512, its columns bit for bit
    k4_launches = {k: v["deform_im2col"] for k, v in other_n.items()
                   if v.get("deform_im2col")}
    kernels.append({
        "name": "deform_im2col_f32", "route": "cuda",
        "source": "vatl4pose_tpu_torch/csrc/deform_im2col.cu",
        "replaces": "vatl4pose_tpu/kernels/deform_conv.py",
        "launches": sum(k4_launches.values()),
        "launches_by_path": k4_launches, "max_abs_err": 0.0,
        "ms": dcn["k4_ms"], "plain_ms": dcn["eager_ms"],
        "bound_ms": dcn["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    log(json.dumps({"scoring_samples_per_s": rates, "retrain": train,
                    "al_loop": al, "al_loop_speedup": al_bf16,
                    "al_loop_streaming": stream, "c1_loop": c1,
                    "other_strategies": other, "other_models": zoo,
                    "pretraining": pre, "analysis_and_vis": vis,
                    "data_parallel": dp, "library_tail": lib,
                    "entry_points": entry,
                    "k1_f32_from_f64": {
                        "random": k1["f32"]["f64_err"],
                        "random_plain": k1["f32"]["plain_f64_err"],
                        "cancelling": k1["f32"]["cancel_err"],
                        "cancelling_cudnn": k1["f32"]["cancel_plain_err"],
                        "retrained": al["fold_check"]},
                    "k1_unfused_floor_ms": {m: k1[m]["floor_ms"] for m in k1},
                    "k1_cudnn_chain_ms": {m: k1[m]["cudnn_ms"] for m in k1},
                    "k2_wrapper_ms": k2["wrapper_ms"], "k3": k3,
                    "card": card, "wall_s": time.perf_counter() - t_run}))
    print(json.dumps({"host_warp": dict(
        stream["host_warp"], source="native/warp/warp_affine.cpp",
        binding="vatl4pose_tpu_torch/data/native_warp.py", route="c++",
        path="al_loop_streaming")}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
