"""Main VATL entry point of the port (counterpart of
vatl4pose_tpu/cli/run_active_learning.py; scripts/Run_active_learning.py).

    python -m vatl4pose_tpu_torch.cli.run_active_learning \\
        --cfg configs/posetrack21/al_simple_posetrack.yaml --video_id 000342 \\
        --uncertainty THC+WPU --representativeness Influence \\
        --filter Coreset --continual --seedfix

The same flag surface as the JAX package's CLI, plus --device (default
CUDA; `--device cpu` runs the kernels' plain versions on the CPU).  The
strategy name, work-dir layout, do_al loop and the 20-field result.json
follow Run_active_learning.py:123-244; a comma-separated --video_id runs
the videos one after another in one process.  --synthetic generates a
video instead of reading PoseTrack21/JRDB from disk.  --speedup serves
and retrains in bf16 and lets f32 products use TF32, as the JAX package
drops its 'highest' matmul precision; without it every f32 product is
full f32 (parity mode).  A video whose frames exceed
VAL.HBM_FRAME_BUDGET_GB streams from host RAM.  --optimize searches
VAL.UNC_LAMBDA for the best mean ALC (al/optuna_lite.py, TPE or a grid;
`optimize_alc` is `run_study` plus the two plots).
--vis writes each round's heatmaps (float16), ann ids and predictions
under the work dir and, under the Coreset, K-Means and weighted filters,
the cluster figure; --vis_thc and --vis_wpu draw the two criteria's
figures (all drawn by utils/figure.py, without matplotlib).

Data parallel, one process a rank (parallel/mesh.py):

    torchrun --standalone --nproc_per_node N \
        -m vatl4pose_tpu_torch.cli.run_active_learning --data_parallel ...

shards each scoring pass's stage 1 and each retrain step's batch over the
N ranks (nccl when each rank has a card of its own, gloo when ranks share
one or run on the CPU).  Every rank runs the loop; rank 0 alone makes the
work dir and the synthetic video, logs and writes files.  Without
torchrun (WORLD_SIZE unset or 1) --data_parallel does nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime

import numpy as np

from ..parallel import (broadcast_object, init_distributed, is_primary,
                        world_size)

__all__ = ["parse_args", "setup_opt", "set_dir", "prepare_synthetic",
           "prepare_dataset_paths", "do_al", "save_result", "run_study",
           "optimize_alc", "run", "main"]


def _log(msg):
    """Printed by rank 0 alone under data parallel."""
    if is_primary():
        print(msg, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Active Learning Script (H100)")
    p.add_argument("--cfg", type=str, default="configs/al_simple.yaml")
    p.add_argument("--uncertainty", type=str, default="None")
    p.add_argument("--representativeness", type=str, default="None")
    p.add_argument("--filter", type=str, default="None")
    p.add_argument("--video_id", type=str, required=True,
                   help="video id, or comma-separated list run one after "
                        "another in one process")
    p.add_argument("--wunc", type=float, default=0.01)
    p.add_argument("--retrain_thresh", type=float, default=1)
    p.add_argument("--verbose", action="store_true",
                   help="dataset smoke info + a torch.profiler trace of the "
                        "first AL cycle under work_dir/trace (the "
                        "reference's opt.profile analog, "
                        "Run_active_learning.py:100-103)")
    p.add_argument("--speedup", action="store_true",
                   help="bf16 serving through the folded chain AND bf16 "
                        "mixed-precision retraining, TF32 for f32 products "
                        "(not reproducible against parity mode)")
    p.add_argument("--seedfix", action="store_true")
    p.add_argument("--vis", action="store_true")
    p.add_argument("--memo", type=str, default="test")
    p.add_argument("--from_scratch", action="store_true")
    p.add_argument("--onebyone", action="store_true")
    p.add_argument("--stopping", action="store_true",
                   help="stop once 'our SC' fires (parsed but never "
                        "consumed in the reference, Run_active_learning.py:75)")
    p.add_argument("--continual", action="store_true")
    p.add_argument("--optimize", action="store_true",
                   help="search VAL.UNC_LAMBDA for the best mean ALC over "
                        "the train videos (Run_active_learning.py:175-209)")
    p.add_argument("--search", choices=["tpe", "grid"], default="tpe",
                   help="--optimize sampler: TPE (the reference's intended "
                        "default) or grid (its shipped single-point "
                        "GridSampler path, widened)")
    p.add_argument("--n_trials", type=int, default=30)
    p.add_argument("--PCIT", action="store_true")
    p.add_argument("--fixed_lambda", action="store_true")
    p.add_argument("--THCvsWPU", choices=["const", "increase", "decrease"],
                   default="const")
    p.add_argument("--vis_thc", action="store_true")
    p.add_argument("--vis_wpu", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic video instead of reading "
                        "PoseTrack21/JRDB from disk")
    p.add_argument("--synth_frames", type=int, default=8)
    p.add_argument("--synth_persons", type=int, default=3)
    p.add_argument("--synth_seed", type=int, default=None,
                   help="seed for the generated video (defaults to the run "
                        "seed)")
    p.add_argument("--synth_shift", type=float, nargs=4, default=None,
                   metavar=("CH", "SIGMA", "AMP", "BG"),
                   help="appearance shift (channel_shift, blob_sigma, "
                        "blob_amp, bg_level) for the generated video")
    p.add_argument("--synth_size", type=int, nargs=2, default=[320, 240],
                   metavar=("W", "H"))
    p.add_argument("--data_parallel", action="store_true",
                   help="under torchrun: scoring and retraining sharded "
                        "over the ranks (a no-op on one rank)")
    p.add_argument("--checkpoint_state", action="store_true",
                   help="checkpoint the AL state every round "
                        "(work_dir/al_state.pkl)")
    p.add_argument("--resume", type=str, default=None,
                   help="resume a half-done run from its al_state.pkl")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; CUDA when not given")
    return p.parse_args(argv)


def setup_opt(opt):
    """The run seed, and the precision: parity mode (f32 everywhere, no
    TF32) unless --speedup."""
    import torch
    speedup = bool(getattr(opt, "speedup", False))
    torch.backends.cudnn.allow_tf32 = speedup
    torch.set_float32_matmul_precision("high" if speedup else "highest")
    opt.seed = None
    if opt.seedfix:
        opt.seed = 166
        np.random.seed(166)
    return opt


def set_dir(cfg, opt):
    """Strategy-name composition + work dir (Run_active_learning.py:123-163)."""
    if opt.uncertainty == "None" and opt.representativeness == "None":
        if opt.filter == "None":
            raise ValueError(
                "Uncertainty, representativeness, and filter cannot be None "
                "at the same time! \n --> Please specify one of them.")
        opt.strategy = ""
    elif opt.uncertainty == "None":
        opt.strategy = opt.representativeness
    elif opt.representativeness == "None":
        opt.strategy = opt.uncertainty
    else:
        opt.strategy = opt.uncertainty + "+" + opt.representativeness
    if opt.filter != "None":
        opt.strategy = opt.strategy + "_" + opt.filter + "filter"
    opt.get_prenext = "TPC" in opt.uncertainty or "THC" in opt.uncertainty

    timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    sub = "optimize" if opt.optimize else opt.video_id
    # under data parallel, rank 0's name (its clock's) on every rank
    opt.work_dir = broadcast_object(os.path.join(
        "exp", f"AL_{opt.memo}", cfg.MODEL.TYPE, opt.strategy or "filteronly",
        sub, timestamp))
    if is_primary():
        os.makedirs(opt.work_dir, exist_ok=False)
    return opt


def prepare_synthetic(cfg, opt):
    """A synthetic video in a fresh temporary directory, set as both
    dataset splits (made by rank 0 under data parallel)."""
    if is_primary():
        root, ann = _make_synthetic(cfg, opt)
    else:
        root = ann = None
    root, ann = broadcast_object((root, ann))
    for split in ("EVAL", "TRAIN"):
        cfg.DATASET[split].ROOT = root
        cfg.DATASET[split].ANN = ann
        cfg.DATASET[split].IMG_PREFIX = ""
    return cfg


def _make_synthetic(cfg, opt):
    import tempfile
    from ..data.synthetic import make_synthetic_video
    root = tempfile.mkdtemp(prefix="vatl_synth_")
    seed = opt.synth_seed if getattr(opt, "synth_seed", None) is not None \
        else (opt.seed or 166)
    extra = {}
    if getattr(opt, "synth_shift", None):
        ch, sig, amp, bg = opt.synth_shift
        extra = dict(channel_shift=int(ch), blob_sigma=sig, blob_amp=amp,
                     bg_level=bg)
    if cfg.DATASET.EVAL.TYPE == "JRDB2022":
        # JRDB composite ids use 3-digit track suffixes (jrdb2022.py)
        extra["track_digits"] = 3
    _, ann = make_synthetic_video(
        root, video_id=opt.video_id, seed=seed,
        num_frames=opt.synth_frames, num_persons=opt.synth_persons,
        width=opt.synth_size[0], height=opt.synth_size[1], **extra)
    return root, ann


def prepare_dataset_paths(cfg, opt):
    """Per-video annotation paths (ActiveLearning.py:68-95)."""
    if getattr(opt, "synthetic", False):
        return
    ds = cfg.DATASET.EVAL.TYPE
    vid = opt.video_id
    if ds == "Posetrack21":
        if opt.optimize:
            img = f"images/train/{vid}_bonn_train/"
            ann = f"activelearning/train_val/{vid}_bonn_train.json"
        else:
            img = f"images/val/{vid}_mpii_test/"
            ann = f"activelearning/val/{vid}_mpii_test.json"
    elif getattr(opt, "PCIT", False):
        img = f"images/{vid}_PCIT_eval/"
        ann = f"annotations/eval/{vid}.json"
    elif ds == "JRDB2022":
        split = "val" if opt.optimize else "test"
        listfile = f"configs/jrdb-pose/jrdb_{split}.txt"
        with open(listfile) as f:
            scene = f.readlines()[int(vid)].strip()
        img = f"images/image_stitched/{scene}/"
        ann = f"activelearning/{split}/{vid}_jrdb-pose.json"
    else:
        raise ValueError(f"unknown dataset {ds}")
    for split_key in ("EVAL", "TRAIN"):
        cfg.DATASET[split_key].IMG_PREFIX = img
        cfg.DATASET[split_key].ANN = ann


def do_al(cfg, opt):
    """One video's AL loop: eval_and_query then outcome, round after round,
    until outcome returns the result.  Rank 0 alone logs and checkpoints
    under data parallel."""
    from ..al.active_learning import ActiveLearning
    prepare_dataset_paths(cfg, opt)
    al = ActiveLearning(cfg, opt)
    if getattr(opt, "resume", None):
        al.load_state(opt.resume)
        _log(f"resumed from {opt.resume} at round {al.round_cnt}")
    t0 = time.time()
    cycles = 0
    while True:
        tc = time.time()
        if cycles == 0 and getattr(opt, "verbose", False):
            # opt.profile analog (Run_active_learning.py:100-103): a trace
            # of the first scoring and selection cycle
            from ..utils.profiling import trace
            with trace(os.path.join(opt.work_dir, "trace")):
                al.eval_and_query()
        else:
            al.eval_and_query()
        result = al.outcome()
        cycles += 1
        _log(f"[cycle {cycles}] wall {time.time() - tc:.2f}s")
        if getattr(opt, "checkpoint_state", False) and result is None \
                and is_primary():
            al.save_state()
        if result is not None:
            _log(f"Active learning finished! total {time.time() - t0:.1f}s")
            break
    return result


def save_result(cfg, opt, result):
    """result.json with the reference's field set
    (Run_active_learning.py:211-244), written by rank 0 alone under data
    parallel; every rank returns its path."""
    rj = {
        "config_file": opt.cfg,
        "video_id": opt.video_id,
        "strategy": opt.strategy,
        "model": cfg.MODEL.TYPE,
        "percentages": result[0],
        "performances": result[1],
        "performances_ann": result[2],
        "query_list": result[3],
        "uncertaity": result[4],
        "influence": result[6],
        "combine_weight": result[7],
        "mean_uncertaity": result[5],
        "spearmanr": result[8],
        "corrcoef": result[9],
        "true_labeled": result[10],
        "true_unlabeled": result[11],
        "false_labeled": result[12],
        "false_unlabeled": result[13],
        "actual_finish": result[14],
        "finished_minerror": result[15],
        "finished_oursc": result[16],
        "ospa": result[17],
        "ospa_ann": result[18],
        "moks_queried": result[19],
    }
    path = os.path.join(opt.work_dir, "result.json")
    if is_primary():
        with open(path, "w") as f:
            json.dump(rj, f)
        _log(f"Result saved to: {path}!")
    return path


def run_study(cfg, opt, video_list, n_trials=None):
    """The search over VAL.UNC_LAMBDA that maximises the mean ALC of AP .95
    with annotations (Run_active_learning.py:175-209): QUERY_RATIO
    [0.05, 0.1, 0.2, 0.3, 0.4, 1] (:201), each trial one do_al per video.
    --search tpe: the TPE study that the reference's commented default
    sampler implies (suggest_float 0.001..100, log scale, --n_trials);
    --search grid: six values from 0.001 to 100 (the reference's shipped
    GridSampler holds one).  `n_trials` overrides the trial count.
    Returns the study."""
    from ..al.al_metric import compute_alc
    from ..al.optuna_lite import GridSampler, TPESampler, create_study

    cfg.VAL.QUERY_RATIO = [0.05, 0.1, 0.2, 0.3, 0.4, 1]

    def objective(trial):
        cfg.VAL.UNC_LAMBDA = trial.suggest_float("unc_lambda", 0.001, 100,
                                                 log=True)
        alcs = []
        for video in video_list:
            opt.video_id = video
            result = do_al(cfg, opt)
            ap95 = np.array([r["AP .95"] for r in result[2]]) * 100
            alcs.append(compute_alc(result[0], ap95))
        alc = float(np.mean(alcs))
        _log(f"trial {trial.number}: unc_lambda={cfg.VAL.UNC_LAMBDA:.4g} "
             f"ALC={alc:.4f}")
        return alc

    if getattr(opt, "search", "tpe") == "grid":
        sampler = GridSampler(
            {"unc_lambda": [0.001, 0.01, 0.1, 1.0, 10.0, 100.0]})
        count = 6
    else:
        sampler = TPESampler(seed=getattr(opt, "seed", None))
        count = getattr(opt, "n_trials", 30)
    study = create_study(direction="maximize", sampler=sampler)
    study.optimize(objective, n_trials=count if n_trials is None
                   else n_trials)
    _log(f"Best ALC: {study.best_value} Best params: {study.best_params}")
    return study


def optimize_alc(cfg, opt, video_list, n_trials=None):
    """run_study (`n_trials` as there), then the two figures the reference
    writes (Run_active_learning.py:205-209)."""
    study = run_study(cfg, opt, video_list, n_trials=n_trials)
    if is_primary():
        study.plot_history(os.path.join(opt.work_dir, "optuna_history.png"))
        study.plot_slice(os.path.join(opt.work_dir, "optuna_slice.png"))
    return study


def main(argv=None):
    from ..config import update_config
    opt = setup_opt(parse_args(argv))
    run(update_config(opt.cfg), opt)


def run(cfg, opt):
    """What main does once the config is read: the work dir, the synthetic
    video if asked for, then the study, each video's loop or the one
    video's loop and its result.json.  Under --data_parallel with
    WORLD_SIZE above 1 the process group is initialised first (unless
    the caller has) and destroyed after."""
    import torch.distributed as dist
    dp = opt.data_parallel and world_size() > 1 and not dist.is_initialized()
    if dp:
        init_distributed(opt.device)
    try:
        _run(cfg, opt)
    finally:
        if dp:
            dist.destroy_process_group()


def _run(cfg, opt):
    opt = set_dir(cfg, opt)
    if opt.synthetic:
        cfg = prepare_synthetic(cfg, opt)
    if opt.optimize:
        # the reference reads configs/posetrack21/trainval_video_list.txt
        # (Run_active_learning.py:249)
        list_path = "configs/posetrack21/trainval_video_list.txt"
        if os.path.exists(list_path) and not opt.synthetic:
            with open(list_path) as f:
                videos = [v for v in f.read().splitlines() if v]
        else:
            videos = [opt.video_id]
        optimize_alc(cfg, opt, videos)
        return
    if "," in opt.video_id:
        videos = [v for v in opt.video_id.split(",") if v]
        base_dir = opt.work_dir
        for vid in videos:
            opt.video_id = vid
            opt.work_dir = os.path.join(base_dir, vid)
            if is_primary():
                os.makedirs(opt.work_dir, exist_ok=True)
            result = do_al(cfg, opt)
            save_result(cfg, opt, result)
        return
    result = do_al(cfg, opt)
    save_result(cfg, opt, result)


if __name__ == "__main__":
    main()
