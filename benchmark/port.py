"""Everything the benchmark takes from the system under test, the PyTorch
and CUDA port `vatl4pose_tpu_torch`, built as its AL loop builds it
(`ActiveLearning.__init__`): the estimator with the fused eval path, the
WholeBodyAE, the scoring engine, the Retrainer, the CLI's precision
set-up, the kernels' build and launch counters.  No other file of the
benchmark imports the port, and the reference imports nothing of it."""

from __future__ import annotations

import types

import torch

from benchmark.weights import ae_weights, estimator_weights


def setup_precision(precision: str):
    """The AL CLI's own precision set-up: parity mode (f32, TF32 off,
    matmul precision "highest") for "f32", its --speedup for "bf16"."""
    from vatl4pose_tpu_torch.cli.run_active_learning import setup_opt
    setup_opt(types.SimpleNamespace(speedup=precision == "bf16",
                                    seedfix=False))


def build_kernels():
    """The port's CUDA libraries, built into its checkout-local cache
    (vatl4pose_tpu_torch/build/, keyed by source and toolkit) where they
    are not there yet, and loaded."""
    from vatl4pose_tpu_torch.kernels import _build
    _build.build()
    for name in _build.SIGNATURES:
        _build.load(name)


def launch_counts():
    from vatl4pose_tpu_torch.kernels import KERNELS
    return {k.__name__: k.launches for k in KERNELS}


def build_models(cfg, seed, device, with_ae):
    """The estimator (fused eval path) and, if asked, the WholeBodyAE,
    on `device`, holding the benchmark's seeded weights (streams 1 and 2
    of `seed`, in the reference models' layout)."""
    from vatl4pose_tpu_torch.models import build_sppe, build_wholebody_ae
    with torch.device(device):
        model = build_sppe(cfg["MODEL"], cfg["DATA_PRESET"], fused_eval=True,
                           device=device)
        ae = build_wholebody_ae(cfg["AE"], device=device) if with_ae \
            else None
    model.load_state_dict(estimator_weights(cfg, seed, device))
    if with_ae:
        ae.load_state_dict(ae_weights(cfg, seed, device))
    return model, ae


def scoring_engine(cfg, model, ae, n, device, bf16):
    from vatl4pose_tpu_torch.al.scoring import ScoringConfig, ScoringEngine
    s = cfg["STRATEGY"]
    need_emb = s["representativeness"] not in ("None", "Random") \
        or s["filter"] not in ("None", "Random")
    return ScoringEngine(
        model,
        ScoringConfig(uncertainty=s["uncertainty"], need_embedding=need_emb,
                      input_size=tuple(cfg["DATA_PRESET"]["IMAGE_SIZE"]),
                      eval_joints=tuple(range(
                          cfg["DATA_PRESET"]["NUM_JOINTS"])), bf16=bf16),
        ae_model=ae, chunk=min(512, max(32, n)), device=device)


def retrainer(cfg, model, seed, joint_pairs, device, bf16):
    from vatl4pose_tpu_torch.data.pipeline import AugCfg
    from vatl4pose_tpu_torch.train.retrain import Retrainer
    a, pre = cfg["AUG"], cfg["DATA_PRESET"]
    return Retrainer(
        model, cfg["RETRAIN"], cfg["MODEL"]["TYPE"],
        input_size=tuple(pre["IMAGE_SIZE"]),
        hm_size=tuple(pre["HEATMAP_SIZE"]), sigma=pre["SIGMA"],
        aug=AugCfg(scale_factor=a["SCALE_FACTOR"],
                   rot_factor=a["ROT_FACTOR"], flip=a["FLIP"],
                   num_joints_half_body=a["NUM_JOINTS_HALF_BODY"],
                   prob_half_body=a["PROB_HALF_BODY"]),
        joint_pairs=joint_pairs, seed=seed, bf16=bf16, device=device)
