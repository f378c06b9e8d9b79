"""The AL loop's pieces on the other models, the port against the JAX
package on the CPU: one HRNet THC+WPU scoring pass, one FastPose VL4Pose
pass, one AdamW train step each for HRNet and FastPose; then the port's
HRNet loop through its CLI's functions on
configs/posetrack21/al_hrnet_posetrack.yaml, cut to size.  Weights are
numpy-drawn (`random_flax_variables`); HRNet has narrow stages
(tests/test_torch_zoo.NARROW_STAGES); inputs are 128x96 (HRNet's and
FastPose's 32x24 maps need sides that are multiples of 32)."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_models import random_flax_variables, rel_err
from tests.test_torch_scoring import MARGIN, top2_margin
from tests.test_torch_zoo import NARROW_STAGES
from vatl4pose_tpu.al.scoring import ScoringConfig as JaxScoringConfig
from vatl4pose_tpu.al.scoring import ScoringEngine as JaxScoringEngine
from vatl4pose_tpu.config import Cfg as JaxCfg
from vatl4pose_tpu.data.dataset import build_dataset
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu.models import WholeBodyAE as FlaxWholeBodyAE
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu.models.auxnet import AuxNet as FlaxAuxNet
from vatl4pose_tpu.train.retrain import Retrainer as JaxRetrainer
from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.cli import run_active_learning as cli
from vatl4pose_tpu_torch.config import update_config
from vatl4pose_tpu_torch.data import pipeline as pipe
from vatl4pose_tpu_torch.models import (AuxNet, WholeBodyAE, build_sppe,
                                        state_dict_from_flax)
from vatl4pose_tpu_torch.train import LR_GROUPS, Retrainer

torch.set_num_threads(1)
RNG = np.random.default_rng(9173)
INPUT, HM = (128, 96), (32, 24)
PRESET = JaxCfg({"IMAGE_SIZE": list(INPUT), "HEATMAP_SIZE": list(HM),
                 "SIGMA": 2, "NUM_JOINTS": 17, "TYPE": "simple"})
MODELS = {
    "PoseHighResolutionNet": {"TYPE": "PoseHighResolutionNet",
                              "FINAL_CONV_KERNEL": 1, **NARROW_STAGES},
    "FastPose": {"TYPE": "FastPose", "NUM_LAYERS": 50},
}
RCFG = {"OPTIMIZER": "AdamW", "LR": 2.5e-4, "LR_GAMMA": 0.99,
        "BATCH_SIZE": 6, "WEIGHT_DECAY": 0.7}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root, ann = make_synthetic_video(
        str(tmp_path_factory.mktemp("zoo")), num_frames=4, num_persons=2,
        width=160, height=128)
    ds = build_dataset(JaxCfg({"TYPE": "Posetrack21", "ROOT": root,
                               "ANN": ann}))
    d = ds.data
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    args = (d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann, d.is_prev,
            d.is_next)
    return ds, ds.load_frames(), args


def weights(model_type):
    """(Flax eval module, numpy variables, the port's eval model)."""
    cfg = MODELS[model_type]
    flax_model = jax_build_sppe(cfg, PRESET, fused_eval=True)
    variables = random_flax_variables(
        jax_build_sppe(cfg, PRESET, train=True),
        jnp.zeros((1,) + INPUT + (3,)), RNG)
    model = build_sppe(cfg, PRESET, fused_eval=True, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, model_type))
    return flax_model, variables, model.eval()


def test_hrnet_duw_pass_matches_jax(video):
    """ScoringEngine.score (THC+WPU) with HRNet, against the JAX engine,
    with test_torch_scoring.py's tolerances."""
    _, frames, args = video
    flax_model, variables, model = weights("PoseHighResolutionNet")
    ae_vars = random_flax_variables(FlaxWholeBodyAE(), jnp.zeros((1, 38)),
                                    RNG)
    ref = JaxScoringEngine(
        flax_model, JaxScoringConfig(uncertainty="THC+WPU",
                                     input_size=INPUT),
        ae_model=FlaxWholeBodyAE(), chunk=8).score(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(frames), *args,
        ae_variables=jax.tree.map(jnp.asarray, ae_vars))
    ae = WholeBodyAE(device="cpu")
    ae.load_state_dict(state_dict_from_flax(ae_vars, "WholeBodyAE"))
    res = ScoringEngine(model, ScoringConfig(uncertainty="THC+WPU",
                                             input_size=INPUT),
                        ae_model=ae, chunk=3, device="cpu").score(frames,
                                                                  *args)
    assert set(res) == set(ref)
    ref_hm = np.asarray(ref["heatmaps"])
    assert tuple(res["heatmaps"].shape) == ref_hm.shape == (8, 17) + HM
    assert res["embeddings"].shape == (8, 2048)
    assert not res["embeddings"][:, 8:].any()       # 8 channels, zero-padded
    assert rel_err(res["heatmaps"], ref_hm) <= 1e-4
    assert rel_err(res["embeddings"], ref["embeddings"]) <= 1e-4
    for k in ("gc", "unc", "scores", "det_score"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    clear = top2_margin(ref_hm) > MARGIN
    assert clear.sum() >= 0.9 * clear.size, f"{(~clear).sum()} excluded"
    np.testing.assert_allclose(res["coords"][clear], ref["coords"][clear],
                               rtol=1e-4, atol=1e-3)
    whole = clear.all(axis=1)
    for k in ("oks", "unc2"):
        np.testing.assert_allclose(res[k][whole], ref[k][whole], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert np.isfinite(res["unc2"]).all() and res["unc2"].any()


def test_fastpose_vl4pose_pass_matches_jax(video, monkeypatch):
    """VL4Pose on FastPose: one backbone pass a chunk (K1's plain version
    on the tails) feeds the head, the AuxNet and the embedding; the
    scores within 1e-4 (rtol) / 1e-5 (atol) of the JAX engine's."""
    _, frames, args = video
    flax_model, variables, model = weights("FastPose")
    aux_vars = random_flax_variables(FlaxAuxNet(),
                                     jnp.zeros((1, 4, 3, 2048)), RNG)
    ref = JaxScoringEngine(
        flax_model, JaxScoringConfig(uncertainty="VL4Pose",
                                     input_size=INPUT),
        aux_model=FlaxAuxNet(), chunk=8).score(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(frames), *args,
        aux_variables=jax.tree.map(jnp.asarray, aux_vars))
    aux = AuxNet(device="cpu")
    aux.load_state_dict(state_dict_from_flax(aux_vars, "auxnet"))
    calls = {"backbone": 0, "forward": 0}
    backbone, forward = type(model).backbone, type(model).forward

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(type(model), "backbone", counted("backbone",
                                                         backbone))
    monkeypatch.setattr(type(model), "forward", counted("forward", forward))
    res = ScoringEngine(model, ScoringConfig(uncertainty="VL4Pose",
                                             input_size=INPUT),
                        aux_model=aux, chunk=3, device="cpu").score(frames,
                                                                    *args)
    assert calls == {"backbone": 3, "forward": 0}       # 8 samples, chunk 3
    assert rel_err(res["heatmaps"], np.asarray(ref["heatmaps"])) <= 1e-4
    assert rel_err(res["embeddings"], ref["embeddings"]) <= 1e-4
    assert np.isfinite(res["unc"]).all() and res["unc"].any()
    np.testing.assert_allclose(res["unc"], ref["unc"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_type", ["PoseHighResolutionNet",
                                        "FastPose"])
def test_train_step_matches_jax(video, model_type):
    """One AdamW step (batch 6, rotations and scalings) from the same
    He-scaled weights in each package, and the port's step in f64 as the
    exact one.  The loss within 1e-4 (rtol).  AdamW's first step is
    lr*mult*sign(g), so a sign that f32 noise flips on a tiny gradient
    moves an element by up to 2 lr mult: every element within that (plus
    1e-6) of the JAX step's.  Close means within 1e-6 + 1e-4|p| (BN
    statistics included): at least 99% of the elements close to the JAX
    step's, or no fewer close to the f64 step's than the JAX step has,
    less 0.5% (in SE-ResNet-50's deep stages the JAX f32 step itself sits
    1-2% away from f64, where the port's sits 0.5%)."""
    ds, frames, _ = video
    cfg = MODELS[model_type]
    model_t = jax_build_sppe(cfg, PRESET, train=True)
    variables = random_flax_variables(model_t, jnp.zeros((1,) + INPUT + (3,)),
                                      RNG)
    d = ds.data
    sel = np.arange(6)
    inv, _, joints, vis, _ = pipe.train_sample_geometry(
        d.bboxes[sel], d.joints_xy[sel], d.joints_vis[sel],
        (d.width, d.height), INPUT,
        pipe.AugCfg(scale_factor=0.2, rot_factor=30, flip=False),
        ds.joint_pairs, np.random.default_rng(3))
    fi = d.frame_idx[sel].astype(np.int64)
    valid = np.ones(6, bool)
    kw = dict(input_size=INPUT, hm_size=HM)
    jtr = JaxRetrainer(model_t, RCFG, model_type, **kw)
    v = jax.tree.map(jnp.asarray, variables)
    new, _, jloss, _ = jtr._step(
        v, jtr.init_opt_state(v["params"]), jnp.asarray(frames),
        jnp.asarray(fi), jnp.asarray(inv), jnp.zeros(6, jnp.float32),
        jnp.asarray(joints), jnp.asarray(vis), jnp.asarray(valid),
        jnp.float32(RCFG["LR"]))
    steps = {"jax": state_dict_from_flax(jax.tree.map(np.asarray, new),
                                         model_type)}
    for key, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        model = build_sppe(cfg, PRESET, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables, model_type))
        model.to(dtype)
        tr = Retrainer(model, RCFG, model_type, device="cpu", **kw)
        loss = float(tr.train_step(torch.from_numpy(frames), fi, inv,
                                   joints, vis, valid)[0])
        steps[key] = model.state_dict()
        if dtype == torch.float32:
            assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    group_of = LR_GROUPS.get(model_type, lambda k: 1.0)
    close = {"f32-jax": 0, "f32-f64": 0, "jax-f64": 0}
    total = 0
    for k, p in steps["jax"].items():
        if k.endswith("num_batches_tracked"):
            continue
        got = {s: t[k].double() for s, t in steps.items()}
        lr_mult = RCFG["LR"] * group_of(k.split(".")[0])
        assert (got["f32"] - got["jax"]).abs().max() <= 2 * lr_mult + 1e-6, k
        for pair in close:
            a, b = (got[s] for s in pair.split("-"))
            close[pair] += ((a - b).abs() <= 1e-6 + 1e-4 * b.abs()).sum().item()
        total += p.numel()
    assert close["f32-jax"] >= 0.99 * total or \
        close["f32-f64"] >= close["jax-f64"] - 0.005 * total, \
        {k: v / total for k, v in close.items()}


def test_hrnet_loop_through_the_cli(tmp_path, monkeypatch):
    """configs/posetrack21/al_hrnet_posetrack.yaml through set_dir, do_al
    and save_result on a synthetic video, from scratch (HRNet's
    normal(0.001) init), cut to size: the narrow stages, 128x96, two
    rounds, RETRAIN.ALPHA 3, batch 4, one AE epoch."""
    cfg = update_config("configs/posetrack21/al_hrnet_posetrack.yaml")
    cfg.MODEL.update(copy.deepcopy(NARROW_STAGES))
    cfg.DATA_PRESET.update(IMAGE_SIZE=list(INPUT), HEATMAP_SIZE=list(HM))
    cfg.RETRAIN.update(BATCH_SIZE=4, BASE=1, ALPHA=3)
    cfg.AE.update(EPOCH=1, PRETRAINED_ROOT="")
    cfg.VAL.update(QUERY_RATIO=[0.5, 1.0], VIS=False, BATCH_SIZE=16)
    monkeypatch.chdir(tmp_path)
    opt = cli.parse_args([
        "--cfg", "configs/posetrack21/al_hrnet_posetrack.yaml",
        "--video_id", "000001", "--uncertainty", "THC+WPU",
        "--representativeness", "Influence", "--filter", "Coreset",
        "--continual", "--seedfix", "--synthetic", "--from_scratch",
        "--device", "cpu", "--synth_frames", "3", "--synth_persons", "2",
        "--synth_size", "160", "128"])
    opt = cli.set_dir(cfg, cli.setup_opt(opt))
    cfg = cli.prepare_synthetic(cfg, opt)
    result = cli.do_al(cfg, opt)
    rj = json.load(open(cli.save_result(cfg, opt, result)))
    assert rj["model"] == "PoseHighResolutionNet" and len(rj) == 24
    assert "PoseHighResolutionNet" in opt.work_dir.split(os.sep)
    assert rj["percentages"] == [0.0, 50.0, 100.0]
    assert sorted(q for qs in rj["query_list"].values() for q in qs) \
        == list(range(6))
    lines = open(os.path.join(opt.work_dir, "cycle_times.jsonl")).readlines()
    assert len(lines) == 5
    assert rj["performances_ann"][-1]["AP"] == 1.0
