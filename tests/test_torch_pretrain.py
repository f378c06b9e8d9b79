"""The port's pre-training, evaluation and AE-training entry points
(vatl4pose_tpu_torch/cli/{posetrack_train,jrdbpose_train,
poseestimator_eval,wholebodyAE_train}.py) against the JAX package's on the
CPU: the same synthetic data and the same initial weights in both."""

import argparse
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vatl4pose_tpu.cli import jrdbpose_train as jjrdb
from vatl4pose_tpu.cli import poseestimator_eval as jeval
from vatl4pose_tpu.cli import posetrack_train as jpt
from vatl4pose_tpu.cli import wholebodyAE_train as jae_cli
from vatl4pose_tpu.config import Cfg as JCfg
from vatl4pose_tpu.data import synthetic as jsynth
from vatl4pose_tpu.eval.cocoeval import evaluate_map as jax_evaluate_map
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu.models import convert_state_dict
from vatl4pose_tpu.models.convert_torch import load_torch_checkpoint
from vatl4pose_tpu.models.wholebody_ae import WholeBodyAE as FlaxAE
from vatl4pose_tpu.train.retrain import Retrainer as JaxRetrainer
from vatl4pose_tpu_torch.cli import jrdbpose_train, poseestimator_eval
from vatl4pose_tpu_torch.cli import posetrack_train as pt
from vatl4pose_tpu_torch.cli import wholebodyAE_train as ae_cli
from vatl4pose_tpu_torch.config import Cfg
from vatl4pose_tpu_torch.data import build_dataset, synthetic
from vatl4pose_tpu_torch.eval.cocoeval import evaluate_map
from vatl4pose_tpu_torch.models import state_dict_from_flax
from vatl4pose_tpu_torch.models.convert import read_weights
from vatl4pose_tpu_torch.train.retrain import Retrainer

torch.set_num_threads(1)

PRESET = {"TYPE": "simple", "SIGMA": 2, "NUM_JOINTS": 17,
          "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16]}
MODEL = {"TYPE": "SimplePose", "PRETRAINED": "", "TRY_LOAD": "",
         "NUM_DECONV_FILTERS": [64, 64, 64], "NUM_LAYERS": 18}
# 3 epochs: the rate decays at epoch 1, the DPG stage restarts it at 2.
# LR 1e-4, not the published 1e-3: from the Flax init (deconv kernels of
# std 1e-3) Adam's first steps are about lr * sign(g), so that at 1e-3 a
# sign flip of a tiny gradient moves a weight by its own size, and the
# two f32 trajectories part by more than the loss bound over 9 steps
TRAIN = {"WORLD_SIZE": 1, "BATCH_SIZE": 8, "BEGIN_EPOCH": 0, "END_EPOCH": 3,
         "OPTIMIZER": "adam", "LR": 1e-4, "LR_FACTOR": 0.1, "LR_STEP": [1],
         "DPG_MILESTONE": 2, "DPG_STEP": []}
AUG = {"FLIP": True, "ROT_FACTOR": 40, "SCALE_FACTOR": 0.3,
       "NUM_JOINTS_HALF_BODY": 8, "PROB_HALF_BODY": -1}


def _cfg(root, ann, pretrained, dtype="Posetrack21"):
    d = {"DATASET": {"TRAIN": {"TYPE": dtype, "ROOT": root, "ANN": ann,
                               "IMG_PREFIX": "", "AUG": dict(AUG)},
                     "TEST": {"TYPE": dtype, "ROOT": root, "ANN": ann,
                              "IMG_PREFIX": ""}},
         "DATA_PRESET": dict(PRESET),
         "MODEL": dict(MODEL, PRETRAINED=pretrained),
         "LOSS": {"TYPE": "MSELoss"}, "TRAIN": dict(TRAIN)}
    return JCfg(d), Cfg(d)


def _opt(work_dir, seed=5, device="cpu"):
    return argparse.Namespace(seed=seed, snapshot=2, epochs_override=None,
                              work_dir=str(work_dir), stream=False,
                              launcher="none", device=device)


@pytest.fixture(scope="module")
def init_pkl(tmp_path_factory):
    """The JAX package's SimplePose-R18 init (the JAX CLI's own, at seed 5)
    as one .pkl, the MODEL.PRETRAINED of both packages."""
    model = jax_build_sppe(JCfg(MODEL), JCfg(PRESET), train=True)
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)))
    path = str(tmp_path_factory.mktemp("init") / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, variables), f)
    return path


def _record_jax(monkeypatch):
    """Each JAX epoch's (rate, loss, acc) and each validation's AP."""
    epochs, aps = [], []
    for name in ("retrain", "retrain_streaming"):
        orig = getattr(JaxRetrainer, name)

        def wrapped(self, *a, _orig=orig, **kw):
            out = _orig(self, *a, **kw)
            epochs.append((self.base_lr, out[2], out[3]))
            return out
        monkeypatch.setattr(JaxRetrainer, name, wrapped)
    orig_val = jpt.validate_gt

    def validated(*a, **kw):
        ap = orig_val(*a, **kw)
        aps.append(ap)
        return ap
    monkeypatch.setattr(jpt, "validate_gt", validated)
    return epochs, aps


@pytest.fixture(scope="module")
def resident_runs(tmp_path_factory, init_pkl):
    """JAX posetrack_train.train and the port's train(device="cpu") on one
    synthetic video (18 samples, 3 steps an epoch), frames resident."""
    base = tmp_path_factory.mktemp("pretrain")
    root, ann = synthetic.make_synthetic_video(str(base / "data"),
                                               num_frames=6, seed=5)
    jcfg, cfg = _cfg(root, ann, init_pkl)
    mp = pytest.MonkeyPatch()
    try:
        jax_epochs, jax_aps = _record_jax(mp)
        jpt.train(jcfg, _opt(base / "jax"))
    finally:
        mp.undo()
    model, history = pt.train(cfg, _opt(base / "port"))
    return base, cfg, jax_epochs, jax_aps, model, history


def test_train_matches_jax(resident_runs):
    """Per-epoch rates exact (the MultiStepLR decay at epoch 1, the DPG
    restart at 2); per-epoch losses rtol 1e-3, as the Retrainer's own test
    holds them; validate_gt's AP within 0.02, the DUW loop test's AP
    bound."""
    _, _, jax_epochs, jax_aps, _, history = resident_runs
    assert [h["lr"] for h in history] == [e[0] for e in jax_epochs] \
        == [1e-4, 1e-5, 1e-4]
    np.testing.assert_allclose([h["loss"] for h in history],
                               [e[1] for e in jax_epochs], rtol=1e-3)
    assert history[-1]["loss"] < history[0]["loss"]
    aps = [h["ap"] for h in history if "ap" in h]
    assert len(aps) == len(jax_aps) == 2
    np.testing.assert_allclose(aps, jax_aps, atol=0.02)


def test_train_checkpoints_read_by_jax(resident_runs):
    """The port's model_{epoch}.pth files, in the reference layout, read
    by the JAX package (convert_state_dict) give the JAX forward the port's
    eval heatmaps: rtol 1e-4 / atol 1e-5."""
    base, cfg, _, _, model, history = resident_runs
    files = sorted(os.listdir(base / "port"))
    assert files[:2] == ["model_1.pth", "model_2.pth"]
    assert ("model_best.pth" in files) == (max(h.get("ap", 0)
                                               for h in history) > 0)
    path = str(base / "port" / "model_2.pth")
    x = np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    variables = convert_state_dict(load_torch_checkpoint(path), "SimplePose")
    jmodel = jax_build_sppe(JCfg(MODEL), JCfg(PRESET), train=False)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model.load_state_dict(read_weights(path, "SimplePose"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_train_streaming_matches_jax(tmp_path, init_pkl, monkeypatch):
    """A two-video set of two frame sizes forces the streaming branch in
    both packages (the fixtures' files byte-equal); per-epoch rates exact,
    losses rtol 1e-3."""
    kw = dict(num_videos=2, num_frames=4, num_persons=2, seed=7,
              appearance_jitter=True)
    jroot, jann = jsynth.make_synthetic_multivideo(str(tmp_path / "j"), **kw)
    root, ann = synthetic.make_synthetic_multivideo(str(tmp_path / "p"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), root)
                           for d, _, fs in os.walk(root) for f in fs)
    for f in files:
        with open(os.path.join(jroot, f), "rb") as a, \
                open(os.path.join(root, f), "rb") as b:
            assert a.read() == b.read(), f
    jcfg, _ = _cfg(jroot, jann, init_pkl)
    _, cfg = _cfg(root, ann, init_pkl)
    for c in (jcfg, cfg):
        c.TRAIN.END_EPOCH = 2
        c.TRAIN.pop("DPG_MILESTONE")
    jax_epochs, _ = _record_jax(monkeypatch)
    jpt.train(jcfg, _opt(tmp_path / "jax", seed=7))
    monkeypatch.undo()
    calls = []
    for name in ("retrain", "retrain_streaming"):
        orig = getattr(Retrainer, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(Retrainer, name, counted)
    _, history = pt.train(cfg, _opt(tmp_path / "port", seed=7))
    assert calls == ["retrain_streaming"] * 2
    assert [h["lr"] for h in history] == [e[0] for e in jax_epochs]
    np.testing.assert_allclose([h["loss"] for h in history],
                               [e[1] for e in jax_epochs], rtol=1e-3)


def test_jrdb_guard_refuses_posetrack(tmp_path):
    """jrdbpose_train refuses a non-JRDB2022 set with an AssertionError,
    as the JAX package's does."""
    jcfg, cfg = _cfg("", "", "")
    with pytest.raises(AssertionError, match="JRDB2022"):
        jrdbpose_train.check_jrdb(cfg)
    cfg_yaml = tmp_path / "c.yaml"
    import yaml
    cfg_yaml.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    for main in (jjrdb.main, jrdbpose_train.main):
        argv = ["--cfg", str(cfg_yaml), "--work_dir", str(tmp_path / "w")]
        if main is jrdbpose_train.main:
            argv += ["--device", "cpu"]
        with pytest.raises(AssertionError, match="JRDB2022"):
            main(argv)


def test_jrdb_synthetic_training_runs(tmp_path):
    """The JRDB path end to end on the CPU: the 3-digit fixture as a
    JRDB2022 set, two epochs, checkpoints written."""
    _, cfg = _cfg("", "", "", dtype="JRDB2022")
    cfg.TRAIN.END_EPOCH = 2
    cfg.TRAIN.pop("DPG_MILESTONE")
    cfg_yaml = tmp_path / "c.yaml"
    import yaml
    cfg_yaml.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    model, history = jrdbpose_train.main(
        ["--cfg", str(cfg_yaml), "--synthetic", "--seed", "5",
         "--work_dir", str(tmp_path / "w"), "--device", "cpu"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert "model_1.pth" in os.listdir(tmp_path / "w")


def test_poseestimator_eval_matches_jax(tmp_path, init_pkl):
    """validate on the same weights (the .pkl through each package's
    reader): kpts and OKS rtol 1e-4 / atol 1e-3, as the streaming tests
    hold decoded keypoints; the JAX package's evaluate_map on the port's
    predictions gives the port's AP exactly; one entry a sample, with its
    OKS."""
    root, ann = synthetic.make_synthetic_video(str(tmp_path), num_frames=6,
                                               seed=11)
    jcfg, cfg = _cfg(root, ann, init_pkl)
    with open(init_pkl, "rb") as f:
        variables = pickle.load(f)
    jres, jkpts = jeval.validate(jcfg, jax.tree.map(jnp.asarray, variables),
                                 "TEST")
    model = poseestimator_eval.load_model(cfg, "", device="cpu")
    res, kpts = poseestimator_eval.validate(cfg, model, "TEST",
                                            device="cpu")
    assert len(kpts) == len(jkpts) == 18
    for key in ("keypoints", "OKS"):
        np.testing.assert_allclose(np.array([k[key] for k in kpts]),
                                   np.array([k[key] for k in jkpts]),
                                   rtol=1e-4, atol=1e-3)
    assert [k["id"] for k in kpts] == [k["id"] for k in jkpts]
    assert all(np.isfinite(k["OKS"]) for k in kpts)
    src = json.load(open(os.path.join(root, ann)))
    gt_kpts = build_dataset(cfg.DATASET.TEST).data.gt_keypoints
    gt = {"images": src["images"], "categories": src["categories"],
          "annotations": [dict(k, keypoints=g.tolist())
                          for k, g in zip(kpts, gt_kpts)]}
    assert evaluate_map(kpts, gt)["AP"] == jax_evaluate_map(kpts, gt)["AP"]
    assert abs(res["AP"] - jres["AP"]) <= 0.02


def _ae_anns(tmp_path):
    """Training and validation annotations: two 4-frame videos of 4
    persons, 16 bodies each."""
    paths = []
    for i, seed in enumerate((21, 22)):
        root, ann = synthetic.make_synthetic_video(
            str(tmp_path / f"v{i}"), num_frames=4, num_persons=4, width=160,
            height=128, seed=seed)
        paths.append(os.path.join(root, ann))
    return paths


@pytest.mark.parametrize("epochs,batch,patience", [(14, 4, 30),
                                                   (80, 1, 2)])
def test_wholebody_ae_train_matches_jax(tmp_path, monkeypatch, epochs,
                                        batch, patience):
    """Both CLIs from the JAX init at the CLI's seed (carried over by
    state_dict_from_flax, patched into the port's build_ae): log.json's
    losses rtol 1e-4 / atol 1e-5, as the AETrainer's test holds them,
    over 14 epochs (across the 1e-3 -> 2e-4 decay at epoch 12), the same
    best epoch; and, at batch 1 with --patience 2, where the validation
    loss flattens out, the same early-stop epoch."""
    train_ann, val_ann = _ae_anns(tmp_path)
    argv = ["--ann_train", train_ann, "--ann_val", val_ann, "--epochs",
            str(epochs), "--patience", str(patience), "--batch", str(batch)]
    jae_cli.main(argv + ["--work_dir", str(tmp_path / "jax")])
    flax_init = FlaxAE(z_dim=4, input_dim=38).init(
        jax.random.PRNGKey(318), jnp.zeros((1, 38)))
    orig = ae_cli.build_ae

    def jax_init(z_dim, input_dim, seed, device):
        ae = orig(z_dim, input_dim, seed, device)
        ae.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, flax_init), "WholeBodyAE"))
        return ae
    monkeypatch.setattr(ae_cli, "build_ae", jax_init)
    ae_cli.main(argv + ["--work_dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    logs = [json.load(open(tmp_path / w / "log.json"))
            for w in ("jax", "port")]
    assert [e["epoch"] for e in logs[0]] == [e["epoch"] for e in logs[1]]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([e[key] for e in logs[1]],
                                   [e[key] for e in logs[0]], rtol=1e-4,
                                   atol=1e-5)
    best = [int(np.argmin([e["val_loss"] for e in lg])) for lg in logs]
    assert best[0] == best[1]
    assert (len(logs[0]) < epochs) == (patience < epochs)
    sd = read_weights(str(tmp_path / "port" / "WholeBodyAE_zdim4.pth"),
                      "WholeBodyAE")
    assert set(sd) == set(state_dict_from_flax(
        jax.tree.map(np.asarray, flax_init), "WholeBodyAE"))


def test_entry_points_need_cuda_or_cpu(tmp_path, monkeypatch, capsys):
    """Without CUDA every new entry point raises unless given --device cpu
    (device="cpu").  A --launcher other than none is accepted and trains
    on that one device, as the JAX CLI parses the launch flags and never
    reads them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_yaml = tmp_path / "c.yaml"
    cfg_yaml.write_text("{}")
    ann = str(tmp_path / "a.json")
    mains = [(pt.main, ["--cfg", str(cfg_yaml)]),
             (jrdbpose_train.main, ["--cfg", str(cfg_yaml)]),
             (poseestimator_eval.main, ["--cfg", str(cfg_yaml)]),
             (ae_cli.main, ["--ann_train", ann, "--ann_val", ann])]
    for main, argv in mains:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    _, cfg = _cfg("", "", "")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.train(cfg, _opt(tmp_path, device=None))
    with pytest.raises(RuntimeError, match="CUDA"):
        poseestimator_eval.load_model(cfg)
    _, tiny = _cfg("", "", "")
    tiny.TRAIN.END_EPOCH = 1
    tiny.TRAIN.pop("DPG_MILESTONE")
    import yaml
    tiny_yaml = tmp_path / "tiny.yaml"
    tiny_yaml.write_text(yaml.safe_dump(json.loads(json.dumps(tiny))))
    model, history = pt.main(
        ["--cfg", str(tiny_yaml), "--synthetic", "--seed", "5",
         "--work_dir", str(tmp_path / "w"), "--launcher", "pytorch",
         "--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert "--launcher pytorch: pre-training runs on one device" \
        in capsys.readouterr().out


def test_simplepose_head_init_follows_reference():
    """The port's SimplePose head starts as the reference's
    (simplepose.py _initialize) and the JAX package's: every deconv and the
    final conv's kernels drawn from N(0, 1e-3) (std within 5%, mean within
    0.05 std), the final bias 0; the BN weights 1 and biases 0.  (Trained
    from scratch with torch's default init, the maps collapse to zero.)"""
    from vatl4pose_tpu_torch.models import SimplePose
    torch.manual_seed(0)
    model = SimplePose(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64),
                       device="cpu")
    flax = jax_build_sppe(JCfg(MODEL), JCfg(PRESET), train=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    convs = [m for m in (*model.deconv_layers, model.final_layer)
             if isinstance(m, (torch.nn.ConvTranspose2d, torch.nn.Conv2d))]
    assert len(convs) == 4
    for m, name in zip(convs, ("deconv1", "deconv2", "deconv3",
                               "final_layer")):
        w = m.weight.detach().numpy()
        ref = np.asarray(flax[name]["kernel"])
        for a in (w, ref):
            assert abs(a.std() / 1e-3 - 1) < 0.05, name
            assert abs(a.mean()) < 0.05 * a.std(), name
    assert not model.final_layer.bias.any()
    assert not np.asarray(flax["final_layer"]["bias"]).any()
    for m in model.deconv_layers:
        if isinstance(m, torch.nn.BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any()
