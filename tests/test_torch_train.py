"""The port's training path (vatl4pose_tpu_torch/train, the sample
geometry, targets, loss, accuracy and the train-mode BatchNorm) against
the JAX package's on the CPU, with the same numpy inputs and weights."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vatl4pose_tpu.config import Cfg
from vatl4pose_tpu.data import pipeline as jpipe
from vatl4pose_tpu.data.dataset import build_dataset
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu.models import build_sppe, build_wholebody_ae
from vatl4pose_tpu.models.criterion import \
    masked_heatmap_loss as jax_masked_loss
from vatl4pose_tpu.models.layers import torch_batchnorm
from vatl4pose_tpu.ops.heatmap import gaussian_target as jax_gaussian_target
from vatl4pose_tpu.train import optim as jopt
from vatl4pose_tpu.train.retrain import AETrainer as JaxAETrainer
from vatl4pose_tpu.train.retrain import Retrainer as JaxRetrainer
from vatl4pose_tpu.utils.metrics import calc_accuracy as jax_calc_accuracy
from tests.test_torch_models import random_flax_variables
from vatl4pose_tpu_torch.data import pipeline as pipe
from vatl4pose_tpu_torch.models import SimplePose, WholeBodyAE
from vatl4pose_tpu_torch.models import state_dict_from_flax
from vatl4pose_tpu_torch.models.criterion import masked_heatmap_loss
from vatl4pose_tpu_torch.models.layers import batchnorm
from vatl4pose_tpu_torch.ops import gaussian_target
from vatl4pose_tpu_torch.train import (AETrainer, Retrainer, build_optimizer,
                                       exponential_lr, multistep_lr, set_lr,
                                       with_warmup)
from vatl4pose_tpu_torch.utils import calc_accuracy

torch.set_num_threads(1)
RCFG = {"OPTIMIZER": "AdamW", "LR": 2.5e-4, "LR_GAMMA": 0.99,
        "BATCH_SIZE": 4, "WEIGHT_DECAY": 0.7}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root, ann = make_synthetic_video(str(tmp_path_factory.mktemp("train")),
                                     num_frames=4, num_persons=2, width=160,
                                     height=128)
    ds = build_dataset(Cfg({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann,
                            "IMG_PREFIX": ""}))
    return ds, ds.load_frames()


@pytest.mark.parametrize("add_dpg", [False, True])
def test_train_sample_geometry_matches_jax(add_dpg):
    """Flips, half-body and rotation on; the same seed gives the same rng
    stream and so the same geometry: exact."""
    rng = np.random.default_rng(4242)
    n, K = 32, 17
    boxes = rng.uniform(0, 100, (n, 2))
    bboxes = np.concatenate([boxes, boxes + rng.uniform(20, 90, (n, 2))],
                            1).astype(np.float32)
    joints = rng.uniform(0, 200, (n, K, 2)).astype(np.float32)
    vis = (rng.uniform(size=(n, K)) > 0.3).astype(np.float32)
    pairs = [[5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]]
    kw = dict(scale_factor=0.3, rot_factor=40.0, flip=True,
              num_joints_half_body=3, prob_half_body=0.5, add_dpg=add_dpg)
    got = pipe.train_sample_geometry(bboxes, joints, vis, (320, 240),
                                     (256, 192), pipe.AugCfg(**kw), pairs,
                                     np.random.default_rng(31))
    ref = jpipe.train_sample_geometry(bboxes, joints, vis, (320, 240),
                                      (256, 192), jpipe.AugCfg(**kw), pairs,
                                      np.random.default_rng(31))
    assert got[1].any() and not got[1].all()                 # some flips
    assert (np.abs(got[0][:, 0, 1]) > 1e-6).sum() >= n // 3  # rotations
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_eval_sample_geometry_matches_jax():
    rng = np.random.default_rng(4243)
    boxes = rng.uniform(0, 100, (6, 2))
    bboxes = np.concatenate([boxes, boxes + rng.uniform(10, 80, (6, 2))],
                            1).astype(np.float32)
    got = pipe.eval_sample_geometry(bboxes, (256, 192), want_fwd=True)
    ref = jpipe.eval_sample_geometry(bboxes, (256, 192), want_fwd=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_gaussian_target_matches_jax():
    """Joints inside, on the edge and outside the map, visible or not:
    exact."""
    rng = np.random.default_rng(4244)
    joints = rng.uniform(-30, 100, (3, 17, 2)).astype(np.float32)
    joints[0, :4] = [[0, 0], [63.9, 63.9], [-12.5, 5], [90, 90]]
    vis = (rng.uniform(size=(3, 17)) > 0.2).astype(np.float32)
    tgt, w = gaussian_target(torch.from_numpy(joints), torch.from_numpy(vis),
                             (16, 16), 2.0)
    rtgt, rw = jax_gaussian_target(jnp.asarray(joints), jnp.asarray(vis),
                                   (16, 16), 2.0)
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(rtgt))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    assert w.sum() < vis.sum()          # some windows fell outside


def test_masked_loss_and_accuracy_match_jax():
    """The loss on multiples of 1/32, whose squares and sums are exact in
    f32 in any order, so only the final mean rounds: rtol 1e-6 (on
    continuous values the two f32 reductions alone differ by up to 1e-6).
    The accuracy on continuous maps: rtol 1e-6."""
    rng = np.random.default_rng(103)
    shape = (6, 17, 8, 6)
    out, tgt = (rng.integers(-8, 9, shape).astype(np.float32) / 32
                for _ in range(2))
    mask = (rng.uniform(size=(6, 17, 1, 1)) > 0.3).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    for v in (None, valid):
        got = masked_heatmap_loss(
            torch.from_numpy(out), torch.from_numpy(tgt),
            torch.from_numpy(mask),
            None if v is None else torch.from_numpy(v))
        ref = jax_masked_loss(jnp.asarray(out), jnp.asarray(tgt),
                              jnp.asarray(mask),
                              None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    hms = rng.normal(0.2, 0.5, (6, 17, 16, 12)).astype(np.float32)
    labels = rng.normal(0.2, 0.5, (6, 17, 16, 12)).astype(np.float32)
    np.testing.assert_allclose(calc_accuracy(hms, labels * mask),
                               jax_calc_accuracy(hms, labels * mask),
                               rtol=1e-6)


class _Grouped(torch.nn.Module):
    """Three top-level modules named as SimplePose's LR groups."""

    def __init__(self, shapes, rng):
        super().__init__()
        for name, shape in shapes.items():
            mod = torch.nn.Module()
            mod.w = torch.nn.Parameter(torch.from_numpy(
                rng.normal(0, 1, shape).astype(np.float32)))
            setattr(self, name, mod)


def test_adamw_lr_groups_match_jax():
    """5 AdamW steps with the SimplePose groups (x1, x5, x10) and the
    learning rate decayed between steps: rtol 1e-5 / atol 1e-7."""
    rng = np.random.default_rng(4245)
    shapes = {"preact": (4, 3), "deconv_layers": (7,), "final_layer": (2, 5)}
    model = _Grouped(shapes, rng)
    params0 = {k: getattr(model, k).w.detach().numpy().copy()
               for k in shapes}
    opt = build_optimizer(model, RCFG, "SimplePose")
    grads = [{k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    lr_of = exponential_lr(RCFG["LR"], RCFG["LR_GAMMA"])
    for step, g in enumerate(grads):
        set_lr(opt, lr_of(step))
        for k in shapes:
            getattr(model, k).w.grad = torch.from_numpy(g[k])
        opt.step()
    update = jopt.make_adamw(weight_decay=RCFG["WEIGHT_DECAY"])
    params = {k: jnp.asarray(v) for k, v in params0.items()}
    mults = {k: jopt.LR_GROUPS["SimplePose"](k) for k in shapes}
    state = jopt.init_state(params)
    for step, g in enumerate(grads):
        params, state = update(params, {k: jnp.asarray(v)
                                        for k, v in g.items()}, state,
                               jnp.asarray(lr_of(step)), mults)
    for k in shapes:
        np.testing.assert_allclose(getattr(model, k).w.detach().numpy(),
                                   np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-7)
    assert sorted(g["lr_mult"] for g in opt.param_groups) == [1.0, 5.0, 10.0]


@pytest.mark.parametrize("epoch", [0, 4, 9, 90, 95, 130])
def test_schedules_match_jax(epoch):
    assert exponential_lr(2.5e-4, 0.99)(epoch) == \
        jopt.exponential_lr(2.5e-4, 0.99)(epoch)
    ms = multistep_lr(1e-3, [90, 120], 0.1)
    assert ms(epoch) == jopt.multistep_lr(1e-3, [90, 120], 0.1)(epoch)
    assert with_warmup(ms, 10)(epoch) == \
        jopt.with_warmup(jopt.multistep_lr(1e-3, [90, 120], 0.1), 10)(epoch)


def test_train_batchnorm_running_var_matches_flax():
    """One train-mode step: the forward and running_mean/var equal Flax's
    (which updates var with the biased batch variance) within 1e-6
    relative; torch's own BatchNorm2d (unbiased) does not."""
    rng = np.random.default_rng(4246)
    x = rng.normal(0.3, 1.2, (4, 2, 2, 3)).astype(np.float32)
    flax_bn = torch_batchnorm(use_running_average=False)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref_y, upd = flax_bn.apply(variables, jnp.asarray(x),
                               mutable=["batch_stats"])
    ref_mean = np.asarray(upd["batch_stats"]["mean"])
    ref_var = np.asarray(upd["batch_stats"]["var"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn = batchnorm(3).train()
    y = bn(xt)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_mean, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_var, rtol=1e-6)
    plain = torch.nn.BatchNorm2d(3).train()
    plain(xt)
    assert np.abs(plain.running_var.numpy() / ref_var - 1).max() > 1e-3


def _port_model(variables):
    model = SimplePose(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64),
                       device="cpu")
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables), "SimplePose"))
    return model


def test_retrainer_matches_jax(video):
    """3 epochs, seed 99, flips and rotations on, the last batch of each
    epoch cycle-padded.  Parameters and batch statistics are held to the
    bound of tests/test_train.py's scan-vs-step test, for its reason:
    AdamW's first steps are lr*sign(g) where |g| is tiny, and BatchNorm
    compounds ulp-level differences over steps.  Loss and accuracy
    averages: rel 1e-3."""
    ds, frames = video
    preset = Cfg({"IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16],
                  "SIGMA": 2, "NUM_JOINTS": 17, "TYPE": "simple"})
    mcfg = Cfg({"TYPE": "SimplePose", "NUM_DECONV_FILTERS": [64, 64, 64],
                "NUM_LAYERS": 18})
    model_t = build_sppe(mcfg, preset, train=True)
    # He-scaled weights: with Flax's init (deconv kernels of std 1e-3) the
    # first AdamW steps (lr*mult*sign(g), up to 1.25e-3) are as large as
    # the deconv weights themselves, and a sign flip of a tiny gradient
    # changes a weight by 100%
    variables = random_flax_variables(model_t, jnp.zeros((1, 64, 64, 3)),
                                      np.random.default_rng(99))
    idx = np.arange(len(ds.data))
    img_wh = (ds.data.width, ds.data.height)
    kw = dict(input_size=(64, 64), hm_size=(16, 16),
              joint_pairs=ds.joint_pairs, seed=99)
    aug = dict(scale_factor=0.1, rot_factor=20, flip=True)

    jtr = JaxRetrainer(model_t, RCFG, "SimplePose",
                       aug=jpipe.AugCfg(**aug), **kw)
    ref_vars, _, ref_loss, ref_acc = jtr.retrain(
        variables, jtr.init_opt_state(variables["params"]), ds.data,
        jax.device_put(frames), idx, 3, img_wh)

    model = _port_model(variables).eval()
    tr = Retrainer(model, RCFG, "SimplePose", aug=pipe.AugCfg(**aug),
                   device="cpu", **kw)
    loss, acc = tr.retrain(ds.data, frames, idx, 3, img_wh)
    assert tr.epoch_counter == 3 and not model.training

    want = state_dict_from_flax(jax.tree.map(np.asarray, ref_vars),
                                "SimplePose")
    got = model.state_dict()
    moved = 0
    for k, b in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = got[k].numpy().astype(np.float64), b.numpy().astype(np.float64)
        close = np.abs(a - b) <= 1e-2 + 5e-2 * np.abs(b)
        assert close.mean() > 0.995, (k, close.mean())
        assert np.abs(a - b).max() < 0.05, k
        moved += not np.array_equal(
            b, state_dict_from_flax(jax.tree.map(np.asarray, variables),
                                    "SimplePose")[k].numpy())
    assert moved > 0.9 * len([k for k in want
                              if not k.endswith("num_batches_tracked")])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-3)
    np.testing.assert_allclose(acc, ref_acc, rtol=1e-3, atol=1e-6)


def test_aetrainer_matches_jax():
    """Adam, masked MSE, the same permutation stream, a zero-padded last
    batch: rtol 1e-4, atol 1e-5."""
    rng = np.random.default_rng(4247)
    feats = rng.normal(0, 0.3, (37, 38)).astype(np.float32)
    jae = build_wholebody_ae({"Z_DIM": 4})
    variables = jae.init(jax.random.PRNGKey(0), jnp.zeros((1, 38)))
    ref = JaxAETrainer(jae, lr=1e-3, epochs=2, batch_size=10,
                       seed=318).train(variables, feats)
    ae = WholeBodyAE(z_dim=4, input_dim=38, device="cpu")
    ae.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables), "WholeBodyAE"))
    AETrainer(lr=1e-3, epochs=2, batch_size=10, seed=318,
              device="cpu").train(ae, feats)
    want = state_dict_from_flax(jax.tree.map(np.asarray, ref), "WholeBodyAE")
    for k, v in ae.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_trainers_default_to_cuda_and_refuse_unported(monkeypatch, video):
    model = SimplePose(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64),
                       device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Retrainer(model, RCFG, "SimplePose")
    with pytest.raises(RuntimeError, match="CUDA"):
        AETrainer(lr=1e-3, epochs=1)
    # a one-rank mesh (no process group) trains as without one, bit for
    # bit
    from vatl4pose_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.size) == ({"data": 1}, 1)
    ds, frames = video
    runs = []
    for m in (mesh, None):
        twin = copy.deepcopy(model)
        tr = Retrainer(twin, RCFG, "SimplePose", input_size=(64, 64),
                       hm_size=(16, 16), joint_pairs=ds.joint_pairs, seed=3,
                       mesh=m, device="cpu")
        runs.append((tr.retrain(ds.data, frames, np.arange(len(ds.data)), 1,
                                (ds.data.width, ds.data.height)),
                     twin.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[1][1].items():
        assert torch.equal(runs[0][1][k], v), k
    # bf16 retraining, by argument or by RETRAIN.BF16, is ported
    assert Retrainer(model, RCFG, "SimplePose", bf16=True, device="cpu").bf16
    assert Retrainer(model, dict(RCFG, BF16=True), "SimplePose",
                     device="cpu").bf16
    assert not Retrainer(model, RCFG, "SimplePose", device="cpu").bf16


def bf16_steps(video):
    """One train step (RETRAIN's AdamW, batch 8, rotations and flips) from
    the same He-scaled R18 weights, in bf16 and in f32, in each package.
    Returns ({(package, bf16): loss}, {(package, bf16): state_dict}); the
    port's master weights and BN buffers are checked to stay f32."""
    ds, frames = video
    preset = Cfg({"IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16],
                  "SIGMA": 2, "NUM_JOINTS": 17, "TYPE": "simple"})
    mcfg = Cfg({"TYPE": "SimplePose", "NUM_DECONV_FILTERS": [64, 64, 64],
                "NUM_LAYERS": 18})
    model_t = build_sppe(mcfg, preset, train=True)
    variables = random_flax_variables(model_t, jnp.zeros((1, 64, 64, 3)),
                                      np.random.default_rng(99))
    rcfg = dict(RCFG, BATCH_SIZE=8)
    d = ds.data
    sel = np.arange(8)
    inv, _, joints, vis, _ = pipe.train_sample_geometry(
        d.bboxes[sel], d.joints_xy[sel], d.joints_vis[sel],
        (d.width, d.height), (64, 64),
        pipe.AugCfg(scale_factor=0.2, rot_factor=30, flip=True),
        ds.joint_pairs, np.random.default_rng(3))
    fi = d.frame_idx[sel].astype(np.int64)
    valid = np.ones(8, bool)
    kw = dict(input_size=(64, 64), hm_size=(16, 16))
    loss, state = {}, {}
    for bf16 in (False, True):
        jtr = JaxRetrainer(model_t, rcfg, "SimplePose", bf16=bf16, **kw)
        v = jax.tree.map(jnp.asarray, variables)
        new, _, jl, _ = jtr._step(
            v, jtr.init_opt_state(v["params"]), jnp.asarray(frames),
            jnp.asarray(fi), jnp.asarray(inv), jnp.zeros(8, jnp.float32),
            jnp.asarray(joints), jnp.asarray(vis), jnp.asarray(valid),
            jnp.float32(rcfg["LR"]))
        loss["jax", bf16] = float(jl)
        state["jax", bf16] = state_dict_from_flax(
            jax.tree.map(np.asarray, new), "SimplePose")
        model = _port_model(variables)
        tr = Retrainer(model, rcfg, "SimplePose", bf16=bf16, device="cpu",
                       **kw)
        st = tr.train_step(torch.from_numpy(frames), fi, inv, joints, vis,
                           valid)
        loss["port", bf16] = float(st[0])
        state["port", bf16] = {k: v.detach().clone()
                               for k, v in model.state_dict().items()}
        assert {v.dtype for k, v in model.state_dict().items()
                if "num_batches" not in k} == {torch.float32}
    return loss, state


def state_dist(a, b):
    """The Euclidean distance between two state dicts (parameters and BN
    statistics)."""
    return sum(float(((a[k].double() - b[k].double()) ** 2).sum())
               for k in a if "num_batches" not in k) ** 0.5


def test_bf16_step_follows_jax_casting(video):
    """One bf16 train step in each package, beside each package's f32 step
    on the same inputs (bf16_steps).

    The loss (the step's forward) sits within a quarter of the JAX
    package's own bf16-vs-f32 gap of the JAX bf16 loss (measured: 0.16 of
    it): the port rounds where the JAX program casts (bf16 copies of the
    parameters and the crops, bf16 activations; BN statistics, the BN
    affine and the loss in f32).  The parameters and BN statistics after
    the step sit about as far from the JAX bf16 step as the JAX f32 step
    does (1.02-1.08 of that gap; scripts/bf16_step_gap.py): AdamW's first
    step is lr * sign(g), so every gradient whose sign bf16 noise flips
    moves a weight by 2 lr, and the JAX bf16 program does not round where
    it declares on the CPU (XLA keeps excess precision by default; with
    that off the loss sits at 0.04 of the gap, the BN statistics at 0.57,
    the parameters at 0.89: ROADMAP C3).  So the parameters are held to
    1.25 of the gap from the JAX bf16 step, and, so that an f32 step
    cannot pass, at least half of it from the port's own f32 step; the
    port's f32 step sits within 0.1 of it from the JAX f32 step (measured
    0.06), which shows the gap is the bf16 step's; every master weight and
    BN buffer stays f32."""
    loss, state = bf16_steps(video)
    loss_gap = abs(loss["jax", True] - loss["jax", False])
    assert abs(loss["port", True] - loss["jax", True]) <= 0.25 * loss_gap
    gap = state_dist(state["jax", True], state["jax", False])
    assert state_dist(state["port", True], state["jax", True]) <= 1.25 * gap
    assert state_dist(state["port", True], state["port", False]) >= 0.5 * gap
    assert state_dist(state["port", False], state["jax", False]) <= 0.1 * gap
