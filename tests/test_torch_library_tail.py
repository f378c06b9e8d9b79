"""The port's library functions that no CLI path calls (the integral
decode and its L1 loss, the flip, the loss registry, config from text,
checkpoints and TRY_LOAD, the host warp's query, the build cache's key)
against the JAX package's, on the same seeded numpy inputs; and the
synthetic video that chip_smoke.py's loops reuse against the one the CLI's
--synthetic path makes."""

import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vatl4pose_tpu import config as jax_config
from vatl4pose_tpu.data import native_warp as jax_native_warp
from vatl4pose_tpu.models import SimplePose as FlaxSimplePose
from vatl4pose_tpu.models import builder as jax_builder
from vatl4pose_tpu.models import criterion as jax_criterion
from vatl4pose_tpu.ops import heatmap as jax_heatmap
from vatl4pose_tpu.train import optim as jax_optim
from vatl4pose_tpu.utils import checkpoint as jax_checkpoint
from vatl4pose_tpu_torch import config
from vatl4pose_tpu_torch.data import native_warp
from vatl4pose_tpu_torch.data.dataset import POSETRACK_JOINT_PAIRS
from vatl4pose_tpu_torch.kernels import _build
from vatl4pose_tpu_torch.models import (LOSS_REGISTRY, SimplePose,
                                        build_loss, l1_joint_regression_loss,
                                        masked_heatmap_loss,
                                        state_dict_from_flax,
                                        weighted_l1_loss)
from vatl4pose_tpu_torch.ops import (flip_heatmap, integral_coords,
                                     norm_heatmap)
from vatl4pose_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
NORMS = ("softmax", "sigmoid", "divide_sum")
TINY = dict(num_joints=17, num_layers=18, deconv_dim=(8, 8, 8))


def maps(seed, shape=(3, 17, 16, 12)):
    """Positive heatmaps (divide_sum divides by their sum) with a peak."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    hm[..., 5, 4] += 3.0
    return hm


@pytest.mark.parametrize("norm", NORMS)
def test_norm_and_integral_decode_match_jax(norm):
    """f32 on the CPU, the same operations in the same order: within
    1e-6 absolute (the maps are O(1), the coordinates in [-0.5, 0.5))."""
    hm = maps(1)
    got = norm_heatmap(norm, torch.from_numpy(hm))
    want = jax_heatmap.norm_heatmap(norm, jnp.asarray(hm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    coords, maxvals = integral_coords(torch.from_numpy(hm), norm)
    ref_coords, ref_max = jax_heatmap.integral_coords(jnp.asarray(hm), norm)
    assert coords.shape == (3, 17, 2) and maxvals.shape == (3, 17)
    np.testing.assert_allclose(coords.numpy(), np.asarray(ref_coords),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref_max),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError):
        norm_heatmap("l2", torch.from_numpy(hm))


@pytest.mark.parametrize("size_average", [True, False])
def test_weighted_l1_loss_matches_jax(size_average):
    rng = np.random.default_rng(2)
    pred, target = (rng.normal(0, 1, (4, 34)).astype(np.float32)
                    for _ in range(2))
    weight = (rng.uniform(size=(4, 34)) > 0.3).astype(np.float32)
    got = weighted_l1_loss(*map(torch.from_numpy, (pred, target, weight)),
                           size_average)
    want = jax_criterion.weighted_l1_loss(*map(jnp.asarray, (
        pred, target, weight)), size_average)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # no positive weight: the mean divides by 1, as in JAX
    zero = weighted_l1_loss(torch.from_numpy(pred), torch.from_numpy(target),
                            torch.zeros(4, 34), size_average)
    assert zero.item() == 0.0


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("norm", NORMS)
def test_l1_joint_regression_loss_and_grad_match_jax(norm, size_average):
    """The loss within 1e-6 relative, its gradient with respect to the
    heatmaps within 1e-5 of the largest element (jax.grad against
    autograd, f32)."""
    hm = maps(3)
    rng = np.random.default_rng(4)
    uv = rng.uniform(-0.5, 0.5, (3, 34)).astype(np.float32)
    w = (rng.uniform(size=(3, 34)) > 0.2).astype(np.float32)
    hm_t = torch.from_numpy(hm).requires_grad_(True)
    loss = l1_joint_regression_loss(hm_t, torch.from_numpy(uv),
                                    torch.from_numpy(w), norm, size_average)
    loss.backward()

    def jax_loss(h):
        return jax_criterion.l1_joint_regression_loss(
            h, jnp.asarray(uv), jnp.asarray(w), norm, size_average)
    want, grad = jax.value_and_grad(jax_loss)(jnp.asarray(hm))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    grad = np.asarray(grad)
    assert np.abs(hm_t.grad.numpy() - grad).max() <= \
        1e-5 * np.abs(grad).max()


def test_loss_registry_and_build_loss():
    assert set(LOSS_REGISTRY) == set(jax_criterion.LOSS_REGISTRY) \
        == {"MSELoss", "L1JointRegression"}
    assert build_loss({"TYPE": "MSELoss"}) is masked_heatmap_loss
    assert build_loss({"TYPE": "L1JointRegression"}) \
        is l1_joint_regression_loss
    for name in LOSS_REGISTRY:
        assert jax_builder.build_loss({"TYPE": name}).__name__ \
            == build_loss({"TYPE": name}).__name__
    with pytest.raises(KeyError):
        build_loss({"TYPE": "L2"})


@pytest.mark.parametrize("shift", [True, False])
def test_flip_heatmap_matches_jax_exactly(shift):
    hm = np.random.default_rng(5).normal(0, 1, (2, 3, 17, 8, 6)) \
        .astype(np.float32)
    got = flip_heatmap(torch.from_numpy(hm), POSETRACK_JOINT_PAIRS, shift)
    want = jax_heatmap.flip_heatmap(jnp.asarray(hm), POSETRACK_JOINT_PAIRS,
                                    shift)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if not shift:
        back = flip_heatmap(got, POSETRACK_JOINT_PAIRS, shift=False)
        assert torch.equal(back, torch.from_numpy(hm))


CONFIG_TEXT = """
A:
  B: [1, 2]
  C:
    D: 'x'
"""


@pytest.mark.parametrize("source", [
    "text", "configs/posetrack21/al_simple_posetrack.yaml",
    "configs/jrdb-pose/al_simple_jrdb.yaml",
    "configs/synthetic/al_simple_synthetic.yaml"])
def test_load_config_str_matches_jax(source):
    """The cases of tests/test_data_config.py::TestConfig: the same tree,
    attribute access and runtime mutation."""
    text = CONFIG_TEXT if source == "text" \
        else (REPO / source).read_text()
    cfg = config.load_config_str(text)
    assert isinstance(cfg, config.Cfg)
    assert cfg == jax_config.load_config_str(text)
    if source == "text":
        assert cfg.A.B == [1, 2] and cfg.A.C.D == "x"
        cfg.A.C.D = "y"
        cfg.A.NEW = {"Z": 3}
        assert cfg.A.NEW.Z == 3
    else:
        assert cfg.DATA_PRESET.NUM_JOINTS == 17
        assert cfg.RETRAIN.OPTIMIZER == "AdamW"


def flax_variables(num_joints, seed):
    """Tiny SimplePose-R18 Flax variables, every leaf drawn with numpy
    (only the init's shapes are traced)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        FlaxSimplePose(**dict(TINY, num_joints=num_joints)).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))

    def draw(path, a):
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            return rng.normal(0, (2.0 / fan_in) ** 0.5, a.shape) \
                .astype(np.float32)
        return rng.normal(0, 0.05, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def r18():
    return flax_variables(17, 7), flax_variables(14, 8)


def test_jax_checkpoint_loads_in_port(r18, tmp_path):
    """A .pkl from the JAX save_checkpoint: the variables load as the same
    numpy tree, and through state_dict_from_flax the port forwards to the
    Flax output within 1e-4 of its largest element (f32)."""
    variables, _ = r18
    path = jax_checkpoint.save_checkpoint(str(tmp_path / "v.pkl"),
                                          variables)
    back = checkpoint.load_checkpoint(path)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(variables)
    for (p, a), b in zip(leaves, jax.tree_util.tree_leaves(back)):
        assert np.array_equal(a, b), p
    x = np.random.default_rng(9).normal(0, 1, (2, 64, 48, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(FlaxSimplePose(**TINY).apply)(
        variables, jnp.asarray(x)))
    model = SimplePose(**TINY, device="cpu")
    model.load_state_dict(state_dict_from_flax(back, "SimplePose"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = want.transpose(0, 3, 1, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_jax_optimizer_tree_loads_without_jax_classes(r18, tmp_path):
    """The JAX package's OptState loads as the port's OptState: no class
    of jax, flax or the JAX package is unpickled, and any other one is
    refused."""
    params = r18[0]["params"]
    state = jax_optim.init_state(params)
    opt_path = jax_checkpoint.save_checkpoint(str(tmp_path / "o.pkl"),
                                              state)
    back = checkpoint.load_checkpoint(opt_path)
    assert isinstance(back, checkpoint.OptState) and int(back.count) == 0
    assert jax.tree_util.tree_structure(back.m) \
        == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back.v),
                    jax.tree_util.tree_leaves(state.v)):
        assert np.array_equal(a, b)
    other = str(tmp_path / "a.pkl")
    with open(other, "wb") as f:
        pickle.dump({"init": jax_optim.init_state}, f)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load_checkpoint(other)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A state_dict saved by the port (no .pkl suffix: JAX's fallback name)
    loads through the JAX load_checkpoint as numpy arrays of the same
    values."""
    model = SimplePose(**TINY, device="cpu")
    sd = model.state_dict()
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), sd)
    assert path == str(tmp_path / "ck.pkl")
    back = jax_checkpoint.load_checkpoint(path)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert isinstance(back[k], np.ndarray)
        assert np.array_equal(back[k], v.numpy()), k
    assert checkpoint.save_checkpoint(str(tmp_path / "x.pkl"), {}) \
        == str(tmp_path / "x.pkl")


def test_try_load_matches_jax(r18, tmp_path):
    """17-joint weights onto a 14-joint model: the same count as JAX's
    (every leaf but the final layer's weight and bias) and the same
    merged values; the numpy tree form and the state_dict form agree."""
    v17, v14 = r18
    merged, n = jax_checkpoint.try_load(v14, v17)
    n_leaves = len(jax.tree_util.tree_leaves(v14))
    assert n == n_leaves - 2
    sd14 = state_dict_from_flax(v14, "SimplePose")
    sd17 = state_dict_from_flax(v17, "SimplePose")
    got, n_port = checkpoint.try_load(sd14, sd17)
    assert n_port == n
    want = state_dict_from_flax(merged, "SimplePose")
    assert list(got) == list(sd14)
    for k, v in want.items():
        assert got[k].dtype == sd14[k].dtype and torch.equal(got[k], v), k
    # the nested numpy trees themselves, as JAX takes them
    tree, n_tree = checkpoint.try_load(v14, v17)
    assert n_tree == n
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(merged)):
        assert np.array_equal(a, b)
    # the whole state_dict onto itself: every entry loads
    assert checkpoint.try_load(sd17, sd17)[1] == sum(
        not k.endswith("num_batches_tracked") for k in sd17)


def test_load_checkpoint_pth_and_orbax_directory(tmp_path):
    model = SimplePose(**TINY, device="cpu")
    pth = str(tmp_path / "m.pth")
    torch.save(model.state_dict(), pth)
    back = checkpoint.load_checkpoint(pth, "SimplePose")
    assert all(torch.equal(back[k], v) for k, v in
               model.state_dict().items())
    with pytest.raises(ValueError):
        checkpoint.load_checkpoint(pth)
    orbax_dir = tmp_path / "orbax_ckpt"
    (orbax_dir / "default").mkdir(parents=True)
    (orbax_dir / "default" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_checkpoint(str(orbax_dir))


def test_native_warp_available_matches_jax():
    assert native_warp.available() is jax_native_warp.available()


def test_build_keys_follow_the_compiler(monkeypatch):
    """A toolkit that prints another version gets another library path:
    the kernels' (nvcc --version, patched: the test needs no nvcc) and
    the host warp's (g++ --version)."""
    paths = []
    for version in ("Cuda compilation tools, release 12.4",
                    "Cuda compilation tools, release 12.8"):
        monkeypatch.setattr(_build, "toolkit_version", lambda v=version: v)
        paths.append({n: _build.lib_path(n) for n in _build.SIGNATURES})
    assert all(paths[0][n] != paths[1][n] for n in _build.SIGNATURES)
    assert all(p.parent == _build.BUILD_DIR for p in paths[1].values())
    warp = []
    for version in ("g++ 12.2.0", "g++ 13.3.0"):
        monkeypatch.setattr(native_warp, "compiler_version",
                            lambda cxx, v=version: v)
        warp.append(native_warp.lib_path())
    assert warp[0] != warp[1]


def test_reused_video_is_the_clis_synthetic_video(monkeypatch, tmp_path):
    """chip_smoke.py's loops run on phase 3's video files in the place of
    the CLI's --synthetic video: at a tiny size, the annotation that
    --synthetic --synth_seed 0 with VIDEO's sizes writes is byte for byte
    the one phase 3 writes, and its frames decode equal."""
    import chip_smoke
    from vatl4pose_tpu_torch.cli import run_active_learning as cli
    from vatl4pose_tpu_torch.data import build_dataset
    video = dict(num_frames=3, num_persons=2, width=64, height=48)
    monkeypatch.setattr(chip_smoke, "VIDEO", video)
    root, ann = chip_smoke.write_video(str(tmp_path), seed=0)
    opt = cli.parse_args([
        "--video_id", "000001", "--synthetic", "--synth_seed", "0",
        "--synth_frames", str(video["num_frames"]),
        "--synth_persons", str(video["num_persons"]),
        "--synth_size", str(video["width"]), str(video["height"])])
    cfg = config.Cfg({"DATASET": {s: {"TYPE": "Posetrack21"}
                                  for s in ("EVAL", "TRAIN")}})
    cfg = cli.prepare_synthetic(cfg, opt)
    try:
        ev = cfg.DATASET.EVAL
        assert (Path(ev.ROOT) / ev.ANN).read_bytes() \
            == (Path(root) / ann).read_bytes()
        frames = [build_dataset({"TYPE": "Posetrack21", "ROOT": r,
                                 "ANN": a}).load_frames()
                  for r, a in ((ev.ROOT, ev.ANN), (root, ann))]
        assert frames[0].shape == (3, 48, 64, 3)
        assert np.array_equal(*frames)
    finally:
        shutil.rmtree(cfg.DATASET.EVAL.ROOT)
    assert not os.path.exists(cfg.DATASET.EVAL.ROOT)
