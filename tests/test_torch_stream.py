"""The port's streaming path (vatl4pose_tpu_torch/data/native_warp.py,
data/stream.py, ScoringEngine.score_streaming, Retrainer.retrain_streaming
and the AL loop over VAL.HBM_FRAME_BUDGET_GB) against the JAX package's on
the CPU, with the same numpy inputs and weights."""

import copy
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_al import Opt, run, setup  # noqa: F401
from tests.test_torch_models import random_flax_variables
from vatl4pose_tpu.al.active_learning import ActiveLearning as JaxAL
from vatl4pose_tpu.al.scoring import ScoringConfig as JaxScoringConfig
from vatl4pose_tpu.al.scoring import ScoringEngine as JaxScoringEngine
from vatl4pose_tpu.config import Cfg as JaxCfg
from vatl4pose_tpu.data import native_warp as jax_native_warp
from vatl4pose_tpu.data import stream as jax_stream
from vatl4pose_tpu.data.dataset import build_dataset as jax_build_dataset
from vatl4pose_tpu.data.pipeline import AugCfg as JaxAugCfg
from vatl4pose_tpu.data.synthetic import (make_synthetic_multivideo,
                                          make_synthetic_video)
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu.train.retrain import Retrainer as JaxRetrainer
from vatl4pose_tpu_torch.al import ActiveLearning, ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.config import Cfg
from vatl4pose_tpu_torch.data import (AugCfg, build_dataset, native_warp,
                                      train_sample_geometry)
from vatl4pose_tpu_torch.data.stream import (CropStreamer, FrameStore,
                                             warp_crops_host)
from vatl4pose_tpu_torch.models import SimplePose, state_dict_from_flax
from vatl4pose_tpu_torch.train import Retrainer

torch.set_num_threads(1)
INPUT = (64, 64)
R18 = dict(num_joints=17, num_layers=18, deconv_dim=(64, 64, 64))
PRESET = {"TYPE": "simple", "SIGMA": 2, "NUM_JOINTS": 17,
          "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16]}
MCFG = {"TYPE": "SimplePose", "NUM_DECONV_FILTERS": [64, 64, 64],
        "NUM_LAYERS": 18}


def _ds(root, ann):
    d = {"TYPE": "Posetrack21", "ROOT": root, "ANN": ann, "IMG_PREFIX": ""}
    return build_dataset(d), jax_build_dataset(JaxCfg(d))


@pytest.fixture(scope="module")
def multi_root(tmp_path_factory):
    """Two videos of other frame sizes in one annotation file."""
    return make_synthetic_multivideo(
        str(tmp_path_factory.mktemp("multi")), num_videos=2, num_frames=3,
        num_persons=2, sizes=[(320, 240), (192, 256)])


@pytest.fixture(scope="module")
def single_root(tmp_path_factory):
    """5 frames x 2 persons = 10 samples at 160x128, as the JAX package's
    streaming tests have it."""
    return make_synthetic_video(str(tmp_path_factory.mktemp("single")),
                                num_frames=5, num_persons=2, width=160,
                                height=128)


@pytest.fixture(scope="module")
def weights():
    """A SimplePose-R18 at 64x64 (deconv 64) drawn with numpy: He-scaled,
    random BN statistics."""
    model = jax_build_sppe(JaxCfg(MCFG), JaxCfg(PRESET), train=True)
    return random_flax_variables(model, jnp.zeros((1, 64, 64, 3)),
                                 np.random.default_rng(2718))


def _port_model(variables, fused_eval=True):
    model = SimplePose(**R18, fused_eval=fused_eval, device="cpu")
    model.load_state_dict(state_dict_from_flax(
        jax.tree.map(np.asarray, variables), "SimplePose"))
    return model


def _bbox_ann(d):
    return np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                     d.bboxes[:, 2] - d.bboxes[:, 0],
                     d.bboxes[:, 3] - d.bboxes[:, 1]], 1)


# ---- frames and crops ------------------------------------------------------

def test_frame_store_lru_matches_jax(multi_root):
    """The same frames, sizes and total bytes, and the same LRU order and
    evictions under a cap of about two frames; a cap below one frame keeps
    one."""
    ds, jds = _ds(*multi_root)
    assert ds.data.item_img_wh().tolist() == jds.data.item_img_wh().tolist()
    with pytest.raises(ValueError, match="mixed frame sizes"):
        ds.load_frames()
    cap = 2 * 320 * 240 * 3
    store, jstore = ds.frame_store(cache_bytes=cap), \
        jds.frame_store(cache_bytes=cap)
    assert isinstance(store, FrameStore)
    assert store.total_bytes == jstore.total_bytes == sum(
        w * h * 3 for w, h in ds.data.frame_sizes)
    for i in (0, 1, 0, 4, 2, 5, 1, 1, 3, 0):
        np.testing.assert_array_equal(store.get(i), jstore.get(i))
        assert list(store._cache) == list(jstore._cache)
        assert store._cached_bytes == jstore._cached_bytes <= cap
    tiny = ds.frame_store(cache_bytes=1)
    for i in range(len(tiny)):
        tiny.get(i)
    assert len(tiny._cache) == 1


@pytest.mark.parametrize("mode", [0, 1])
def test_warp_crops_host_bit_equal_to_jax(multi_root, mode):
    """Crops of both frame sizes, rotated and scaled, through the port's
    build of native/warp against the JAX package's: bit for bit."""
    ds, jds = _ds(*multi_root)
    d = ds.data
    rng = np.random.default_rng(7 + mode)
    _, _, _, _, fwd = train_sample_geometry(
        d.bboxes, d.joints_xy, d.joints_vis, d.item_img_wh(), INPUT,
        AugCfg(scale_factor=0.3, rot_factor=40, flip=True), ds.joint_pairs,
        rng)
    got = warp_crops_host(ds.frame_store(), d.frame_idx, fwd, INPUT,
                          mode=mode)
    want = jax_stream.warp_crops_host(jds.frame_store(), d.frame_idx, fwd,
                                      INPUT, mode=mode)
    assert got.dtype == np.uint8 and got.shape == (len(d), 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    # the port builds its own library and never the JAX package's
    assert native_warp.lib_path().parent.name == "build"
    assert native_warp.lib_path() != jax_native_warp._LIB_PATH


def test_native_warp_refuses_bad_operands():
    frames = np.zeros((1, 8, 8, 3), np.uint8)
    mats = np.tile(np.eye(2, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="mode"):
        native_warp.warp_affine_batch(frames, [0], mats, (4, 4), mode=2)
    with pytest.raises(IndexError):
        native_warp.warp_affine_batch(frames, [1], mats, (4, 4))


def test_crop_streamer_matches_jax(multi_root):
    """One seed, the same stream: the geometry and crops of every batch
    (flips, rotations, two frame sizes, a short last batch) equal the JAX
    streamer's, over two epochs."""
    ds, jds = _ds(*multi_root)
    aug = dict(scale_factor=0.3, rot_factor=40, flip=True)
    s = CropStreamer(ds.data, ds.frame_store(), INPUT, AugCfg(**aug),
                     ds.joint_pairs, batch_size=5, seed=31)
    js = jax_stream.CropStreamer(jds.data, jds.frame_store(), INPUT,
                                 JaxAugCfg(**aug), jds.joint_pairs,
                                 batch_size=5, seed=31)
    idx = np.arange(len(ds.data))
    for _ in range(2):
        got, want = list(s.epoch(idx)), list(js.epoch(idx))
        assert [b[3] for b in got] == [b[3] for b in want] == [5, 5, 2]
        for a, b in zip(got, want):
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(x, y)


def test_crop_streamer_producer_error_reaches_consumer(single_root):
    """An exception in the producer thread is raised in the consumer after
    the batches made before it; a consumer that stops early stops the
    producer."""
    ds, _ = _ds(*single_root)

    class Broken(FrameStore):
        def get(self, idx):
            if idx == 3:
                raise OSError("frame 3 is unreadable")
            return super().get(idx)

    d = ds.data
    store = Broken(d.frame_paths, d.frame_sizes)
    s = CropStreamer(d, store, INPUT, AugCfg(), ds.joint_pairs,
                     batch_size=2, seed=0)
    order = np.argsort(d.frame_idx, kind="stable")
    first = int(np.argmax(d.frame_idx[order] == 3)) // 2   # its batch
    assert first >= 1
    seen = []
    with pytest.raises(OSError, match="unreadable"):
        for batch in s.epoch(order, shuffle=False):
            seen.append(batch[3])
    assert seen == [2] * first
    before = threading.active_count()
    it = s.epoch(np.arange(len(d)))
    next(it)
    it.close()
    assert threading.active_count() <= before


# ---- scoring -----------------------------------------------------------------

def _engines(variables, chunk, uncertainty="THC_L1", need_embedding=True):
    jax_engine = JaxScoringEngine(
        jax_build_sppe(JaxCfg(MCFG), JaxCfg(PRESET), train=False),
        JaxScoringConfig(uncertainty=uncertainty,
                         need_embedding=need_embedding, input_size=INPUT),
        chunk=chunk)
    engine = ScoringEngine(_port_model(variables), ScoringConfig(
        uncertainty=uncertainty, need_embedding=need_embedding,
        input_size=INPUT), chunk=chunk, device="cpu")
    return jax_engine, engine


def test_score_streaming_matches_jax(single_root, weights):
    """R18 at 64x64, chunk 4 over 10 samples (halo crossings at two chunk
    edges), as the JAX package's test sets it up.  Both take the same host
    crops, so they differ by the port's folded-BN chain and summation
    order only: heatmaps and embeddings within 1e-4 of their max, the
    scores within rtol 1e-4, and the decoded keypoints where no argmax is
    within 1e-4 of a tie."""
    ds, jds = _ds(*single_root)
    d = ds.data
    args = (d.frame_idx, d.bboxes, d.gt_keypoints, _bbox_ann(d), d.is_prev,
            d.is_next)
    jax_engine, engine = _engines(weights, 4)
    want = jax_engine.score_streaming(jax.tree.map(jnp.asarray, weights),
                                      jds.frame_store(), *args,
                                      keep_heatmaps=True)
    got = engine.score_streaming(ds.frame_store(), *args,
                                 keep_heatmaps=True)
    assert set(got) == set(want)
    hm, whm = got["heatmaps"].numpy(), np.asarray(want["heatmaps"])
    assert hm.shape == whm.shape == (10, 17, 16, 16)
    assert np.abs(hm - whm).max() <= 1e-4 * np.abs(whm).max()
    assert np.abs(got["embeddings"] - want["embeddings"]).max() \
        <= 1e-4 * np.abs(want["embeddings"]).max()
    np.testing.assert_array_equal(got["bbox_crop"], want["bbox_crop"])
    for k in ("scores", "det_score", "gc", "unc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    top = np.sort(whm.reshape(10, 17, -1), axis=-1)
    clear = (top[..., -1] - top[..., -2]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got["coords"][clear], want["coords"][clear],
                               rtol=1e-4, atol=1e-3)
    whole = clear.all(axis=1)
    np.testing.assert_allclose(got["oks"][whole], want["oks"][whole],
                               rtol=1e-4, atol=1e-6)


def test_score_streaming_chunk_invariant_and_near_resident(single_root,
                                                           weights):
    """The streamed path against itself at chunk 3 and 10: equal within
    1e-5 on every output (the halo makes the chunk edges invisible).
    Against the resident path (device-side float crops, which differ from
    the host warp's by up to 1 LSB): the JAX package's bounds, rtol = atol
    = 2e-2 on oks, unc, det_score and gc, and 99% of kpts within (2e-2,
    1.0)."""
    ds, _ = _ds(*single_root)
    d = ds.data
    args = (d.frame_idx, d.bboxes, d.gt_keypoints, _bbox_ann(d), d.is_prev,
            d.is_next)
    outs = [_engines(weights, c)[1].score_streaming(ds.frame_store(), *args)
            for c in (3, 10)]
    for k in ("oks", "unc", "det_score", "gc", "kpts", "embeddings",
              "coords", "scores"):
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    resident = _engines(weights, 4)[1].score(ds.load_frames(), *args)
    for k in ("oks", "unc", "det_score", "gc"):
        np.testing.assert_allclose(outs[0][k], resident[k], rtol=2e-2,
                                   atol=2e-2, err_msg=k)
    close = np.isclose(outs[0]["kpts"], resident["kpts"], rtol=2e-2,
                       atol=1.0)
    assert close.mean() > 0.99, close.mean()


# ---- retraining ----------------------------------------------------------------

def test_retrain_streaming_matches_jax(single_root, weights):
    """One epoch over 10 samples in batches of 4 (the last cycle-padded)
    on the streamers' host crops, from the same weights and the same
    streamer seed.  Parameters and BN statistics within the bounds of
    tests/test_torch_train.py's Retrainer test, loss and accuracy within
    rel 1e-3."""
    ds, jds = _ds(*single_root)
    rcfg = {"OPTIMIZER": "AdamW", "LR": 2.5e-4, "LR_GAMMA": 0.99,
            "BATCH_SIZE": 4, "WEIGHT_DECAY": 0.7}
    aug = dict(scale_factor=0.1, rot_factor=20, flip=True)
    kw = dict(input_size=INPUT, hm_size=(16, 16), joint_pairs=ds.joint_pairs)
    idx = np.arange(len(ds.data))
    jtr = JaxRetrainer(jax_build_sppe(JaxCfg(MCFG), JaxCfg(PRESET),
                                      train=True), rcfg, "SimplePose",
                       aug=JaxAugCfg(**aug), **kw)
    js = jax_stream.CropStreamer(jds.data, jds.frame_store(), INPUT,
                                 JaxAugCfg(**aug), jds.joint_pairs, 4, seed=5)
    ref_vars, _, ref_loss, ref_acc = jtr.retrain_streaming(
        weights, jtr.init_opt_state(weights["params"]), js, idx, 1)

    model = _port_model(weights, fused_eval=False).eval()
    tr = Retrainer(model, rcfg, "SimplePose", aug=AugCfg(**aug),
                   device="cpu", **kw)
    s = CropStreamer(ds.data, ds.frame_store(), INPUT, AugCfg(**aug),
                     ds.joint_pairs, 4, seed=5)
    loss, acc = tr.retrain_streaming(s, idx, 1)
    assert tr.epoch_counter == 1 and not model.training

    want = state_dict_from_flax(jax.tree.map(np.asarray, ref_vars),
                                "SimplePose")
    start = state_dict_from_flax(jax.tree.map(np.asarray, weights),
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
        moved += not np.array_equal(b, start[k].numpy())
    assert moved > 0.9 * sum(not k.endswith("num_batches_tracked")
                             for k in want)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-3)
    np.testing.assert_allclose(acc, ref_acc, rtol=1e-3, atol=1e-6)


# ---- the AL loop over the frame budget ---------------------------------------

def test_al_loop_over_budget_streams_and_matches_jax(setup):  # noqa: F811
    """VAL.HBM_FRAME_BUDGET_GB = 1e-6: both loops keep the frames in host
    RAM and score and retrain from the host warp; the DUW query sets are
    equal every round, and every sample is queried once."""
    tmp, base = setup
    cfg = copy.deepcopy(base)
    cfg["VAL"]["HBM_FRAME_BUDGET_GB"] = 1e-6
    al = ActiveLearning(Cfg(copy.deepcopy(cfg)), Opt(str(tmp / "stream")))
    assert al.streaming and al.frames_dev is None
    got = run(al)
    jal = JaxAL(JaxCfg(copy.deepcopy(cfg)), Opt(str(tmp / "jax_stream")))
    assert jal.streaming
    want = run(jal)
    assert list(got[3]) == list(want[3]) == ["Round0", "Round1", "Round2"]
    for rc in want[3]:
        assert set(got[3][rc]) == set(want[3][rc]), rc
    assert sorted(q for qs in got[3].values() for q in qs) == list(range(10))
    assert got[0] == want[0] == [0.0, 20.0, 50.0, 100.0]
