"""The port's --vis, --vis_thc and --vis_wpu paths (al/active_learning.py,
utils/vis.py), the figure CLI on their dumps (cli/visualize_result.py)
and plot_learning_curves, against the JAX package's on the CPU.

Both loops run tests/test_torch_al.py's set-up (SimplePose-R18 at 64x64,
a 10-sample synthetic video, QUERY_RATIO [0.2, 0.5, 1.0], DUW with the
Coreset filter, the same numpy weights) with all three flags, and
RETRAIN.ALPHA 0: a retrain moves the two packages' weights apart by
AdamW's sign-like first steps (tests/test_torch_al.py holds those rounds
to 0.02 of AP), so without it every round's heatmaps come from the same
weights and can be held as round 0's are.  The AE is still fine-tuned
every round.

The criteria's figures are drawn through the utils.vis module attribute
(both packages' hooks import it at call time): the test wraps
visualize_thc and visualize_wpu to keep their arguments, and draws each
THC grid with its first joint only, so that the 3x17 grids of 24 samples
do not dominate the test's time; both packages draw the same files.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_al import Opt, run, setup  # noqa: F401 (fixture)
from vatl4pose_tpu.al.active_learning import ActiveLearning as JaxAL
from vatl4pose_tpu.al.al_metric import plot_learning_curves as jax_plc
from vatl4pose_tpu.cli import visualize_result as jax_visres
from vatl4pose_tpu.config import Cfg as JaxCfg
from vatl4pose_tpu.utils import vis as jax_vis
from vatl4pose_tpu_torch.al import ActiveLearning
from vatl4pose_tpu_torch.al.active_learning import vis_thc_inputs
from vatl4pose_tpu_torch.al.al_metric import plot_learning_curves
from vatl4pose_tpu_torch.cli import visualize_result
from vatl4pose_tpu_torch.config import Cfg
from vatl4pose_tpu_torch.utils import vis

torch.set_num_threads(1)
# round 0's heatmaps differ by the folded-BN chain the port serves (the
# JAX package serves the unfused graph in parity mode); the dumps are
# float16, one ulp of which is 2^-11 of the value
HM_RTOL = 1e-4
F16_ULP = 2.0 ** -11
HOOK_TOL = 1e-5
DIRS = ("heatmap", "prediction", "vis_thc", "vis_wpu", "cluster")


def capture(module, calls):
    """Wrappers of module's visualize_thc and visualize_wpu that keep
    their arguments; the THC grid drawn with its first joint only."""
    thc, wpu = module.visualize_thc, module.visualize_wpu

    def visualize_thc(save_dir, ann_id, prev, cur, nxt, score):
        calls["thc"].append((ann_id, np.array(prev), np.array(cur),
                             np.array(nxt), score))
        return thc(save_dir, ann_id, prev[:1], cur[:1], nxt[:1], score)

    def visualize_wpu(save_dir, ann_id, feat_in, feat_out, score):
        calls["wpu"].append((ann_id, np.array(feat_in), np.array(feat_out),
                             score))
        return wpu(save_dir, ann_id, feat_in, feat_out, score)
    return visualize_thc, visualize_wpu


@pytest.fixture(scope="module")
def vis_runs(setup):  # noqa: F811
    tmp, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["RETRAIN"]["ALPHA"] = 0
    out = {}
    for tag, al_cls, cfg_cls, module in (
            ("port", ActiveLearning, Cfg, vis),
            ("jax", JaxAL, JaxCfg, jax_vis)):
        calls = {"thc": [], "wpu": []}
        opt = Opt(str(tmp / f"vis_{tag}"), vis=True, vis_thc=True,
                  vis_wpu=True)
        thc, wpu = capture(module, calls)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "visualize_thc", thc)
            mp.setattr(module, "visualize_wpu", wpu)
            result = run(al_cls(cfg_cls(copy.deepcopy(cfg)), opt))
        out[tag] = (opt.work_dir, calls, result)
    return tmp, cfg, out


def files_under(root, sub):
    base = os.path.join(root, sub)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def test_vis_dumps_match_jax(vis_runs):
    """The same files under heatmap/, prediction/, vis_thc/, vis_wpu/ and
    cluster/; each round's heatmaps.npy float16 (N, 17, 16, 16) within
    the heatmap tolerance plus one float16 ulp, its ann ids equal, and its
    predicted_kpt.json the round's predictions; the same query lists."""
    _, _, out = vis_runs
    got_dir, _, got = out["port"]
    want_dir, _, want = out["jax"]
    assert got[3] == want[3]
    rounds = [f"Round{r}" for r in range(4)]
    for sub in DIRS:
        names = files_under(got_dir, sub)
        assert names == files_under(want_dir, sub), sub
        assert names, sub
    assert files_under(got_dir, "heatmap") == sorted(
        f"{r}/{f}" for r in rounds for f in ("ann_ids.npy", "heatmaps.npy"))
    assert len(files_under(got_dir, "cluster")) == 3   # a round a query
    for r in rounds:
        g = np.load(os.path.join(got_dir, "heatmap", r, "heatmaps.npy"))
        w = np.load(os.path.join(want_dir, "heatmap", r, "heatmaps.npy"))
        assert g.dtype == w.dtype == np.float16
        assert g.shape == w.shape == (10, 17, 16, 16)
        g, w = g.astype(np.float64), w.astype(np.float64)
        np.testing.assert_allclose(
            g, w, rtol=0,
            atol=HM_RTOL * np.abs(w).max() + F16_ULP * np.abs(w).max())
        np.testing.assert_array_equal(
            np.load(os.path.join(got_dir, "heatmap", r, "ann_ids.npy")),
            np.load(os.path.join(want_dir, "heatmap", r, "ann_ids.npy")))
        gp = json.load(open(os.path.join(got_dir, "prediction", r,
                                         "predicted_kpt.json")))
        wp = json.load(open(os.path.join(want_dir, "prediction", r,
                                         "predicted_kpt.json")))
        assert [e["id"] for e in gp] == [e["id"] for e in wp]
        np.testing.assert_allclose([e["keypoints"] for e in gp],
                                   [e["keypoints"] for e in wp], rtol=0,
                                   atol=1e-3)
    # the last round's dump is the run's last predicted_kpt.json
    assert json.load(open(os.path.join(got_dir, "prediction", rounds[-1],
                                       "predicted_kpt.json"))) \
        == json.load(open(os.path.join(got_dir, "predicted_kpt.json")))


def test_vis_hook_arguments_match_jax(vis_runs):
    """What each package passes to visualize_thc (ann id, the three
    heatmap stacks at eval_joints, THC) and to visualize_wpu (ann id, the
    hybrid feature, the AE's reconstruction, WPU): the same calls in the
    same order, the arrays within 1e-5."""
    _, _, out = vis_runs
    got, want = out["port"][1], out["jax"][1]
    # 6 samples of the 10 have both neighbours, 10 WPU samples, 4 passes
    assert len(got["thc"]) == len(want["thc"]) == 24
    assert len(got["wpu"]) == len(want["wpu"]) == 40
    for g, w in zip(got["thc"], want["thc"]):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, np.asarray(b, np.float64),
                                       rtol=0, atol=HOOK_TOL)
    for g, w in zip(got["wpu"], want["wpu"]):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_allclose(a, np.asarray(b, np.float64),
                                       rtol=0, atol=HOOK_TOL)
    # the WPU drawn is the reconstruction's MSE
    for _, feat, recon, wpu in got["wpu"]:
        assert abs(np.mean((recon - feat) ** 2) - wpu) <= 1e-6


def test_render_heatmaps_and_round_on_the_dumps(vis_runs, tmp_path):
    """visualize_result's two renderers on each package's dumps: the same
    files (one heatmap grid a sample, one skeleton image a frame)."""
    tmp, cfg, out = vis_runs
    root, ann = cfg["DATASET"]["EVAL"]["ROOT"], cfg["DATASET"]["EVAL"]["ANN"]
    names = []
    for tag, mod in (("port", visualize_result), ("jax", jax_visres)):
        work_dir = out[tag][0]
        hm = mod.render_heatmaps(work_dir, str(tmp_path / tag / "hm"),
                                 round_idx=2, max_samples=3)
        mod.render_round(work_dir, root, ann, str(tmp_path / tag / "pose"))
        names.append(([os.path.basename(p) for p in hm],
                      sorted(os.listdir(tmp_path / tag / "pose"))))
    assert names[0] == names[1]
    assert len(names[0][0]) == 3 and len(names[0][1]) == 5   # 5 frames


def test_main_renders_from_a_work_dir(vis_runs, tmp_path):
    """visualize_result.main with --heatmaps, as a user calls it."""
    _, cfg, out = vis_runs
    visualize_result.main([
        "--work_dir", out["port"][0], "--dataset_root",
        cfg["DATASET"]["EVAL"]["ROOT"], "--ann_file",
        cfg["DATASET"]["EVAL"]["ANN"], "--out_dir", str(tmp_path),
        "--heatmaps", "--round", "1"])
    assert len(os.listdir(tmp_path / "heatmaps")) == 8


def test_vis_thc_inputs_follow_the_jax_hook():
    """vis_thc_inputs on seeded heatmaps against the JAX hook's own
    selection (ActiveLearning.py:402-411 of the JAX package): the samples
    with both neighbours, their neighbours' maps at eval_joints."""
    rng = np.random.default_rng(7)
    hms = rng.normal(size=(9, 17, 6, 5)).astype(np.float32)
    is_prev = np.array([0, 1, 1, 1, 0, 1, 1, 0, 1], bool)
    is_next = np.array([1, 1, 1, 0, 1, 1, 0, 1, 0], bool)
    ann_ids = np.arange(100, 109)
    thc = rng.random(9)
    joints = (0, 5, 6, 16)
    got = vis_thc_inputs(torch.from_numpy(hms), joints, is_prev, is_next,
                         ann_ids, thc)
    sel = hms[:, list(joints)]
    want = [(int(ann_ids[j]), sel[j - 1], sel[j], sel[j + 1], float(thc[j]))
            for j in range(9) if is_prev[j] and is_next[j]]
    assert [g[0] for g in got] == [w[0] for w in want] == [101, 102, 105]
    for g, w in zip(got, want):
        for a, b in zip(g[1:4], w[1:4]):
            np.testing.assert_array_equal(a, b)
        assert g[4] == w[4]


def test_figures_match_jax(tmp_path):
    """Each figure function of utils/vis.py and plot_learning_curves on
    the same seeded inputs: the same file in each package's directory."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (40, 50, 3), np.uint8)
    kpts = np.concatenate([rng.uniform(0, 40, (17, 2)),
                           rng.random((17, 1))], 1)
    np.testing.assert_array_equal(vis.vis_frame_fast(img, kpts),
                                  jax_vis.vis_frame_fast(img, kpts))
    emb = rng.normal(size=(12, 6))
    hms = rng.random((3, 4, 8, 6))
    names = []
    for tag, mod, plc in (("port", vis, plot_learning_curves),
                          ("jax", jax_vis, jax_plc)):
        d = str(tmp_path / tag)
        paths = [mod.visualize_thc(d, 7, *hms[:, :2], 0.5),
                 mod.visualize_wpu(d, 7, rng.random(38), rng.random(38),
                                   0.1),
                 mod.plot_embedding_selection(d, emb, [1, 4], "Coreset_r0",
                                              cluster_idx=np.arange(12) % 3),
                 plc(d, "000001", "DUW", [0, 50, 100], [10, 40, 60],
                     ann=True)]
        names.append([os.path.relpath(p, d) for p in paths])
        assert all(os.path.getsize(p) > 0 for p in paths)
    assert names[0] == names[1]


def test_float16_dump_cast_matches_numpy():
    """The --vis dump casts the heatmaps to float16 with torch where they
    are; the JAX package casts on the host with numpy: the same bits for
    normal, subnormal, tie, overflowing and negative values."""
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.normal(0, 3, 4096), rng.normal(0, 1e-5, 1024),   # subnormals
        np.float32(1 + 2.0 ** -11) * np.arange(1, 65),        # ties
        [65504.0, 65520.0, 7e4, -7e4, 0.0, -0.0, 6e-8, 3e-8]]).astype(
            np.float32)
    got = torch.from_numpy(x).to(torch.float16).numpy()
    np.testing.assert_array_equal(got.view(np.uint16),
                                  x.astype(np.float16).view(np.uint16))
