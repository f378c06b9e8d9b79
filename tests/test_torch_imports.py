"""Every module of vatl4pose_tpu_torch imports without JAX, Flax, the JAX
package, sklearn, PyYAML, matplotlib, cv2 or PIL: the machine with the card
has none of them."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "flax", "vatl4pose_tpu", "sklearn", "yaml",
           "matplotlib", "cv2", "PIL")

_SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

REFUSED = %r


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None


for name in list(sys.modules):
    if name.split(".")[0] in REFUSED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())
import vatl4pose_tpu_torch
names = ["vatl4pose_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(vatl4pose_tpu_torch.__path__,
                                          "vatl4pose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_refused_packages():
    out = subprocess.run([sys.executable, "-c", _SCRIPT % (REFUSED,)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    # the package, its subpackages and every module in them
    assert int(out.stdout.split()[-1]) >= 78


def test_refusing_finder_refuses():
    """The guard itself works: importing a refused package fails."""
    script = _SCRIPT % (REFUSED,) + "\nimport yaml\n"
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "refused import of yaml" in out.stderr


def test_streaming_path_runs_without_refused_packages():
    """The streaming modules are among those imported, and the host warp
    and the frame store run behind the same finder: .npy frames, the port's
    own build of native/warp, no cv2."""
    script = _SCRIPT % (REFUSED,) + r"""
import os, tempfile
import numpy as np
assert {"vatl4pose_tpu_torch.data.stream",
        "vatl4pose_tpu_torch.data.native_warp"} <= set(names)
from vatl4pose_tpu_torch.data.stream import FrameStore, warp_crops_host
tmp = tempfile.mkdtemp()
frame = np.random.default_rng(0).integers(0, 256, (40, 50, 3), np.uint8)
np.save(os.path.join(tmp, "f.npy"), frame)
store = FrameStore([os.path.join(tmp, "f.npy")], [[50, 40]])
mats = np.array([[[1.0, 0.0, -3.0], [0.0, 1.0, -2.0]]])
crops = warp_crops_host(store, np.array([0]), mats, (8, 8))
assert (crops[0] == frame[2:10, 3:11]).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_strategy_modules_run_without_refused_packages():
    """The modules of the other strategies are among those imported and
    run behind the same finder: the K-Means filter (no sklearn), the
    UNC_LAMBDA study (its plots need matplotlib, the study does not), the
    LSH kNN, the AuxNet and VL4Pose's tree score."""
    script = _SCRIPT % (REFUSED,) + r"""
import numpy as np
import torch
assert {"vatl4pose_tpu_torch.models.auxnet", "vatl4pose_tpu_torch.ops.vl4pose",
        "vatl4pose_tpu_torch.al.ann", "vatl4pose_tpu_torch.al.optuna_lite",
        "vatl4pose_tpu_torch.al.kmeans"} <= set(names)
from vatl4pose_tpu_torch.al import ann, optuna_lite
from vatl4pose_tpu_torch.al.selection import kmeans_filter
from vatl4pose_tpu_torch.models import AuxNet
from vatl4pose_tpu_torch.ops.vl4pose import vl4pose_scores
rng = np.random.default_rng(0)
emb = rng.random((30, 16)).astype(np.float32)
picks = kmeans_filter(emb, list(range(30)), 4, weight=1 + rng.random(30),
                      dedupe=True)
assert len(set(picks)) == 4
study = optuna_lite.create_study(
    sampler=optuna_lite.GridSampler({"x": [0.5, 2.0]}))
study.optimize(lambda t: -abs(t.suggest_float("x", 0.1, 10) - 2), 2)
assert study.best_params == {"x": 2.0}
try:
    study.plot_history("unused.png")
    raise AssertionError("plot_history ran without matplotlib")
except ImportError:
    pass
assert ann.LshTransformer(n_neighbors=3).fit_transform(emb).nnz > 0
params = AuxNet(in_channels=8, device="cpu")(torch.rand(2, 8, 4, 3))
assert params.shape == (2, 16, 2)
hms = torch.rand(2, 17, 24, 24)
assert torch.isfinite(vl4pose_scores(hms, params.detach())).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_pretraining_modules_run_without_refused_packages(tmp_path):
    """The pre-training, evaluation and preparation modules are among those
    imported and run behind the same finder: a combined two-video set
    (mixed frame sizes), the AE's whole-body features, the extra datasets,
    the loggers, and prepare_data's integrate (which reads no image, so
    needs no cv2)."""
    script = _SCRIPT % (REFUSED,) + r"""
import json, os, sys
assert {"vatl4pose_tpu_torch.cli.posetrack_train",
        "vatl4pose_tpu_torch.cli.jrdbpose_train",
        "vatl4pose_tpu_torch.cli.poseestimator_eval",
        "vatl4pose_tpu_torch.cli.wholebodyAE_train",
        "vatl4pose_tpu_torch.cli.prepare_data",
        "vatl4pose_tpu_torch.data.wholebody",
        "vatl4pose_tpu_torch.data.extra_datasets",
        "vatl4pose_tpu_torch.utils.logger"} <= set(names)
from vatl4pose_tpu_torch.cli import prepare_data
from vatl4pose_tpu_torch.data import (Wholebody, build_dataset,
                                      make_synthetic_multivideo)
from vatl4pose_tpu_torch.utils.logger import ScalarWriter, make_logger
from vatl4pose_tpu_torch.utils.metrics import DataLogger
tmp = sys.argv[1]
root, ann = make_synthetic_multivideo(tmp, num_videos=2, num_frames=2,
                                      num_persons=2, seed=3)
ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root, "ANN": ann})
assert ds.data.mixed_sizes and len(ds) == 8
coco = build_dataset({"TYPE": "Mscoco", "ROOT": root, "ANN": ann})
assert not coco.data.is_prev.any()
assert Wholebody(os.path.join(root, ann)).features.shape == (8, 38)
log = DataLogger()
log.update(2.0, 3)
assert log.avg == 2.0
make_logger("imports", os.path.join(tmp, "log")).epochInfo(0, 0.5, 0.25)
ScalarWriter(os.path.join(tmp, "log")).write("loss", 0.5, 0)
al = os.path.join(tmp, "pt", "activelearning", "val")
os.makedirs(al)
with open(os.path.join(root, ann)) as f:
    data = json.load(f)
with open(os.path.join(al, "000001.json"), "w") as f:
    json.dump(data, f)
prepare_data.main(["integrate", "--root", os.path.join(tmp, "pt"),
                   "--mode", "val"])
with open(os.path.join(al, "000000_integrated_val.json")) as f:
    assert len(json.load(f)["annotations"]) == 8
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_analysis_modules_run_without_refused_packages(tmp_path):
    """The analysis, tracking-evaluation and visualisation modules are
    among those imported, and their numeric paths run behind the same
    finder: the tracking metrics and JRDB AP through pose_track_eval and
    average_precision_for_loc, the result summaries, detailed_result's
    numeric artifacts and the LaTeX table; every function that draws
    raises ImportError there instead."""
    script = _SCRIPT % (REFUSED,) + r"""
import json, os, sys
import numpy as np
assert {"vatl4pose_tpu_torch.eval.tracking",
        "vatl4pose_tpu_torch.eval.jrdb_ap",
        "vatl4pose_tpu_torch.utils.vis",
        "vatl4pose_tpu_torch.cli.pose_track_eval",
        "vatl4pose_tpu_torch.cli.summarize_result",
        "vatl4pose_tpu_torch.cli.detailed_result",
        "vatl4pose_tpu_torch.cli.wacv_result",
        "vatl4pose_tpu_torch.cli.visualize_result",
        "vatl4pose_tpu_torch.cli.convert_to_eps"} <= set(names)
from vatl4pose_tpu_torch.al.al_metric import plot_learning_curves
from vatl4pose_tpu_torch.cli import (convert_to_eps, detailed_result,
                                     pose_track_eval, summarize_result,
                                     wacv_result)
from vatl4pose_tpu_torch.eval import average_precision_for_loc
from vatl4pose_tpu_torch.utils import vis
tmp = sys.argv[1]
rng = np.random.default_rng(0)
images, anns = [{"id": f} for f in range(3)], []
for f in range(3):
    for t in range(2):
        kp = np.ones(51)
        kp[0::3] = rng.uniform(0, 100, 17) + 200 * t
        kp[1::3] = rng.uniform(0, 200, 17)
        anns.append({"id": 10 * f + t, "image_id": f, "track_id": t,
                     "bbox": [200.0 * t, 0.0, 100.0, 200.0],
                     "area": 2e4, "keypoints": kp.tolist()})
gt = {"images": images, "annotations": anns}
json.dump(gt, open(os.path.join(tmp, "gt.json"), "w"))
_, res = pose_track_eval.main(["--gt", os.path.join(tmp, "gt.json"),
                               "--pred", os.path.join(tmp, "gt.json")])
assert abs(res["HOTA"] - 1) < 1e-12 and res["IDSW"] == 0
assert res["MOTA"] == 1.0 and res["OSPA"] == 0.0
ap, rec = average_precision_for_loc(gt, anns)
assert ap[-1] == 100.0 and rec[-1] == 100.0
run = os.path.join(tmp, "exp", "AL_x", "SimplePose", "S", "000001", "t")
os.makedirs(run)
perf = [{k: a for k in detailed_result.METRIC_KEYS} for a in (0.2, 0.6)]
json.dump({"percentages": [0, 100], "performances": perf,
           "performances_ann": perf, "mean_uncertaity": [2.0, 1.0],
           "spearmanr": [], "actual_finish": 100, "finished_minerror": 50,
           "finished_oursc": 100}, open(os.path.join(run, "result.json"), "w"))
root = os.path.join(tmp, "exp")
table = summarize_result.summarize(root)
assert abs(table["S"]["mean_ALC"] - 0.4) < 1e-12
assert "S &" in wacv_result.latex_table(table)
rd, _ = detailed_result.collect(root)
alc = detailed_result.metric_json(rd, "AP")["S"]["AP_ALC"]
assert abs(alc - 0.4) < 1e-12
for draw in (lambda: detailed_result.main(["--exp_root", root]),
             lambda: wacv_result.alc_bar_chart(table, tmp),
             lambda: plot_learning_curves(tmp, "v", "S", [0, 100], [1, 2]),
             lambda: vis.visualize_wpu(tmp, 1, np.ones(38), np.ones(38), 0.),
             lambda: vis.vis_frame_fast(np.zeros((4, 4, 3), np.uint8),
                                        np.ones((17, 3))),
             lambda: convert_to_eps.main(["--dir", tmp])):
    try:
        draw()
        raise AssertionError("a figure was drawn without its package")
    except ImportError:
        pass
assert os.path.exists(os.path.join(root, "analysis", "sc_summary.json"))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_library_tail_runs_without_refused_packages(tmp_path):
    """The checkpoint module is among those imported, and it saves, loads
    and partially loads a state_dict behind the same finder; the config
    module imports without PyYAML, and load_config_str (like
    update_config) imports it only when called."""
    script = _SCRIPT % (REFUSED,) + r"""
import os, sys
import torch
assert {"vatl4pose_tpu_torch.utils.checkpoint",
        "vatl4pose_tpu_torch.config"} <= set(names)
from vatl4pose_tpu_torch import config
from vatl4pose_tpu_torch.models import SimplePose, build_loss
from vatl4pose_tpu_torch.ops import flip_heatmap, integral_coords
from vatl4pose_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint, try_load)
sd = SimplePose(num_joints=17, num_layers=18, deconv_dim=(8, 8, 8),
                device="cpu").state_dict()
back = load_checkpoint(save_checkpoint(os.path.join(sys.argv[1], "ck"), sd))
target = SimplePose(num_joints=14, num_layers=18, deconv_dim=(8, 8, 8),
                    device="cpu").state_dict()
merged, n = try_load(target, back)
assert n == sum(not k.endswith("num_batches_tracked") for k in sd) - 2
assert torch.equal(merged["preact.conv1.weight"], sd["preact.conv1.weight"])
hms = torch.rand(2, 17, 8, 6)
loss = build_loss({"TYPE": "L1JointRegression"})(
    hms, torch.zeros(2, 34), torch.ones(2, 34))
assert torch.isfinite(loss) and integral_coords(hms)[0].shape == (2, 17, 2)
assert flip_heatmap(hms, [[5, 6]]).shape == hms.shape
try:
    config.load_config_str("A: 1")
    raise AssertionError("load_config_str ran without PyYAML")
except ImportError as e:
    assert "yaml" in str(e)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
