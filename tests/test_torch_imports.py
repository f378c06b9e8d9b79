"""Every module of vatl4pose_tpu_torch imports without JAX, Flax, the JAX
package, sklearn, PyYAML, matplotlib, cv2 or PIL: the machine with the card
has none of them.  Since the port draws its own figures (utils/raster.py,
utils/figure.py), the figure functions and the analysis CLIs run behind
the refusing finder too."""

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
    UNC_LAMBDA study and its two plots (no matplotlib), the LSH kNN, the
    AuxNet and VL4Pose's tree score."""
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
import os, tempfile
tmp = tempfile.mkdtemp()
for plot in (study.plot_history, study.plot_slice):
    path = plot(os.path.join(tmp, plot.__name__ + ".png"))
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
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
    numeric artifacts and the LaTeX table; and every function that draws
    (no matplotlib, cv2 or PIL) writes its file there."""
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
detailed_result.main(["--exp_root", root])
assert os.path.exists(os.path.join(root, "analysis", "ANN", "AP_ann.pdf"))
assert os.path.exists(wacv_result.alc_bar_chart(table, tmp))
assert os.path.exists(plot_learning_curves(tmp, "v", "S", [0, 100], [1, 2]))
assert os.path.exists(vis.visualize_wpu(tmp, 1, np.ones(38), np.ones(38),
                                        0.))
out = vis.vis_frame_fast(np.zeros((4, 4, 3), np.uint8), np.ones((17, 3)))
assert (out[1, 1] == (255, 0, 0)).all()
assert [os.path.basename(p) for p in convert_to_eps.main(["--dir", tmp])] \
    == ["alc_bar.eps", "learning_curve_S_v.eps", "wpu_1.eps"]
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
    module imports and load_config_str reads YAML without PyYAML (the
    port's own reader)."""
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
assert config.load_config_str("A: 1\nB: [x, 2.5]") == {"A": 1,
                                                       "B": ["x", 2.5]}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_config_and_frames_run_without_refused_packages(tmp_path):
    """The entry points' inputs are read behind the same finder (no yaml,
    cv2 or PIL): update_config on a config file, decode_frame on the
    committed JPEG video (its recorded decode hashes) and on a PNG that the
    synthetic video's png format writes, the resident dataset and the
    FrameStore over those JPEGs, and prepare_data's image sizes."""
    script = _SCRIPT % (REFUSED,) + r"""
import hashlib, json, os, sys
import numpy as np
assert "vatl4pose_tpu_torch.data.image_io" in set(names)
from vatl4pose_tpu_torch.cli import prepare_data
from vatl4pose_tpu_torch.config import update_config
from vatl4pose_tpu_torch.data import build_dataset, make_synthetic_video
from vatl4pose_tpu_torch.data.dataset import decode_frame
cfg = update_config("configs/posetrack21/al_simple_posetrack.yaml")
assert cfg.RETRAIN.ALPHA == 250 and cfg.VAL.VIS is True
assert cfg.DATA_PRESET.IMAGE_SIZE == [256, 192]
fixture = os.path.join("tests", "data", "jpeg_video")
with open(os.path.join(fixture, "decoded_sha256.json")) as f:
    recorded = json.load(f)
ds = build_dataset({"TYPE": "Posetrack21", "ROOT": fixture,
                    "ANN": "annotations/000001.json"})
frames = ds.load_frames()
store = ds.frame_store()
for i, (name, digest) in enumerate(recorded.items()):
    path = os.path.join(fixture, name)
    assert hashlib.sha256(decode_frame(path).tobytes()).hexdigest() == digest
    assert (frames[i] == store.get(i)).all()
    assert prepare_data._img_size(path) == (640, 360)
tmp = sys.argv[1]
kw = dict(num_frames=1, num_persons=1, width=40, height=30, seed=2)
make_synthetic_video(os.path.join(tmp, "npy"), **kw)
make_synthetic_video(os.path.join(tmp, "png"), img_format="png", **kw)
png = os.path.join(tmp, "png", "images", "000001", "000000.png")
want = np.load(os.path.join(tmp, "npy", "images", "000001", "000000.npy"))
assert (decode_frame(png) == want).all()
assert prepare_data._img_size(png) == (40, 30)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_figures_run_without_refused_packages(tmp_path):
    """Every figure function of the port and the mains of detailed_result,
    wacv_result, visualize_result (--heatmaps) and convert_to_eps run
    behind the same finder (no matplotlib, cv2 or PIL): each writes its
    PNG, PDF or EPS, the PNGs decode at figsize x dpi, and the glyph
    table and colour maps load from the package's data."""
    script = _SCRIPT % (REFUSED,) + r"""
import json, os, sys
import numpy as np
from vatl4pose_tpu_torch.al import optuna_lite
from vatl4pose_tpu_torch.al.al_metric import plot_learning_curves
from vatl4pose_tpu_torch.cli import (convert_to_eps, detailed_result,
                                     visualize_result, wacv_result)
from vatl4pose_tpu_torch.data.image_io import read_images, write_png
from vatl4pose_tpu_torch.utils import vis
tmp = sys.argv[1]
rng = np.random.default_rng(0)
figs = os.path.join(tmp, "figs")
paths = [vis.visualize_thc(figs, 3, *rng.random((3, 2, 8, 6)), 0.5),
         vis.visualize_wpu(figs, 3, rng.random(38), rng.random(38), 0.1),
         vis.plot_embedding_selection(figs, rng.normal(size=(9, 4)), [2],
                                      "Coreset_round0",
                                      cluster_idx=np.arange(9) % 2),
         plot_learning_curves(figs, "v", "S", [0, 50, 100], [5, 30, 40])]
study = optuna_lite.create_study(
    sampler=optuna_lite.GridSampler({"x": [0.01, 2.0, 30.0]}))
study.optimize(lambda t: -abs(t.suggest_float("x", 1e-3, 1e3) - 2), 3)
paths += [study.plot_history(os.path.join(figs, "h.png")),
          study.plot_slice(os.path.join(figs, "s.png"))]
sizes = [(400, 600), (640, 480), (640, 480), (640, 480), (896, 672),
         (700, 560)]
for p, size in zip(paths, sizes):
    img = read_images([p])[0]
    assert img.shape == (size[1], size[0], 3), (p, img.shape)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 3, p
run = os.path.join(tmp, "exp", "AL_x", "SimplePose", "S", "000001", "t")
os.makedirs(run)
perf = [{k: a for k in detailed_result.METRIC_KEYS} for a in (0.2, 0.6)]
json.dump({"percentages": [0, 100], "performances": perf,
           "performances_ann": perf, "mean_uncertaity": [2.0, 1.0],
           "spearmanr": [0.1, 0.2], "actual_finish": 100,
           "finished_minerror": 50, "finished_oursc": 100},
          open(os.path.join(run, "result.json"), "w"))
root = os.path.join(tmp, "exp")
detailed_result.main(["--exp_root", root])
wacv_result.main(["--exp_root", root])
for name in ("analysis/ANN/AP_ann.png", "analysis/ANN/AP_ann.pdf",
             "analysis/ANN/uncertainty.pdf", "analysis/spearmanr.png",
             "figures/alc_bar.png", "figures/AP .5_ann.pdf"):
    assert os.path.exists(os.path.join(root, name)), name
work = os.path.join(tmp, "work")
hm = os.path.join(work, "heatmap", "Round0")
os.makedirs(hm)
np.save(os.path.join(hm, "heatmaps.npy"),
        rng.random((2, 17, 16, 12)).astype(np.float16))
np.save(os.path.join(hm, "ann_ids.npy"), np.array([4, 8]))
frame = rng.integers(0, 255, (30, 40, 3), np.uint8)
write_png(os.path.join(tmp, "f.png"), frame)
json.dump({"images": [{"id": 1, "file_name": "f.png"}]},
          open(os.path.join(tmp, "ann.json"), "w"))
kp = np.concatenate([rng.uniform(0, 40, (17, 2)), np.ones((17, 1))], 1)
json.dump([{"image_id": 1, "keypoints": kp.ravel().tolist()}],
          open(os.path.join(work, "predicted_kpt.json"), "w"))
visualize_result.main(["--work_dir", work, "--dataset_root", tmp,
                       "--ann_file", "ann.json", "--heatmaps"])
assert sorted(os.listdir(os.path.join(work, "vis", "heatmaps"))) \
    == ["hm_4.png", "hm_8.png"]
drawn = read_images([os.path.join(work, "vis", "1.png")])[0]
assert drawn.shape == frame.shape and (drawn != frame).any()
eps = convert_to_eps.main(["--dir", figs])
assert len(eps) == 6 and all(open(p, "rb").read(4) == b"%!PS" for p in eps)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_formats_run_without_refused_packages(tmp_path):
    """The generator's jpg and bmp formats, every reader (cv2's and PIL's
    views) and convert_to_eps run on the format fixtures behind the same
    finder (no cv2 or PIL), each result equal to the SHA-256 that
    tests/data/formats/expected.json records from cv2, PIL and the JAX
    package's main."""
    script = _SCRIPT % (REFUSED,) + r"""
import hashlib, json, os, shutil, sys
import numpy as np
from vatl4pose_tpu_torch.cli import convert_to_eps
from vatl4pose_tpu_torch.data import make_synthetic_video
from vatl4pose_tpu_torch.data.image_io import (encode_jpeg, image_size,
                                               read_image_mode, read_images)


def sha(a):
    if not isinstance(a, bytes):
        a = np.ascontiguousarray(a != 0 if a.dtype == bool else a).astype(
            np.uint8 if a.dtype == bool else a.dtype).tobytes()
    return hashlib.sha256(a).hexdigest()


tmp = sys.argv[1]
fixtures = os.path.join("tests", "data", "formats")
expected = json.load(open(os.path.join(fixtures, "expected.json")))
for name, want in expected.items():
    path = os.path.join(fixtures, name)
    refusal = want.get("refused") or want.get("refused_cv2")
    try:
        got = read_images([path])[0]
        assert not refusal, name
        assert sha(got) == want["cv2"]["sha256"], name
        assert list(image_size(path)) == want["size"], name
    except ValueError as e:
        assert refusal and name in str(e) and refusal in str(e), (name, e)
    try:
        mode, px, palette = read_image_mode(path)
        assert "refused" not in want, name
        assert (mode, sha(px)) == (want["pil"]["mode"],
                                   want["pil"]["sha256"]), name
    except ValueError as e:
        assert want["refused"] in str(e), (name, e)
    d = os.path.join(tmp, name + ".d")
    os.makedirs(d)
    shutil.copy(path, d)
    try:
        (out,) = convert_to_eps.main(["--dir", d])
        assert sha(open(out, "rb").read()) == want["eps"]["sha256"], name
    except ValueError as e:
        assert str(e) in (want.get("refused", ""),
                          want["eps"].get("error", "")[len("ValueError: "):]) \
            or want.get("refused", "@") in str(e), (name, e)
kw = dict(num_frames=1, num_persons=2, width=37, height=29, seed=6)
make_synthetic_video(os.path.join(tmp, "npy"), **kw)
rgb = np.load(os.path.join(tmp, "npy", "images", "000001", "000000.npy"))
for fmt in ("jpg", "bmp"):
    make_synthetic_video(os.path.join(tmp, fmt), img_format=fmt, **kw)
    path = os.path.join(tmp, fmt, "images", "000001", "000000." + fmt)
    if fmt == "jpg":
        assert open(path, "rb").read() == encode_jpeg(rgb)
    else:
        assert (read_images([path])[0] == rgb).all()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(expected))
"""
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60
