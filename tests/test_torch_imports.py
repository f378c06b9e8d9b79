"""Every module of vatl4pose_tpu_torch imports without JAX, Flax, the JAX
package, sklearn, PyYAML, matplotlib or cv2: the machine with the card has
none of them."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "flax", "vatl4pose_tpu", "sklearn", "yaml",
           "matplotlib", "cv2")

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
    assert int(out.stdout.split()[-1]) >= 40


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
