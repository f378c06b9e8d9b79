"""The port's data preparation and the data and logging modules the
pre-training CLIs use (vatl4pose_tpu_torch/cli/prepare_data.py,
data/wholebody.py, data/extra_datasets.py, utils/logger.py,
utils/metrics.DataLogger) against the JAX package's, on the same synthetic
files."""

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_prepare_data import _make_jrdb_raw, _make_posetrack_raw
from vatl4pose_tpu.cli import prepare_data as jprep
from vatl4pose_tpu.data import build_dataset as jax_build_dataset
from vatl4pose_tpu.data.wholebody import Wholebody as JaxWholebody
from vatl4pose_tpu.utils import logger as jlogger
from vatl4pose_tpu.utils.metrics import DataLogger as JaxDataLogger
from vatl4pose_tpu_torch.cli import prepare_data
from vatl4pose_tpu_torch.data import (ConcatDataset, Mpii, Mscoco,
                                      Mscoco_det, Wholebody, build_dataset,
                                      make_synthetic_video)
from vatl4pose_tpu_torch.utils import logger
from vatl4pose_tpu_torch.utils.metrics import DataLogger

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root, ann = make_synthetic_video(str(tmp_path_factory.mktemp("v")),
                                     num_frames=5, num_persons=3,
                                     width=160, height=128, seed=3)
    return root, ann


@pytest.mark.parametrize("dataset_type,kp_direct", [
    ("Posetrack21", False), ("JRDB2022", False), ("Posetrack21", True)])
def test_wholebody_matches_jax(video, tmp_path, dataset_type, kp_direct):
    """Features and composite ids equal to the JAX package's (atol 1e-6),
    with the zero-visibility bodies filtered out; the .npy cache gives the
    same arrays back."""
    root, ann = video
    path = os.path.join(root, ann)
    with open(path) as f:
        data = json.load(f)
    # one body without a visible joint: filtered out by both
    data["annotations"][1]["keypoints"][2::3] = [0.0] * 17
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(data, f)
    ref = JaxWholebody(path, dataset_type, kp_direct=kp_direct)
    got = Wholebody(path, dataset_type, kp_direct=kp_direct,
                    cache_dir=str(tmp_path / "cache"))
    assert len(got) == len(ref) == len(data["annotations"]) - 1
    np.testing.assert_array_equal(got.ann_ids, ref.ann_ids)
    np.testing.assert_allclose(got.features, ref.features, rtol=0,
                               atol=1e-6)
    assert got.features.dtype == np.float32
    assert got.features.shape[1] == (51 if kp_direct else 38)
    assert (np.diff(got.ann_ids) > 0).all()
    cached = Wholebody(path, dataset_type, kp_direct=kp_direct,
                       cache_dir=str(tmp_path / "cache"))
    assert os.path.exists(tmp_path / "cache" / "ann.json.npy")
    np.testing.assert_array_equal(cached.features, got.features)
    np.testing.assert_array_equal(cached.ann_ids, got.ann_ids)
    np.testing.assert_array_equal(got[0], got.features[0])


def _same_data(got, ref):
    """Every VideoPoseData field equal."""
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("cls", ["Mscoco", "Mpii"])
def test_single_image_datasets_match_jax(video, cls):
    """Mscoco and Mpii: every field equal, every item its own track."""
    root, ann = video
    cfg = {"TYPE": cls, "ROOT": root, "ANN": ann}
    got, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert type(got) is {"Mscoco": Mscoco, "Mpii": Mpii}[cls]
    _same_data(got.data, ref.data)
    assert not got.data.is_prev.any() and not got.data.is_next.any()
    assert (got.num_joints, got.joint_pairs, got.EVAL_JOINTS) == \
        (ref.num_joints, ref.joint_pairs, ref.EVAL_JOINTS)


def test_detection_dataset_matches_jax(video):
    """Mscoco_det: a detector's boxes (one as a file-name image id) paired
    with the annotation's images; every array equal."""
    root, ann = video
    with open(os.path.join(root, ann)) as f:
        images = json.load(f)["images"]
    rng = np.random.default_rng(5)
    dets = [{"image_id": im["id"], "score": float(rng.uniform()),
             "bbox": rng.uniform(0, 100, 4).round(2).tolist()}
            for im in images for _ in range(2)]
    dets[3]["image_id"] = f"{images[1]['id']}.jpg"
    dets[5].pop("score")
    with open(os.path.join(root, "dets.json"), "w") as f:
        json.dump(dets, f)
    cfg = {"TYPE": "Mscoco_det", "ROOT": root, "ANN": ann,
           "DET_FILE": "dets.json"}
    got, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert isinstance(got, Mscoco_det) and len(got) == len(ref) == 10
    for name in ("frame_paths", "frame_sizes", "frame_idx", "bboxes",
                 "raw_bbox_xywh", "det_scores", "img_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(got.load_frames(), ref.load_frames())


def test_concat_dataset_matches_jax(video, tmp_path):
    """ConcatDataset over two sets lifted into a 20-joint space at MASK_ID
    0 and 3: every field equal; the joints outside a subset's slice have
    zero visibility."""
    root, ann = video
    root2, ann2 = make_synthetic_video(str(tmp_path), num_frames=3,
                                       num_persons=2, width=200, height=150,
                                       seed=9)
    cfg = {"TYPE": "ConcatDataset", "NUM_JOINTS": 20, "SET_LIST": [
        {"TYPE": "Posetrack21", "ROOT": root, "ANN": ann, "MASK_ID": 0},
        {"TYPE": "Mscoco", "ROOT": root2, "ANN": ann2, "MASK_ID": 3}]}
    got, ref = build_dataset(cfg), jax_build_dataset(cfg)
    assert isinstance(got, ConcatDataset)
    _same_data(got.data, ref.data)
    n0 = len(got.subsets[0])
    assert got.data.joints_vis.shape == (len(got), 20)
    assert not got.data.joints_vis[:n0, 17:].any()
    assert not got.data.joints_vis[n0:, :3].any()
    assert got.data.mixed_sizes and got.EVAL_JOINTS == list(range(20))
    store = got.frame_store()
    assert len(store) == len(got.data.frame_paths)


def test_data_logger_matches_jax():
    """DataLogger's running, sample-weighted average."""
    got, ref = DataLogger(), JaxDataLogger()
    for value, n in ((0.5, 4), (0.25, 2), (1.0, 1)):
        got.update(value, n)
        ref.update(value, n)
        assert (got.value, got.sum, got.cnt, got.avg) == \
            (ref.value, ref.sum, ref.cnt, ref.avg)
    got.clear()
    assert (got.sum, got.cnt, got.avg) == (0, 0, 0)


def test_logger_and_scalar_writer_match_jax(tmp_path, caplog):
    """make_logger writes the same epochInfo line to work_dir/train.log as
    the JAX package's (after the timestamp); ScalarWriter the same JSON
    lines (but the wall clock)."""
    lines = []
    for mod, name in ((jlogger, "jax"), (logger, "port")):
        lg = mod.make_logger(f"pretrain_{name}", str(tmp_path / name))
        lg.epochInfo(3, 0.0123456789, 0.5)
        for h in lg.handlers:
            h.flush()
        with open(tmp_path / name / "train.log") as f:
            lines.append(f.read().split(" ", 2)[2])
        w = mod.ScalarWriter(str(tmp_path / name))
        w.write("loss", np.float32(0.25), 7)
        w.write("acc", 1, 8)
        w.close()
    assert lines[0] == lines[1] == \
        "Epoch 3 | loss:0.01234568 | acc:0.5000\n"
    rows = [[{k: v for k, v in json.loads(r).items() if k != "wall"}
             for r in open(tmp_path / name / "scalars.jsonl")]
            for name in ("jax", "port")]
    assert rows[0] == rows[1] == [
        {"step": 7, "tag": "loss", "value": 0.25},
        {"step": 8, "tag": "acc", "value": 1.0}]
    assert isinstance(logger.make_logger("x"), logging.Logger)


@pytest.fixture(scope="module")
def posetrack_trees(tmp_path_factory):
    """Two identical raw PoseTrack21 trees (two videos, val and train):
    one for the JAX package's prepare_data, one for the port's."""
    base = tmp_path_factory.mktemp("prep")
    ref_root = base / "jax" / "data" / "PoseTrack21"
    for split in ("val", "train"):
        _make_posetrack_raw(ref_root, split, ["000001", "000002"],
                            nframes=20)
    ours_root = base / "port" / "data" / "PoseTrack21"
    shutil.copytree(ref_root, ours_root)
    return ref_root, ours_root


def _outputs(root, sub):
    d = root / "activelearning" / sub
    return {f: json.load(open(d / f)) for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("argv,sub", [
    (["posetrack-val"], "val"),
    (["posetrack-train", "--mode", "train"], "train"),
    (["integrate", "--mode", "val"], "val")])
def test_prepare_posetrack_matches_jax(posetrack_trees, argv, sub):
    """posetrack-val, posetrack-train and integrate (run in that order:
    integrate merges posetrack-val's files): the same JSON files."""
    ref_root, ours_root = posetrack_trees
    jprep.main(argv[:1] + ["--root", str(ref_root)] + argv[1:])
    prepare_data.main(argv[:1] + ["--root", str(ours_root)] + argv[1:])
    want, got = _outputs(ref_root, sub), _outputs(ours_root, sub)
    assert got == want and got
    if argv[0] == "integrate":
        merged = got["000000_integrated_val.json"]
        assert merged["annotations"] and all(
            a["iscrowd"] == 0 and "area" in a for a in merged["annotations"])
    else:
        assert all("width" in im for f in got.values()
                   for im in f["images"])


def test_prepare_jrdb_matches_jax(tmp_path):
    """jrdb: per-scene COCO jsons with composite 8-digit image ids, equal
    to the JAX package's."""
    scenes = ["scene-alpha", "scene-beta"]
    roots = []
    for name in ("jax", "port"):
        data_root = _make_jrdb_raw(tmp_path / name, scenes, nframes=4)
        roots.append(data_root)
    for mod, data_root in zip((jprep, prepare_data), roots):
        mod.main(["jrdb", "--root", str(data_root), "--split", "train",
                  "--scene_list", str(data_root.parent.parent / "configs"
                                      / "jrdb-pose" / "jrdb_train.txt")])
    want, got = (_outputs(r, "train") for r in roots)
    assert got == want
    assert sorted(got) == ["00_jrdb-pose.json", "01_jrdb-pose.json"]
    assert all(10000000 <= im["id"] < 20000000
               for f in got.values() for im in f["images"])
