"""The port's copies of the data layer (vatl4pose_tpu_torch/data) against
the JAX package's: the synthetic fixture writes identical files for a
seed, and the dataset builds identical arrays and neighbour flags."""

import json
import os

import numpy as np
import pytest

from vatl4pose_tpu.config import Cfg
from vatl4pose_tpu.data import bucket_size, pad_to
from vatl4pose_tpu.data.dataset import build_dataset
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu_torch import data as tdata

ARRAYS = ("frame_idx", "img_ids", "ann_ids", "bboxes", "raw_bbox_xywh",
          "gt_keypoints", "joints_xy", "joints_vis", "is_prev", "is_next",
          "frame_sizes")


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    kw = dict(num_frames=4, num_persons=3, width=160, height=128, seed=7)
    ref = make_synthetic_video(str(tmp_path_factory.mktemp("jax")), **kw)
    port = tdata.make_synthetic_video(str(tmp_path_factory.mktemp("pt")),
                                      **kw)
    return ref, port


def test_synthetic_files_identical(videos):
    (r_root, r_ann), (p_root, p_ann) = videos
    assert r_ann == p_ann
    with open(os.path.join(r_root, r_ann)) as f:
        r_json = json.load(f)
    with open(os.path.join(p_root, p_ann)) as f:
        p_json = json.load(f)
    assert r_json == p_json
    for img in r_json["images"]:
        a = np.load(os.path.join(r_root, img["file_name"]))
        b = np.load(os.path.join(p_root, img["file_name"]))
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,digits", [("Posetrack21", 2),
                                         ("JRDB2022", 3)])
def test_dataset_arrays_and_flags_identical(tmp_path, kind, digits):
    # 12 persons: two-digit track ids exercise the composite-id sort
    root, ann = make_synthetic_video(str(tmp_path), num_frames=3,
                                     num_persons=12, width=96, height=80,
                                     track_digits=digits, vis_prob=0.5)
    cfg = {"TYPE": kind, "ROOT": root, "ANN": ann}
    ref = build_dataset(Cfg(cfg))
    port = tdata.build_dataset(cfg)
    for name in ARRAYS:
        a, b = getattr(ref.data, name), getattr(port.data, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ref.data.track_keys == port.data.track_keys
    assert ref.data.paths == port.data.paths
    assert port.data.is_prev.any() and port.data.is_next.any()
    np.testing.assert_array_equal(ref.load_frames(), port.load_frames())


def test_pad_and_bucket_match():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for n in (2, 3, 5):
        np.testing.assert_array_equal(pad_to(a, n), tdata.pad_to(a, n))
        np.testing.assert_array_equal(pad_to(a, n, axis=1),
                                      tdata.pad_to(a, n, axis=1))
    for n in (1, 32, 33, 500, 4096, 4097, 9000):
        assert bucket_size(n) == tdata.bucket_size(n)
