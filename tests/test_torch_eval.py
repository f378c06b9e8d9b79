"""The port's evaluation (vatl4pose_tpu_torch/eval: COCO keypoint mAP and
OSPA) against the JAX package's on the same seeded JSON inputs: exactly
equal, including score ties, missing detections, zero-visibility GT and
frames without GT or detections."""

import numpy as np
import pytest

from vatl4pose_tpu.eval.cocoeval import evaluate_map as jax_evaluate_map
from vatl4pose_tpu.eval.ospa import get_ospa as jax_get_ospa
from vatl4pose_tpu.eval.ospa import ospa_for_loc as jax_ospa_for_loc
from vatl4pose_tpu.ops.oks import oks_matrix as jax_oks_matrix
from vatl4pose_tpu_torch.eval import (STAT_KEYS, evaluate_map, get_ospa,
                                      ospa_for_loc)
from vatl4pose_tpu_torch.ops import oks_matrix

CASES = ["noisy", "score_ties", "missing_dts", "zero_vis", "empty_frames"]


def make_case(case, seed):
    """A 6-frame video's GT dict and detection list as the AL loop writes
    them (xywh boxes, 17 interleaved keypoints)."""
    rng = np.random.default_rng(seed)
    images = [{"id": 100 + f, "file_name": f"{f:06d}.npy", "width": 320,
               "height": 240} for f in range(6)]
    gts, dts = [], []
    ann_id = 0
    for f in range(6):
        if case == "empty_frames" and f in (1, 4):
            continue                         # a frame without GT
        for _ in range(int(rng.integers(1, 4))):
            ann_id += 1
            x0, y0 = rng.uniform(0, 200, 2)
            w, h = rng.uniform(30, 110, 2)
            xy = np.stack([rng.uniform(x0, x0 + w, 17),
                           rng.uniform(y0, y0 + h, 17)], 1)
            vis = (rng.uniform(size=17) > 0.2).astype(np.float64)
            if case == "zero_vis" and ann_id % 3 == 0:
                vis[:] = 0.0                 # the box-distance fallback
            gt_kp = np.concatenate([xy, vis[:, None]], 1).reshape(-1)
            bbox = [float(x0), float(y0), float(w), float(h)]
            gts.append({"id": ann_id, "image_id": 100 + f, "category_id": 1,
                        "bbox": bbox, "keypoints": gt_kp.tolist(),
                        "iscrowd": 0})
            if case == "missing_dts" and ann_id % 2 == 0:
                continue
            noise = rng.normal(0, rng.choice([1.0, 4.0, 15.0]), xy.shape)
            dt_kp = np.concatenate([xy + noise, rng.uniform(0, 1, (17, 1))],
                                   1).reshape(-1)
            score = float(rng.uniform(0, 2))
            if case == "score_ties":
                score = float(np.round(score * 2) / 2)
            dts.append({"id": ann_id, "image_id": 100 + f, "category_id": 1,
                        "bbox": bbox, "score": score,
                        "keypoints": dt_kp.tolist()})
    if case == "empty_frames":
        # detections in a frame without GT
        kp = np.concatenate([rng.uniform(0, 200, (17, 2)),
                             np.ones((17, 1))], 1).reshape(-1)
        dts.append({"id": 999, "image_id": 101, "category_id": 1,
                    "bbox": [10.0, 10.0, 50.0, 90.0], "score": 0.7,
                    "keypoints": kp.tolist()})
    cats = [{"id": 1, "name": "person"}]
    return {"images": images, "annotations": gts, "categories": cats}, dts


@pytest.mark.parametrize("case", CASES)
def test_evaluate_map_equals_jax(case):
    gt, dts = make_case(case, seed=CASES.index(case) + 11)
    got = evaluate_map(dts, gt)
    assert list(got) == STAT_KEYS
    assert got == jax_evaluate_map(dts, gt)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("case", CASES)
def test_ospa_equals_jax(case):
    gt, dts = make_case(case, seed=CASES.index(case) + 31)
    got = ospa_for_loc(gt, dts)
    assert got == jax_ospa_for_loc(gt, dts)
    assert 0.0 <= got <= 1.0


def test_ospa_empty_set_conventions_equal_jax():
    gt, dts = make_case("noisy", seed=7)
    one, two = gt["annotations"][:1], gt["annotations"][:2]
    for g, p in (([], []), ([], dts[:2]), (two, []), (one, []),
                 (two, dts[:1]), (one, dts[:3])):
        assert get_ospa(g, p) == jax_get_ospa(g, p)


@pytest.mark.parametrize("force_visible", [False, True])
def test_oks_matrix_equals_jax(force_visible):
    gt, dts = make_case("zero_vis", seed=5)
    g = gt["annotations"]
    args = (np.array([a["keypoints"] for a in g]),
            np.array([a["bbox"] for a in g]),
            np.array([a["bbox"][2] * a["bbox"][3] for a in g]),
            np.array([d["keypoints"] for d in dts]))
    got = oks_matrix(*args, force_visible=force_visible)
    np.testing.assert_array_equal(
        got, jax_oks_matrix(*args, force_visible=force_visible))
    assert got.shape == (len(g), len(dts))
