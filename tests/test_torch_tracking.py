"""The port's tracking evaluation (eval/tracking.py, cli/pose_track_eval.py),
its per-keypoint OKS (ops/oks.oks_kpts_matrix) and its JRDB keypoint AP
(eval/jrdb_ap.py) against the JAX package's, on the same seeded inputs.

Both are float64 numpy and scipy on the host, so the bar is exact for the
integer counters and 1e-12 for every float (the two must run the same
operations in the same order).
"""

import json
import zlib

import numpy as np
import pytest

from tests.test_eval_parity import SCENES, make_scene
from vatl4pose_tpu.cli import pose_track_eval as jax_pte
from vatl4pose_tpu.eval import jrdb_ap as jax_jrdb
from vatl4pose_tpu.eval import tracking as jax_trk
from vatl4pose_tpu.ops.oks import oks_kpts_matrix as jax_oks_kpts
from vatl4pose_tpu_torch.cli import pose_track_eval
from vatl4pose_tpu_torch.eval import jrdb_ap, tracking
from vatl4pose_tpu_torch.ops.oks import JRDB_VARS, oks_kpts_matrix

TOL = 1e-12


def make_tracked_gt(rng, num_frames=5, tracks=2, occluded=False):
    """tests/test_tracking.py's tracked GT, drawn from `rng`; with
    `occluded`, each joint's visibility drawn from 0 (invisible), 1
    (occluded) and 2 (visible), as the occlusion-level OSPA2 reads it."""
    images, anns = [], []
    aid = 1
    base = rng.uniform([100, 100], [400, 300], size=(tracks, 2))
    vel = rng.uniform(-5, 5, size=(tracks, 2))
    for f in range(num_frames):
        images.append({"id": f, "width": 640, "height": 480})
        for t in range(tracks):
            xy = base[t] + vel[t] * f
            kp = np.zeros(51)
            kp[0::3] = xy[0] + rng.uniform(0, 80, 17)
            kp[1::3] = xy[1] + rng.uniform(0, 160, 17)
            kp[2::3] = rng.choice([0.0, 1.0, 2.0], 17) if occluded else 1.0
            x, y = kp[0::3].min(), kp[1::3].min()
            w = kp[0::3].max() - x
            h = kp[1::3].max() - y
            anns.append({"id": aid, "image_id": f, "track_id": t,
                         "bbox": [x, y, w, h], "area": float(w * h),
                         "keypoints": kp.tolist(), "category_id": 1})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}


def scenario(name):
    """(gt, predictions) of tests/test_tracking.py's cases, plus a noisy
    one: jittered joints, occluded and invisible GT joints, one track
    dropped for a frame and a spurious track."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "perfect":
        gt = make_tracked_gt(rng)
        return gt, list(gt["annotations"])
    if name == "id_swap":
        gt = make_tracked_gt(rng, num_frames=6, tracks=2)
        pr = []
        for a in gt["annotations"]:
            b = dict(a)
            if a["image_id"] >= 3:
                b["track_id"] = 1 - a["track_id"]
            pr.append(b)
        return gt, pr
    if name == "missing_track":
        gt = make_tracked_gt(rng, num_frames=4, tracks=2)
        return gt, [a for a in gt["annotations"] if a["track_id"] == 0]
    if name == "empty":
        return make_tracked_gt(rng, 2, 1), []
    gt = make_tracked_gt(rng, num_frames=6, tracks=3, occluded=True)
    pr = []
    for a in gt["annotations"]:
        if a["image_id"] == 2 and a["track_id"] == 1:
            continue
        b = dict(a)
        kp = np.asarray(a["keypoints"]).copy()
        kp[0::3] += rng.normal(0, 6, 17)
        kp[1::3] += rng.normal(0, 6, 17)
        b["keypoints"] = kp.tolist()
        b["track_id"] = 10 + a["track_id"]
        pr.append(b)
    for f in range(1, 4):
        b = dict(gt["annotations"][0], image_id=f, track_id=99)
        kp = np.asarray(b["keypoints"]).copy()
        kp[0::3] += 150
        b["keypoints"] = kp.tolist()
        pr.append(b)
    return gt, pr


SCENARIOS = ["perfect", "id_swap", "missing_track", "empty", "noisy"]


def assert_same(got, want):
    """Ints (and int-valued counters) equal, floats within TOL, the same
    keys."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (int, np.integer)):
            assert g == w and type(g) is type(w), k
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", SCENARIOS)
def test_tracking_metrics_match_jax(name):
    gt, pr = scenario(name)
    for f in ("hota", "clear", "identity"):
        assert_same(getattr(tracking, f)(gt, pr),
                    getattr(jax_trk, f)(gt, pr))
    for levels in (True, False):
        assert_same(tracking.ospa2(gt, pr, occlusion_levels=levels),
                    jax_trk.ospa2(gt, pr, occlusion_levels=levels))
    got = tracking.evaluate_tracking(gt, pr)
    assert_same(got, jax_trk.evaluate_tracking(gt, pr))
    # the cases' own readings (tests/test_tracking.py)
    if name == "perfect":
        assert abs(got["HOTA"] - 1) < 1e-6 and got["OSPA"] < 1e-9
        assert got["MOTA"] == got["IDF1"] == 1.0 and got["IDSW"] == 0
    if name == "id_swap":
        assert got["IDSW"] >= 2 and abs(got["MOTA"] - (1 - 2 / 12)) < 1e-6
    if name == "missing_track":
        assert abs(got["OSPA_CARD"] - 0.5) < 1e-9
    if name == "empty":
        assert got["HOTA"] == 0.0 and got["OSPA"] == 1.0
    if name == "noisy":
        assert 0 < got["HOTA"] < 1 and got["IDSW"] == 0
        assert {"OSPA_INVI", "OSPA_OCCL", "OSPA_VIS"} <= set(got)


def test_combine_sequences_matches_jax():
    per_seq = {n: tracking.evaluate_tracking(*scenario(n))
               for n in SCENARIOS}
    want_seq = {n: jax_trk.evaluate_tracking(*scenario(n))
                for n in SCENARIOS}
    assert_same(tracking.combine_sequences(per_seq),
                jax_trk.combine_sequences(want_seq))


def test_oks_kpts_matrix_matches_jax_exactly():
    rng = np.random.default_rng(5)
    gk = rng.uniform(0, 400, (4, 51))
    pk = gk[[0, 2, 1]] + rng.normal(0, 5, (3, 51))
    area = rng.uniform(1e3, 4e4, 4)
    got = oks_kpts_matrix(gk, area, pk)
    assert got.shape == (4, 3, 17) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_oks_kpts(gk, area, pk))
    np.testing.assert_array_equal(
        oks_kpts_matrix(gk, area, pk, variances=JRDB_VARS * 2),
        jax_oks_kpts(gk, area, pk, variances=JRDB_VARS * 2))


@pytest.mark.parametrize("mode", ["sequence", "dataset"])
def test_pose_track_eval_main_matches_jax(mode, tmp_path, capsys):
    """Single-sequence mode (files) and dataset mode (directories matched
    by file name, the COMBINED row): the same --out JSON, and the same
    table."""
    if mode == "sequence":
        gt, pr = scenario("noisy")
        gt_arg, pr_arg = tmp_path / "gt.json", tmp_path / "pr.json"
        json.dump(gt, open(gt_arg, "w"))
        json.dump(pr, open(pr_arg, "w"))
    else:
        gt_arg, pr_arg = tmp_path / "gt", tmp_path / "pr"
        gt_arg.mkdir()
        pr_arg.mkdir()
        for n in ("id_swap", "noisy", "perfect"):
            gt, pr = scenario(n)
            json.dump(gt, open(gt_arg / f"{n}.json", "w"))
            json.dump({"annotations": pr}, open(pr_arg / f"{n}.json", "w"))
    outs, tables = [], []
    for mod, tag in ((pose_track_eval, "port"), (jax_pte, "jax")):
        out = tmp_path / f"{tag}.json"
        mod.main(["--gt", str(gt_arg), "--pred", str(pr_arg), "--out",
                  str(out)])
        tables.append(capsys.readouterr().out)
        outs.append(json.load(open(out)))
    assert tables[0] == tables[1]
    assert ("COMBINED" in tables[0]) == (mode == "dataset")
    got, want = outs
    assert list(got["sequences"]) == list(want["sequences"])
    for name in want["sequences"]:
        assert_same(got["sequences"][name], want["sequences"][name])
    assert_same(got["combined"], want["combined"])


def jrdb_boxes(gt, dts, scene):
    """tests/test_eval_parity.py's unlabeled boxes: a box over about 70% of
    the extra detections, whose track id no pose annotation has."""
    rng = np.random.default_rng(zlib.crc32(scene.encode()))
    boxes = {"labels": {}}
    for im in gt["images"]:
        entries = []
        for d in dts:
            if d["image_id"] == im["id"] and d["id"] > 10000 and \
                    rng.random() < 0.7:
                kp = np.asarray(d["keypoints"]).reshape(17, 3)
                x0, y0 = kp[:, :2].min(0) - 5
                x1, y1 = kp[:, :2].max(0) + 5
                entries.append({
                    "label_id": f"pedestrian:{90000 + d['id']}",
                    "box": [float(x0), float(y0), float(x1 - x0),
                            float(y1 - y0)]})
        if entries:
            boxes["labels"]["{:06d}.jpg".format(im["id"] - 1)] = entries
    return boxes


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("scene", ["near_perfect", "noisy", "missing_dts",
                                   "extra_dts", "score_ties"])
def test_jrdb_ap_matches_jax(scene, boxed):
    """The five scenes of tests/test_eval_parity.py, with and without the
    box file (the forgiveness of unmatched predictions): AP and recall of
    each joint and their means within 1e-12."""
    gt, dts = make_scene(
        seed=zlib.crc32(repr(scene).encode()) % 2 ** 31 + 13,
        track_ids=True, **SCENES[scene])
    boxes = jrdb_boxes(gt, dts, scene) if boxed else None
    got = jrdb_ap.average_precision_for_loc(gt, {"annotations": dts},
                                            unlabeled_boxes=boxes)
    want = jax_jrdb.average_precision_for_loc(gt, {"annotations": dts},
                                              unlabeled_boxes=boxes)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 18
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    if boxed and scene == "extra_dts":
        assert boxes["labels"]     # forgiveness was exercised
        assert got != jrdb_ap.average_precision_for_loc(
            gt, {"annotations": dts})


def test_jrdb_ap_gt_as_predictions():
    """tests/test_eval_extra.py's reading: the GT fed back as predictions
    gives AP 100 and recall 100."""
    gt, _ = make_scene(seed=3, track_ids=True, **SCENES["near_perfect"])
    ap, rec = jrdb_ap.average_precision_for_loc(gt, list(gt["annotations"]))
    assert abs(ap[-1] - 100.0) < 1e-6 and abs(rec[-1] - 100.0) < 1e-6
