"""The port's analysis CLIs (cli/summarize_result.py, detailed_result.py,
wacv_result.py, convert_to_eps.py) against the JAX package's, on the
hand-built result tree of tests/test_analysis.py.

The port's compute_alc is a numpy trapezoid where the JAX package calls
sklearn's `metrics.auc`, so every ALC (and the means and deviations made
from them) is held within 1e-12; every other number, name and file is
held equal.  matplotlib and PIL are present here, so each `main` draws
its figures: the two packages must write the same set of files.
"""

import json
import os

import numpy as np
import pytest

from tests.test_analysis import _write_result
from vatl4pose_tpu.cli import convert_to_eps as jax_eps
from vatl4pose_tpu.cli import detailed_result as jax_detailed
from vatl4pose_tpu.cli import summarize_result as jax_summarize
from vatl4pose_tpu.cli import wacv_result as jax_wacv
from vatl4pose_tpu_torch.cli import (convert_to_eps, detailed_result,
                                     summarize_result, wacv_result)

ALC_TOL = 1e-12


@pytest.fixture(scope="module")
def exp_tree(tmp_path_factory):
    """tests/test_analysis.py's tree: two strategies, two videos with
    different round counts; a third strategy whose video has AP -1 in a
    round (collect skips such a curve)."""
    root = str(tmp_path_factory.mktemp("exp"))
    base = os.path.join(root, "AL_test", "SimplePose")
    _write_result(os.path.join(base, "THC_L1", "000001", "t1",
                               "result.json"),
                  [0, 50, 100], [0.2, 0.5, 0.8], [0.2, 0.6, 1.0], 2,
                  spearman=[-0.5, -0.4, -0.3])
    _write_result(os.path.join(base, "THC_L1", "000002", "t1",
                               "result.json"),
                  [0, 25, 50, 100], [0.1, 0.3, 0.5, 0.9],
                  [0.1, 0.4, 0.7, 1.0], 3, spearman=[-0.6, -0.5, -0.2, -0.1])
    _write_result(os.path.join(base, "Random", "000001", "t1",
                               "result.json"),
                  [0, 50, 100], [0.2, 0.3, 0.6], [0.2, 0.4, 0.9], 2)
    _write_result(os.path.join(base, "HP", "000003", "t1", "result.json"),
                  [0, 10, 100], [-1, 0.35, 0.7], [-1, 0.5, 1.0], 2)
    return root


def assert_same(got, want, path=""):
    """Nested dicts and lists equal, floats under an ALC key within
    ALC_TOL."""
    assert type(got) is type(want) or (
        isinstance(got, (int, float)) and isinstance(want, (int, float))), \
        path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and "ALC" in path:
        assert abs(got - want) <= ALC_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_summaries_match_jax(exp_tree):
    """find_results, summarize (raw and annotated), sc_summary and the
    LaTeX table."""
    assert summarize_result.find_results(exp_tree) \
        == jax_summarize.find_results(exp_tree)
    for ann in (True, False):
        for metric in ("AP", "AP .75"):
            assert_same(summarize_result.summarize(exp_tree, metric, ann),
                        jax_summarize.summarize(exp_tree, metric, ann))
    assert summarize_result.sc_summary(exp_tree) \
        == jax_summarize.sc_summary(exp_tree)
    table = jax_summarize.summarize(exp_tree)
    tex = wacv_result.latex_table(summarize_result.summarize(exp_tree))
    assert tex == jax_wacv.latex_table(table)
    assert wacv_result.latex_table(table) == jax_wacv.latex_table(table)
    assert tex.count(r" \\") == len(table) + 1      # header + a row each
    grid, curve = summarize_result.interp_curve([0, 50, 100], [1, 2, 4])
    np.testing.assert_array_equal(
        curve, jax_summarize.interp_curve([0, 50, 100], [1, 2, 4])[1])


@pytest.mark.parametrize("video_ids", [None, ["000001", "000002",
                                              "000099"]])
def test_collect_and_its_tables_match_jax(exp_tree, video_ids):
    """collect (1001-point curves, ALC, SC, empty-video accounting),
    metric_json and summarize_sc."""
    metrics = detailed_result.METRIC_KEYS
    got, got_empty = detailed_result.collect(exp_tree, metrics, video_ids,
                                             "AP .75")
    want, want_empty = jax_detailed.collect(exp_tree, metrics, video_ids,
                                            "AP .75")
    assert_same(got, want)
    assert got_empty == want_empty
    if video_ids:
        assert "000099" in got_empty["union"]
    for m in metrics:
        for ann in (True, False):
            assert_same(detailed_result.metric_json(got, m, ann),
                        jax_detailed.metric_json(want, m, ann))
    assert detailed_result.summarize_sc(got) == jax_detailed.summarize_sc(
        want)
    # a curve's last point is its run's last AP
    assert got["THC_L1"]["AP"]["000002"][-1] == pytest.approx(90.0)
    assert "000003" not in got["HP"]["AP"]             # an AP of -1


def files_under(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_mains_write_the_same_artifacts(exp_tree, tmp_path):
    """summarize_result, detailed_result (--raw, --sc_thresh) and
    wacv_result through main: the same file names, equal JSONs and the
    same LaTeX table."""
    outs = {}
    for tag, mods in (("port", (summarize_result, detailed_result,
                                wacv_result)),
                      ("jax", (jax_summarize, jax_detailed, jax_wacv))):
        base = tmp_path / tag
        base.mkdir()
        summ, det, wacv = mods
        summ.main(["--exp_root", exp_tree, "--out", str(base / "s.json")])
        det.main(["--exp_root", exp_tree, "--out_dir",
                  str(base / "analysis"), "--metrics", "AP", "AP .75",
                  "--sc_thresh", "AP .75", "--raw"])
        wacv.main(["--exp_root", exp_tree, "--out_dir", str(base / "figs")])
        outs[tag] = base
    names = files_under(outs["port"])
    assert names == files_under(outs["jax"])
    assert {"analysis/sc_summary.json", "analysis/result_ann.json",
            "analysis/empty_dict.json", "analysis/ANN/AP_ann.png",
            "analysis/RAW/uncertainty.png", "figs/alc_bar.png",
            "figs/strategy_table.tex", "s.json"} <= set(names)
    for name in names:
        if name.endswith(".json"):
            assert_same(json.load(open(outs["port"] / name)),
                        json.load(open(outs["jax"] / name)), name)
        if name.endswith(".tex"):
            assert (outs["port"] / name).read_text() \
                == (outs["jax"] / name).read_text()


def test_convert_to_eps_matches_jax(tmp_path):
    """The same raster files converted (RGBA, LA and palette images to
    RGB, gray kept as L), the rest skipped, and each EPS byte for byte the
    JAX package's (PIL's writer): RGB, RGBA, LA, gray and 1-, 2-, 4- and
    8-bit palette PNGs, RGB and gray JPEGs."""
    from PIL import Image
    import cv2
    rng = np.random.default_rng(0)
    images = {
        "a.png": Image.fromarray(rng.integers(0, 255, (8, 8, 4), np.uint8)),
        "c.png": Image.fromarray(rng.integers(0, 255, (9, 13, 3),
                                              np.uint8)),
        "d.png": Image.fromarray(rng.integers(0, 255, (9, 13, 2), np.uint8),
                                 "LA"),
        "e.png": Image.fromarray(rng.integers(0, 255, (40, 27), np.uint8)),
    }
    for bits in (1, 2, 4, 8):
        n = 1 << bits
        im = Image.fromarray(rng.integers(0, n, (9, 13), np.uint8), "P")
        im.putpalette(rng.integers(0, 255, 3 * n, np.uint8).tolist())
        images[f"p{bits}.png"] = (im, bits)
    rgb = rng.integers(0, 255, (8, 8, 3), np.uint8)
    gray = rng.integers(0, 255, (17, 23), np.uint8)
    for tag in ("port", "jax"):
        d = tmp_path / tag
        d.mkdir()
        for name, im in images.items():
            if isinstance(im, tuple):
                im[0].save(d / name, bits=im[1])
            else:
                im.save(d / name)
        cv2.imwrite(str(d / "b.jpg"), rgb[..., ::-1])
        cv2.imwrite(str(d / "g.jpg"), gray)
        (d / "notes.txt").write_text("not an image")
    got = convert_to_eps.main(["--dir", str(tmp_path / "port")])
    want = jax_eps.main(["--dir", str(tmp_path / "jax")])
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want] == [
        "a.eps", "b.eps", "c.eps", "d.eps", "e.eps", "g.eps", "p1.eps",
        "p2.eps", "p4.eps", "p8.eps"]
    assert files_under(tmp_path / "port") == files_under(tmp_path / "jax")
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes(), name
    for name in ("e.eps", "g.eps"):                # gray stays gray
        assert b'1 0 1 1 "image"' in (tmp_path / "port" / name).read_bytes()


def test_convert_to_eps_refuses_bmp_and_tiff(tmp_path):
    """BMP and TIFF figures convert as the JAX package's main converts them
    (the port reads both since it has its own readers), CMYK TIFF
    included; a mode PIL's EPS writer refuses ("1") raises the same
    ValueError in both, before either writes a file."""
    from PIL import Image
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 255, (9, 14, 3), np.uint8)
    for tag in ("port", "jax"):
        d = tmp_path / tag
        d.mkdir()
        Image.fromarray(rgb).save(d / "x.bmp")
        Image.fromarray(rgb).convert("P").save(d / "y.bmp")
        Image.fromarray(rgb).save(d / "z.tif", compression="tiff_lzw")
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], 2),
                        "CMYK").save(d / "k.tiff")
    got = convert_to_eps.main(["--dir", str(tmp_path / "port")])
    want = jax_eps.main(["--dir", str(tmp_path / "jax")])
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want] == [
        "k.eps", "x.eps", "y.eps", "z.eps"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes(), name
    assert b'8 4 0 1 1 "false 4 colorimage"' \
        in (tmp_path / "port" / "k.eps").read_bytes()
    for tag, main in (("port1", convert_to_eps.main), ("jax1", jax_eps.main)):
        d = tmp_path / tag
        d.mkdir()
        Image.fromarray(rgb[..., 0] > 100).save(d / "b.bmp")   # mode "1"
        with pytest.raises(ValueError, match="image mode is not supported"):
            main(["--dir", str(d)])
        assert os.listdir(d) == ["b.bmp"]
