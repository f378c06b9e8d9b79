"""The port's figure layer (utils/raster.py, utils/figure.py) and every
figure function drawn through it, against the JAX package's, which draws
with matplotlib and cv2 here.

* cv2 drawing is held bit for bit: the raster primitives against cv2.line
  and cv2.circle directly, vis_frame_fast against the JAX package's under
  hypothesis (keypoints off the image, on its border, a = b, every
  threshold), render_round's PNGs against the JAX function's.
* matplotlib figures are held to the same content, not the same pixels:
  matplotlib's Axes, Figure and pyplot calls are recorded while the JAX
  function runs (the outermost call only, as the port's Axes records
  them) and must equal the port's call lists (arrays exactly, order
  kept); the same file names and formats; each PNG figsize x dpi (the
  tight box of render_heatmaps: every panel and the title inside); each
  axes' view limits after drawing within 1e-9 of get_xlim/get_ylim; the
  tick values equal to get_xticks/get_yticks where the axis is shown;
  where the layout is the default subplot box, a marker at a data point
  within 1 px of transData and drawn in its colour there; the colour
  tables equal to cmap(np.arange(256), bytes=True); an imshow panel's
  pixel centres LUT[norm(value)]; no text box clipped by the canvas.
* The PDF: xref offsets, MediaBox, the image's /Width and /Height, and
  its inflated stream equal to the PNG's pixels.
* The glyph table regenerated by scripts/make_figure_glyphs.py equals the
  committed one.
"""

import contextlib
import json
import math
import os
import re
import zlib

import cv2
import matplotlib
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

matplotlib.use("Agg")
import matplotlib.axes  # noqa: E402
import matplotlib.figure  # noqa: E402
import matplotlib.pyplot as mplt  # noqa: E402

from tests.test_analysis import _write_result  # noqa: E402
from vatl4pose_tpu.al import optuna_lite as jax_optuna  # noqa: E402
from vatl4pose_tpu.al.al_metric import plot_learning_curves as jax_plc  # noqa: E402,E501
from vatl4pose_tpu.cli import detailed_result as jax_detailed  # noqa: E402
from vatl4pose_tpu.cli import visualize_result as jax_visres  # noqa: E402
from vatl4pose_tpu.cli import wacv_result as jax_wacv  # noqa: E402
from vatl4pose_tpu.utils import vis as jax_vis  # noqa: E402
from vatl4pose_tpu_torch.al import optuna_lite  # noqa: E402
from vatl4pose_tpu_torch.al.al_metric import plot_learning_curves  # noqa: E402,E501
from vatl4pose_tpu_torch.cli import (detailed_result, visualize_result,  # noqa: E402,E501
                                     wacv_result)
from vatl4pose_tpu_torch.data.image_io import read_images, write_png  # noqa: E402,E501
from vatl4pose_tpu_torch.utils import figure, raster, vis  # noqa: E402

torch.set_num_threads(1)
LIM_RTOL = 1e-9
AX_METHODS = ("plot", "scatter", "bar", "imshow", "axhline", "set_xlabel",
              "set_ylabel", "set_title", "set_xlim", "set_ylim",
              "set_xscale", "set_xticks", "set_xticklabels", "grid",
              "legend", "axis")
FIG_METHODS = ("suptitle", "colorbar", "tight_layout", "savefig")


# ---- recording both packages' figures ------------------------------------------

class Recorder:
    """matplotlib's figures made while it is active: each with its pyplot
    call, its calls (Figure's), its subplot axes and theirs."""

    def __init__(self):
        self.figs = []           # [(fig, axes list, calls, {id(ax): calls})]
        self.depth = 0

    def _find(self, obj):
        for f in self.figs:
            if obj is f[0]:
                return f[2]
            for ax in f[1]:
                if obj is ax:
                    return f[3][id(ax)]
        return None

    def wrap(self, cls, name):
        orig = getattr(cls, name)
        rec = self

        def wrapper(obj, *args, **kwargs):
            calls = rec._find(obj) if rec.depth == 0 else None
            if calls is not None:
                calls.append((name, args, kwargs))
            rec.depth += 1
            try:
                return orig(obj, *args, **kwargs)
            finally:
                rec.depth -= 1
        return wrapper

    @contextlib.contextmanager
    def active(self, mp):
        orig = mplt.subplots
        rec = self

        def subplots(*args, **kwargs):
            rec.depth += 1
            try:
                fig, axes = orig(*args, **kwargs)
            finally:
                rec.depth -= 1
            axs = list(np.asarray(axes, object).ravel())
            rec.figs.append((fig, axs, [("subplots", args, kwargs)],
                             {id(a): [] for a in axs}))
            return fig, axes
        mp.setattr(mplt, "subplots", subplots)
        for name in AX_METHODS:
            mp.setattr(matplotlib.axes.Axes, name,
                       self.wrap(matplotlib.axes.Axes, name))
        for name in FIG_METHODS:
            mp.setattr(matplotlib.figure.Figure, name,
                       self.wrap(matplotlib.figure.Figure, name))
        yield self


class PortRecorder:
    """The port's figures made while it is active."""

    def __init__(self):
        self.figs = []

    @contextlib.contextmanager
    def active(self, mp):
        orig = figure.subplots
        rec = self

        def subplots(*args, **kwargs):
            fig, axes = orig(*args, **kwargs)
            rec.figs.append(fig)
            return fig, axes
        mp.setattr(figure, "subplots", subplots)
        yield self


def norm(v, axes, root=None):
    """A call argument comparable across the packages: an Axes as its
    index, a mappable as "mappable", arrays and sequences as lists, a
    path under root relative to it."""
    if root and isinstance(v, str) and v.startswith(root + os.sep):
        return ("path", os.path.relpath(v, root))
    for i, a in enumerate(axes):
        if v is a:
            return ("axes", i)
    if isinstance(v, (matplotlib.axes.Axes, figure.Axes)):
        return ("axes", None)
    if isinstance(v, (matplotlib.cm.ScalarMappable, figure._Artist)):
        return "mappable"
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.kind, v.shape, v.tolist())
    if isinstance(v, (list, tuple, range)):
        return ("seq", [norm(x, axes, root) for x in v])
    if isinstance(v, dict):
        return {k: norm(x, axes, root) for k, x in v.items()}
    if isinstance(v, np.generic):
        return v.item()
    return v


def norm_calls(calls, axes, root=None):
    return [(n, norm(a, axes, root), norm(k, axes, root))
            for n, a, k in calls]


def run_both(mp_jax, jax_fn, port_fn):
    """Run the JAX function under the matplotlib recorder and the port's
    under its own; return both recordings."""
    jrec, prec = Recorder(), PortRecorder()
    with pytest.MonkeyPatch.context() as mp:
        with jrec.active(mp):
            jout = jax_fn()
    with pytest.MonkeyPatch.context() as mp:
        with prec.active(mp):
            pout = port_fn()
    return jrec, prec, jout, pout


def saved(calls):
    """(path, dpi, tight) of each savefig call."""
    out = []
    for name, args, kwargs in calls:
        if name == "savefig":
            out.append((str(args[0]), kwargs.get("dpi"),
                        kwargs.get("bbox_inches") == "tight"))
    return out


def png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24],
                                                             "big")


def compare_figures(jrec, prec, jdir, pdir, transform=True):
    """The checks every figure function shares."""
    assert len(jrec.figs) == len(prec.figs) > 0
    for (jfig, jaxes, jcalls, jaxcalls), pfig in zip(jrec.figs, prec.figs):
        assert len(jaxes) == len(pfig.axes)
        # the call lists: pyplot's and the figure's, then each axes'
        assert norm_calls(jcalls, jaxes, jdir) == norm_calls(
            pfig.calls, pfig.axes, pdir)
        for jax_ax, pax in zip(jaxes, pfig.axes):
            assert norm_calls(jaxcalls[id(jax_ax)], jaxes) \
                == norm_calls(pax.calls, pfig.axes)
        tight_layout = any(c[0] == "tight_layout" for c in pfig.calls)
        for (jpath, jdpi, jtight), (ppath, pdpi, ptight) in zip(
                saved(jcalls), saved(pfig.calls)):
            assert os.path.relpath(jpath, jdir) == os.path.relpath(ppath,
                                                                    pdir)
            assert (jdpi, jtight) == (pdpi, ptight)
            ext = os.path.splitext(ppath)[1]
            dpi = pdpi or 100
            with open(ppath, "rb") as f:
                magic = f.read(8)
            if ext == ".pdf":
                assert magic.startswith(b"%PDF")
                check_pdf(ppath, pfig, dpi, ptight)
                continue
            w, h = png_size(ppath)
            if not ptight:
                assert (w, h) == (round(pfig.figsize[0] * dpi),
                                  round(pfig.figsize[1] * dpi))
                assert (w, h) == png_size(jpath)
            img = read_images([ppath])[0]
            for x0, y0, x1, y1 in pfig.text_boxes:     # none clipped
                assert x0 >= 0 and y0 >= 0 and x1 <= w and y1 <= h, \
                    (ppath, (x0, y0, x1, y1), (w, h))
            if transform and not tight_layout and not ptight:
                check_transform(jfig, jaxes, pfig, img, dpi)
        # limits and ticks after drawing
        for jax_ax, pax in zip(jaxes, pfig.axes):
            for got, want in ((pax.get_xlim(), jax_ax.get_xlim()),
                              (pax.get_ylim(), jax_ax.get_ylim())):
                np.testing.assert_allclose(got, want, rtol=LIM_RTOL,
                                           atol=1e-300)
            if pax._axis_on:
                np.testing.assert_allclose(pax.get_xticks(),
                                           jax_ax.get_xticks(), rtol=1e-9,
                                           atol=1e-12)
                np.testing.assert_allclose(pax.get_yticks(),
                                           jax_ax.get_yticks(), rtol=1e-9,
                                           atol=1e-12)


def check_transform(jfig, jaxes, pfig, img, dpi):
    """Each line's and scatter's data points land within 1 px of
    matplotlib's transData, and the last drawn one shows its colour
    within 1 px of there."""
    H = img.shape[0]
    for jax_ax, pax in zip(jaxes, pfig.axes):
        pts = [(a, np.stack([a.x, a.y], 1)) for a in pax.artists
               if a.kind in ("line", "scatter") and len(a.x)]
        for a, p in pts:
            want = jax_ax.transData.transform(p) * dpi / jfig.dpi
            got = pax.transform(p, dpi)
            assert np.abs(got - want).max() <= 1.0, (got, want)
        if pts and pts[-1][0].kind == "scatter" or (
                pts and pts[-1][0].marker):
            a, p = pts[-1]
            x, y = pax.transform(p[-1:], dpi)[0]
            col = a.colors[-1] if a.kind == "scatter" else a.color
            r, c = int(H - y), int(x)
            win = img[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2].reshape(-1, 3)
            dist = np.abs(win.astype(int) - np.array(col)).sum(1)
            alpha = getattr(a, "alpha", 1.0)
            assert dist.min() <= (1 - alpha) * 3 * 255 + 3, (col, win)


def check_pdf(path, pfig, dpi, tight):
    data = open(path, "rb").read()
    start = int(re.search(rb"startxref\s+(\d+)", data).group(1))
    assert data[start:start + 4] == b"xref"
    n = int(re.search(rb"xref\s+0 (\d+)", data[start:]).group(1))
    offsets = [int(v) for v in re.findall(rb"(\d{10}) 00000 n",
                                          data[start:])]
    assert len(offsets) == n - 1
    for i, off in enumerate(offsets, 1):
        assert data[off:].startswith(b"%d 0 obj" % i)
    box = [float(v) for v in re.search(
        rb"/MediaBox \[([\d. ]+)\]", data).group(1).split()]
    w = int(re.search(rb"/Width (\d+)", data).group(1))
    h = int(re.search(rb"/Height (\d+)", data).group(1))
    if not tight:
        assert (w, h) == (round(pfig.figsize[0] * dpi),
                          round(pfig.figsize[1] * dpi))
        np.testing.assert_allclose(box, [0, 0, pfig.figsize[0] * 72,
                                         pfig.figsize[1] * 72], atol=1e-3)
    m = re.search(rb"/Length (\d+) >>\nstream\n", data[data.index(
        b"/Subtype /Image"):])
    s0 = data.index(b"/Subtype /Image") + m.end()
    px = np.frombuffer(zlib.decompress(data[s0:s0 + int(m.group(1))]),
                       np.uint8).reshape(h, w, 3)
    png = os.path.splitext(path)[0] + ".same_dpi.png"
    pfig._savefig(png, dpi, "tight" if tight else None)
    np.testing.assert_array_equal(px, read_images([png])[0])
    os.remove(png)


# ---- inputs ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def exp_tree(tmp_path_factory):
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
    return root


def both_dirs(tmp_path):
    return str(tmp_path / "jax"), str(tmp_path / "port")


# ---- the colour tables, the glyph table and the raster primitives ----------

def test_luts_equal_matplotlibs():
    for name in ("viridis", "magma"):
        want = matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
        np.testing.assert_array_equal(raster.lut(name), want)
        # Normalize + the index rule, at the ends and between entries
        vals = np.array([-1.0, 0.0, 0.3, 0.999, 1.0, 2.0, 0.5 / 256])
        got = raster.colormap(vals, name, 0.0, 1.0)
        want = matplotlib.colormaps[name](
            matplotlib.colors.Normalize(0.0, 1.0)(vals), bytes=True)[:, :3]
        np.testing.assert_array_equal(got, want)


def test_glyph_table_regenerates_equal(tmp_path):
    """scripts/make_figure_glyphs.py, run here, writes the committed
    table: every array equal."""
    from scripts import make_figure_glyphs
    dest = str(tmp_path / "g.npz")
    make_figure_glyphs.main([dest])
    with np.load(dest) as new, np.load(raster.DATA) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_text_metrics_follow_matplotlib():
    """A single line's box (width, and height with matplotlib's "lp"
    floor) against matplotlib's Text layout, within a pixel; "?" stands in
    outside the table."""
    for pt, dpi in ((10, 100), (7, 140), (12, 110)):
        mfig = mplt.figure(dpi=dpi)
        r = mfig.canvas.get_renderer()
        f = raster.font(pt, dpi)
        for s in ("Labeled Samples (%)", "0.25", "−0.5", "AP_HR", "Trial"):
            box = mfig.text(0, 0, s, fontsize=pt).get_window_extent(r)
            gw, gh, _ = f.metrics(s)
            assert abs(gw - box.width) <= 1.0 and abs(gh - box.height) \
                <= 1.0, (s, (gw, gh), (box.width, box.height))
        mplt.close(mfig)
    assert f.metrics("é") == f.metrics("?")


@pytest.mark.parametrize("thickness", [1, 2, 3, 5])
def test_line_matches_cv2(thickness):
    """raster.line against cv2.line (LINE_8) on seeded points, many off
    the image, some equal."""
    rng = np.random.default_rng(thickness)
    for _ in range(600):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        p0 = tuple(int(v) for v in rng.integers(-2 * w, 3 * w, 2))
        p1 = p0 if rng.random() < 0.1 else tuple(
            int(v) for v in rng.integers(-2 * w, 3 * w, 2))
        want = cv2.line(img.copy(), p0, p1, (0, 255, 255), thickness)
        got = raster.line(img.copy(), p0, p1, (0, 255, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, p0,
                                                              p1)))


@pytest.mark.parametrize("radius", [0, 1, 3, 7])
def test_circle_matches_cv2(radius):
    rng = np.random.default_rng(10 + radius)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        c = tuple(int(v) for v in rng.integers(-radius - 3, max(h, w) + 4,
                                               2))
        want = cv2.circle(img.copy(), c, radius, (255, 0, 0), -1)
        got = raster.circle(img.copy(), c, radius, (255, 0, 0))
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, c)))


_coord = st.one_of(st.floats(-80, 140, allow_nan=False, width=32),
                   st.sampled_from([0.0, 0.5, 49.0, 49.99, 50.0, 39.0,
                                    -0.5, -3.0]))


@settings(max_examples=120, deadline=None)
@given(st.lists(st.tuples(_coord, _coord, st.floats(0, 1, width=32)),
                min_size=17, max_size=17),
       st.sampled_from([0.0, 0.05, 0.3, 0.5, 0.95, 1.0]),
       st.booleans())
def test_vis_frame_fast_matches_cv2(kpts, thresh, degenerate):
    """vis_frame_fast against the JAX package's (cv2) bit for bit:
    keypoints off the image and on its border, a = b when degenerate."""
    k = np.array(kpts, np.float32)
    if degenerate:
        k[1:, :2] = k[0, :2]
    img = np.random.default_rng(0).integers(0, 255, (40, 50, 3), np.uint8)
    np.testing.assert_array_equal(vis.vis_frame_fast(img, k, thresh),
                                  jax_vis.vis_frame_fast(img, k, thresh))


# ---- the figure functions --------------------------------------------------------

def test_visualize_thc_matches_matplotlib(tmp_path):
    """The 3 x K heatmap grid with its colorbar; one panel's pixel
    centres are viridis at their normalised values."""
    rng = np.random.default_rng(1)
    hms = rng.random((3, 4, 8, 6))
    jd, pd = both_dirs(tmp_path)
    jrec, prec, jp, pp = run_both(
        None, lambda: jax_vis.visualize_thc(jd, 7, *hms, 0.5),
        lambda: vis.visualize_thc(pd, 7, *hms, 0.5))
    assert os.path.relpath(jp, jd) == os.path.relpath(pp, pd)
    compare_figures(jrec, prec, jd, pd)
    fig = prec.figs[0]
    img = read_images([pp])[0]
    ax = fig.axes[5]                         # row 1, joint 1
    data = hms[1, 1]
    centres = ax.transform(np.stack(np.meshgrid(np.arange(6), np.arange(8)),
                                    -1).reshape(-1, 2))
    rows = (img.shape[0] - centres[:, 1]).astype(int)
    cols = centres[:, 0].astype(int)
    want = raster.colormap(data.reshape(-1), "viridis", data.min(),
                           data.max())
    np.testing.assert_array_equal(img[rows, cols], want)


def test_visualize_wpu_matches_matplotlib(tmp_path):
    rng = np.random.default_rng(2)
    fi, fo = rng.random(38), rng.random(38)
    jd, pd = both_dirs(tmp_path)
    jrec, prec, _, _ = run_both(
        None, lambda: jax_vis.visualize_wpu(jd, 7, fi, fo, 0.1),
        lambda: vis.visualize_wpu(pd, 7, fi, fo, 0.1))
    compare_figures(jrec, prec, jd, pd)


@pytest.mark.parametrize("clusters", [False, True])
def test_plot_embedding_selection_matches_matplotlib(tmp_path, clusters):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(12, 6))
    kw = dict(cluster_idx=np.arange(12) % 3) if clusters else {}
    jd, pd = both_dirs(tmp_path)
    jrec, prec, _, _ = run_both(
        None, lambda: jax_vis.plot_embedding_selection(
            jd, emb, [1, 4], "Coreset_round0", weight=rng.random(12), **kw),
        lambda: vis.plot_embedding_selection(
            pd, emb, [1, 4], "Coreset_round0", weight=rng.random(12), **kw))
    compare_figures(jrec, prec, jd, pd)
    img = read_images([os.path.join(pd, "Coreset_round0.png")])[0]
    red = (img[..., 0] > 200) & (img[..., 1] < 60) & (img[..., 2] < 60)
    assert red.sum() > 20                      # the query markers


def test_plot_learning_curves_matches_matplotlib(tmp_path):
    jd, pd = both_dirs(tmp_path)
    os.makedirs(jd)
    os.makedirs(pd)
    args = ("000001", "DUW", [0, 20, 50, 100], [10.5, 40, 55, 61])
    jrec, prec, _, _ = run_both(
        None, lambda: jax_plc(jd, *args, ann=True),
        lambda: plot_learning_curves(pd, *args, ann=True))
    compare_figures(jrec, prec, jd, pd)


@pytest.mark.parametrize("grid", [{"x": [0.5, 2.0, 3.0]},
                                  {"x": [0.01, 2.0, 30.0]},
                                  {"x": [1.0], "y": [0.2, 5.0]},
                                  None])
def test_study_plots_match_matplotlib(tmp_path, grid):
    """plot_history and plot_slice: a linear x, a log x (a range past
    100x), two parameters, and a study with no suggest_* call."""
    studies = []
    for mod in (jax_optuna, optuna_lite):
        if grid is None:
            study = mod.create_study(sampler=mod.GridSampler({}))
            study.optimize(lambda t: 0.25, 3)
        else:
            study = mod.create_study(sampler=mod.GridSampler(grid))
            n = int(np.prod([len(v) for v in grid.values()]))
            study.optimize(lambda t: -sum(
                abs(t.suggest_float(k, 1e-3, 1e3) - 2) for k in sorted(grid)),
                n)
        studies.append(study)
    jd, pd = both_dirs(tmp_path)
    os.makedirs(jd)
    os.makedirs(pd)
    for name in ("history", "slice"):
        jrec, prec, _, _ = run_both(
            None,
            lambda: getattr(studies[0], f"plot_{name}")(f"{jd}/{name}.png"),
            lambda: getattr(studies[1], f"plot_{name}")(f"{pd}/{name}.png"))
        compare_figures(jrec, prec, jd, pd)


@pytest.mark.parametrize("fn", ["plot_strategy_curves",
                                "plot_uncertainty_vs_ap", "plot_spearman"])
def test_detailed_result_figures_match_matplotlib(exp_tree, tmp_path, fn):
    rd, _ = jax_detailed.collect(exp_tree)
    prd, _ = detailed_result.collect(exp_tree)
    jd, pd = both_dirs(tmp_path)
    args = {"plot_strategy_curves": ("AP .75",),
            "plot_uncertainty_vs_ap": (), "plot_spearman": ()}[fn]
    jrec, prec, jp, pp = run_both(
        None, lambda: getattr(jax_detailed, fn)(rd, jd, *args),
        lambda: getattr(detailed_result, fn)(prd, pd, *args))
    assert os.path.relpath(jp, jd) == os.path.relpath(pp, pd)
    compare_figures(jrec, prec, jd, pd)
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))


def test_alc_bar_chart_matches_matplotlib(exp_tree, tmp_path):
    table = jax_wacv.summarize(exp_tree)
    ptable = wacv_result.summarize(exp_tree)
    jd, pd = both_dirs(tmp_path)
    os.makedirs(jd)
    os.makedirs(pd)
    jrec, prec, _, _ = run_both(None, lambda: jax_wacv.alc_bar_chart(
        table, jd), lambda: wacv_result.alc_bar_chart(ptable, pd))
    compare_figures(jrec, prec, jd, pd)


def test_render_heatmaps_matches_matplotlib(tmp_path):
    """The magma panels with their c+ peak markers and a tight box: the
    same calls and limits, every panel and the title inside the PNG."""
    rng = np.random.default_rng(5)
    work = tmp_path / "work"
    hm_dir = work / "heatmap" / "Round1"
    hm_dir.mkdir(parents=True)
    np.save(hm_dir / "heatmaps.npy",
            rng.random((3, 17, 16, 12)).astype(np.float16))
    np.save(hm_dir / "ann_ids.npy", np.array([5, 9, 11]))
    jd, pd = both_dirs(tmp_path)
    jrec, prec, jp, pp = run_both(
        None, lambda: jax_visres.render_heatmaps(str(work), jd, 1, 2),
        lambda: visualize_result.render_heatmaps(str(work), pd, 1, 2))
    assert [os.path.basename(p) for p in jp] == [os.path.basename(p)
                                                  for p in pp]
    compare_figures(jrec, prec, jd, pd)
    for fig, path in zip(prec.figs, pp):
        w, h = png_size(path)
        img = read_images([path])[0]
        for ax in fig.axes:
            assert ax.get_ylim()[0] > ax.get_ylim()[1]      # image rows
        # the panels: magma's darkest and brightest colours both occur
        lut = raster.lut("magma")
        assert (img == lut[0]).all(2).any() and (img == lut[255]).all(
            2).any()
        assert (w, h) != (round(fig.figsize[0] * 110),
                          round(fig.figsize[1] * 110))


def _frame_dataset(root):
    """Three frames (PNG, JPEG, npy) and their predictions."""
    rng = np.random.default_rng(6)
    os.makedirs(os.path.join(root, "images"))
    frames, images = [], []
    for i, ext in enumerate(("png", "jpg", "npy")):
        img = rng.integers(0, 255, (36, 48, 3), np.uint8)
        name = f"images/{i:06d}.{ext}"
        path = os.path.join(root, name)
        if ext == "png":
            write_png(path, img)
        elif ext == "jpg":
            cv2.imwrite(path, img[..., ::-1])
        else:
            np.save(path, img)
        images.append({"id": i, "file_name": name, "width": 48,
                       "height": 36})
    with open(os.path.join(root, "ann.json"), "w") as f:
        json.dump({"images": images, "annotations": []}, f)
    preds = []
    for i in range(3):
        for p in range(2):
            kp = np.concatenate([rng.uniform(-10, 60, (17, 2)),
                                 rng.random((17, 1))], 1)
            preds.append({"image_id": i, "keypoints": kp.ravel().tolist()})
    work = os.path.join(root, "work")
    os.makedirs(work)
    with open(os.path.join(work, "predicted_kpt.json"), "w") as f:
        json.dump(preds, f)
    return work


def test_render_round_pixels_match_cv2(tmp_path):
    """render_round's PNGs decode to the JAX function's pixels (cv2.imread,
    cv2.line/circle, cv2.imwrite there)."""
    work = _frame_dataset(str(tmp_path))
    jax_visres.render_round(work, str(tmp_path), "ann.json",
                            str(tmp_path / "jax"))
    visualize_result.render_round(work, str(tmp_path), "ann.json",
                                  str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) \
        == ["0.png", "1.png", "2.png"]
    for n in names:
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / n)),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(
            read_images([str(tmp_path / "port" / n)])[0], want)


def test_figure_api_units():
    """Direct checks of the layer: nonsingular limits of one point,
    sticky bar bottoms, an explicit limit kept, log ticks."""
    fig, ax = figure.subplots()
    ax.plot([3.0], [3.0], "o")
    mfig, max_ = mplt.subplots()
    max_.plot([3.0], [3.0], "o")
    np.testing.assert_allclose(ax.get_xlim(), max_.get_xlim(), rtol=1e-12)
    np.testing.assert_allclose(ax.get_xticks(), max_.get_xticks())
    fig, ax = figure.subplots()
    ax.bar(range(3), [1.0, 2.0, 0.5])
    mfig, max_ = mplt.subplots()
    max_.bar(range(3), [1.0, 2.0, 0.5])
    np.testing.assert_allclose(ax.get_ylim(), max_.get_ylim(), rtol=1e-12)
    assert ax.get_ylim()[0] == 0.0
    # lines and patches draw from two colour cycles, axhline from neither
    fig, ax = figure.subplots()
    mfig, max_ = mplt.subplots()
    for a in (ax, max_):
        a.plot([0, 1], [0, 1])
        a.axhline(0.5)
        a.plot([0, 1], [1, 0])
    sc = ax.scatter([0.5], [0.5])
    msc = max_.scatter([0.5], [0.5])
    got = [a.color for a in ax.artists[:3]] + [sc.colors[0]]
    want = [tuple(int(round(v * 255)) for v in matplotlib.colors.to_rgb(c))
            for c in (max_.lines[0].get_color(), max_.lines[1].get_color(),
                      max_.lines[2].get_color(), msc.get_facecolor()[0])]
    assert got == want
    mplt.close("all")
    assert math.isclose(figure.log_tick_values(0.02, 400, 9)[0], 1e-3)
