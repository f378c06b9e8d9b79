"""A uint8 RGB canvas in numpy: the drawing under the port's figures
(utils/figure.py) and skeleton overlays (utils/vis.py), with no cv2,
matplotlib or PIL.

* `line` and `circle` are OpenCV's `cv2.line(img, p0, p1, color, t)` and
  `cv2.circle(img, c, r, color, -1)` (LINE_8, shift 0) to the pixel, as
  OpenCV 5.0 draws them: a thickness-1 line is the clipped 8-connected
  Bresenham walk of `LineIterator`; a thicker one is first clipped to the
  image grown by the thickness on each side, then drawn as `ThickLine`'s
  quadrilateral (corner
  offsets `cvRound(d * r)` in 16-bit fixed point, r = (t * 2^15 +
  odd * 2^15) / |p1 - p0|) filled by `FillConvexPoly`'s edge walk with its
  outline drawn by the fixed-point `Line2`, and round caps of radius
  (t * 2^15 + 2^15) >> 16 drawn by `Circle`'s filled spans.
* `Canvas`: `fill_polygon` (even-odd scanline at pixel centres, float
  vertices), rectangles, stroked and dashed polylines, the markers the
  figures use ("o", "x", "+", "s", "_") and alpha blending, each on the
  bounding box of what it draws (a `Region`).
* `draw_text` blits DejaVu Sans glyphs from utils/figure_data.npz (made
  by scripts/make_figure_glyphs.py; DejaVu's licence in
  utils/LICENSE_DEJAVU) at 0, 30 or 90 degrees; a character outside
  printable ASCII and U+2212 (minus) is drawn as "?".
* `LUTS`: matplotlib's viridis and magma tables (CC0,
  `matplotlib._cm_listed`) as 256 x 3 uint8, indexed as matplotlib's
  `Colormap.__call__` indexes a normalised float: min(int(x * 256), 255),
  below 0 the first entry.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Canvas", "Region", "line", "circle", "fill_polygon", "lut",
           "colormap", "font", "Font", "XY_SHIFT"]

DATA = Path(__file__).resolve().parent / "figure_data.npz"
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


@functools.lru_cache(maxsize=1)
def _data() -> Dict[str, np.ndarray]:
    with np.load(DATA) as d:
        return {k: d[k] for k in d.files}


def lut(name: str) -> np.ndarray:
    """The 256 x 3 uint8 table of `name` ("viridis" or "magma")."""
    return _data()[f"lut_{name}"]


def colormap(values: np.ndarray, name: str, vmin: float, vmax: float
             ) -> np.ndarray:
    """matplotlib's Normalize(vmin, vmax) then the colormap's index rule,
    as uint8 RGB."""
    x = np.asarray(values, np.float64)
    if vmax == vmin:
        t = np.zeros_like(x)
    else:
        t = (x - vmin) / (vmax - vmin)
    n = 256
    with np.errstate(invalid="ignore"):
        idx = np.where(t == 1.0, n - 1, (t * n))
    idx = np.where(idx < 0, -1, idx)
    idx = np.clip(np.where(idx < 0, 0, idx), 0, n - 1).astype(np.int64)
    return lut(name)[idx]


# ---- OpenCV's LINE_8 primitives ---------------------------------------------

def _cv_round(x: float) -> int:
    """cvRound: round half to even, as lrint in the default mode."""
    return int(np.rint(x))


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's clipLine on an image of w x h (any integer scale)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line1(img: np.ndarray, p0, p1, color) -> None:
    """Line(img, p0, p1, color, 8): LineIterator, left to right."""
    h, w = img.shape[:2]
    clipped = _clip_line(w, h, p0, p1)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    n = dx + 1
    # err after k steps: err0 - 2*dy*k + 2*dx*(number of minor steps)
    xs, ys = np.empty(n, np.int64), np.empty(n, np.int64)
    major = minor = 0
    ma, mi = (y1, x1) if vert else (x1, y1)
    sma, smi = (sy, sx) if vert else (sx, sy)
    e = err
    for k in range(n):
        if vert:
            xs[k], ys[k] = mi + smi * minor, ma + sma * major
        else:
            xs[k], ys[k] = ma + sma * major, mi + smi * minor
        m = e < 0
        e += -2 * dy + (2 * dx if m else 0)
        major += 1
        minor += 1 if m else 0
    img[ys, xs] = color


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """Line2: FillConvexPoly's outline, a Bresenham walk in 16-bit fixed
    point (one pixel a major step, the minor coordinate rounded), plus the
    far end's pixel."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = ((x1 + half) >> XY_SHIFT) + k
        ys = (y1 + half + step * k) >> XY_SHIFT
    else:
        xs = (x1 + half + step * k) >> XY_SHIFT
        ys = ((y1 + half) >> XY_SHIFT) + k
    xs = np.concatenate([[(x2 + half) >> XY_SHIFT], xs])
    ys = np.concatenate([[(y2 + half) >> XY_SHIFT], ys])
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def _cdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y, x0, x1, color) -> None:
    img[y, x0:x1 + 1] = color


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]], color,
                      shift: int) -> None:
    """FillConvexPoly(img, v, n, color, LINE_8, shift)."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        px, py = v[i]
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line1(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    # edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1        # the C loop's post-decrement at 0
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta1) >> XY_SHIFT
            xx2 = (edge[right][2] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle_spans(cx: int, cy: int, radius: int):
    """Circle's filled spans: (y, x0, x1) rows, unclipped."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        yield cy - dy, cx - dx, cx + dx
        yield cy + dy, cx - dx, cx + dx
        yield cy - dx, cx - dy, cx + dy
        yield cy + dx, cx - dy, cx + dy
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int,
                   color) -> None:
    h, w = img.shape[:2]
    for y, x0, x1 in _circle_spans(cx, cy, radius):
        if 0 <= y < h and x1 >= 0 and x0 < w:
            _hline(img, y, max(x0, 0), min(x1, w - 1), color)


def line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], color,
         thickness: int = 1) -> np.ndarray:
    """cv2.line(img, p0, p1, color, thickness) with LINE_8 and shift 0,
    in place on an (H, W, C) uint8 image; integer points."""
    color = np.asarray(color, np.uint8)
    if thickness > 1:
        # OpenCV (checked: 5.0) first clips a thick line to the image
        # grown by the thickness on every side
        h, w = img.shape[:2]
        t = int(thickness)
        clipped = _clip_line(w + 2 * t, h + 2 * t,
                             (int(p0[0]) + t, int(p0[1]) + t),
                             (int(p1[0]) + t, int(p1[1]) + t))
        if clipped is None:
            return img
        (x0, y0), (x1, y1) = clipped
        p0, p1 = (x0 - t, y0 - t), (x1 - t, y1 - t)
    p0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    p1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    if thickness <= 1:
        r = XY_ONE >> 1
        _line1(img, ((p0[0] + r) >> XY_SHIFT, (p0[1] + r) >> XY_SHIFT),
               ((p1[0] + r) >> XY_SHIFT, (p1[1] + r) >> XY_SHIFT), color)
        return img
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    rr = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(rr) > np.finfo(np.float64).eps:
        rr = (t + odd * XY_ONE * 0.5) / math.sqrt(rr)
        dpx, dpy = _cv_round(dy * rr), _cv_round(dx * rr)
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, color, XY_SHIFT)
    for p in (p0, p1):
        cx = (p[0] + (XY_ONE >> 1)) >> XY_SHIFT
        cy = (p[1] + (XY_ONE >> 1)) >> XY_SHIFT
        _circle_filled(img, cx, cy, (t + (XY_ONE >> 1)) >> XY_SHIFT, color)
    return img


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           color) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1): filled, LINE_8, shift
    0, in place."""
    _circle_filled(img, int(center[0]), int(center[1]), int(radius),
                   np.asarray(color, np.uint8))
    return img


# ---- anti-alias-free figure primitives ---------------------------------------

def fill_polygon(shape: Tuple[int, int], xs: Sequence[float],
                 ys: Sequence[float], out: Optional[Region] = None
                 ) -> Region:
    """The pixels whose centres lie inside the polygon (even-odd rule;
    pixel (r, c) has centre (c + .5, r + .5)), as a Region of an image of
    `shape`, or or-ed into `out`."""
    h, w = shape
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if out is None:
        out = Region.around(shape, xs, ys)
    if len(xs) < 3 or out.mask.size == 0:
        return out
    r0 = max(int(np.floor(ys.min() - 0.5)), out.r0)
    r1 = min(int(np.ceil(ys.max() + 0.5)), out.r0 + out.mask.shape[0])
    if r0 >= r1:
        return out
    cx = np.arange(out.c0, out.c0 + out.mask.shape[1]) + 0.5
    x1, y1 = np.roll(xs, -1), np.roll(ys, -1)
    for r in range(r0, r1):
        yc = r + 0.5
        cross = (ys <= yc) != (y1 <= yc)
        if not cross.any():
            continue
        xi = xs[cross] + (yc - ys[cross]) * (x1[cross] - xs[cross]) / (
            y1[cross] - ys[cross])
        xi.sort()
        row = out.mask[r - out.r0]
        for a, b in zip(xi[0::2], xi[1::2]):
            row |= (cx >= a) & (cx < b)
    return out


class Region:
    """A bool mask over rows r0.. and columns c0.. of an image."""

    def __init__(self, r0: int, c0: int, mask: np.ndarray):
        self.r0, self.c0, self.mask = r0, c0, mask

    @classmethod
    def around(cls, shape, xs, ys, margin: float = 1.0) -> "Region":
        h, w = shape
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        ok = np.isfinite(xs) & np.isfinite(ys)
        if not ok.any():
            return cls(0, 0, np.zeros((0, 0), bool))
        c0 = max(int(np.floor(xs[ok].min() - margin)), 0)
        c1 = min(int(np.ceil(xs[ok].max() + margin)) + 1, w)
        r0 = max(int(np.floor(ys[ok].min() - margin)), 0)
        r1 = min(int(np.ceil(ys[ok].max() + margin)) + 1, h)
        return cls(r0, c0, np.zeros((max(r1 - r0, 0), max(c1 - c0, 0)),
                                    bool))


class Canvas:
    """An (H, W, 3) uint8 RGB image with alpha-blended figure drawing;
    coordinates are float pixels, x right and y down."""

    def __init__(self, width: int, height: int, background=(255, 255, 255)):
        self.img = np.empty((height, width, 3), np.uint8)
        self.img[:] = background

    @classmethod
    def of(cls, img: np.ndarray) -> "Canvas":
        """A canvas drawing into `img` ((H, W, 3) uint8) itself."""
        c = cls.__new__(cls)
        c.img = img
        return c

    @property
    def shape(self):
        return self.img.shape[:2]

    def blend(self, reg: Region, color, alpha: float = 1.0,
              cover: Optional[np.ndarray] = None) -> None:
        """Paint `color` (RGB) over the region's pixels with opacity alpha
        (times `cover`, a float coverage of the region's shape)."""
        if reg.mask.size == 0:
            return
        rh, rw = reg.mask.shape
        view = self.img[reg.r0:reg.r0 + rh, reg.c0:reg.c0 + rw]
        color = np.asarray(color, np.float64)
        if cover is None and alpha >= 1.0:
            view[reg.mask] = color.astype(np.uint8)
            return
        a = reg.mask * float(alpha)
        if cover is not None:
            a = a * cover
        sel = a > 0
        if not sel.any():
            return
        px = view[sel].astype(np.float64)
        aa = a[sel][:, None]
        view[sel] = np.clip(np.rint(px * (1 - aa) + color * aa), 0,
                            255).astype(np.uint8)

    def fill_rect(self, x0, y0, x1, y1, color, alpha: float = 1.0) -> None:
        h, w = self.shape
        c0, c1 = int(round(min(x0, x1))), int(round(max(x0, x1)))
        r0, r1 = int(round(min(y0, y1))), int(round(max(y0, y1)))
        c0, c1 = max(c0, 0), min(c1, w)
        r0, r1 = max(r0, 0), min(r1, h)
        if c0 >= c1 or r0 >= r1:
            return
        self.blend(Region(r0, c0, np.ones((r1 - r0, c1 - c0), bool)),
                   color, alpha)

    def _segment(self, x0, y0, x1, y1, width: float, out: Region) -> None:
        """Or into `out` the pixels whose centres lie within width / 2 of
        the segment (butt ends)."""
        dx, dy = x1 - x0, y1 - y0
        n = math.hypot(dx, dy)
        hw = max(width, 1.0) / 2
        if n == 0:
            fill_polygon(self.shape, [x0 - hw, x0 + hw, x0 + hw, x0 - hw],
                         [y0 - hw, y0 - hw, y0 + hw, y0 + hw], out)
            return
        ox, oy = -dy / n * hw, dx / n * hw
        fill_polygon(self.shape, [x0 + ox, x1 + ox, x1 - ox, x0 - ox],
                     [y0 + oy, y1 + oy, y1 - oy, y0 - oy], out)

    def polyline(self, xs, ys, color, width: float = 1.0, alpha: float = 1.0,
                 dashes: Sequence[float] = ()) -> None:
        """A stroked polyline; `dashes` (on, off, ...) in pixels."""
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        ok = np.isfinite(xs) & np.isfinite(ys)
        segs = [(xs[i], ys[i], xs[i + 1], ys[i + 1])
                for i in range(len(xs) - 1) if ok[i] and ok[i + 1]]
        if not segs:
            return
        h, w = self.shape
        segs = [sg for sg in segs if not (
            max(sg[0], sg[2]) < -w or min(sg[0], sg[2]) > 2 * w
            or max(sg[1], sg[3]) < -h or min(sg[1], sg[3]) > 2 * h)]
        if dashes:
            segs = list(_dash(segs, dashes))
        if not segs:
            return
        a = np.array(segs)
        reg = Region.around(self.shape, a[:, [0, 2]].ravel(),
                            a[:, [1, 3]].ravel(), width + 1)
        for sg in segs:
            self._segment(*sg, width, reg)
        self.blend(reg, color, alpha)

    def marker(self, x: float, y: float, kind: str, size: float, color,
               alpha: float = 1.0, edge=None, width: float = 1.0) -> None:
        """A scatter or line marker centred at (x, y), `size` its width in
        pixels: "o" a filled disc, "s" a filled square, "x" and "+" two
        strokes, "_" a horizontal stroke (error-bar caps)."""
        r = size / 2
        h, w = self.shape
        if x + r < -1 or y + r < -1 or x - r > w + 1 or y - r > h + 1:
            return
        reg = Region.around(self.shape, [x - r, x + r], [y - r, y + r],
                            width + 1)
        if reg.mask.size == 0:
            return
        if kind == "o":
            rh, rw = reg.mask.shape
            yy, xx = np.mgrid[reg.r0:reg.r0 + rh, reg.c0:reg.c0 + rw]
            reg.mask[:] = (xx + .5 - x) ** 2 + (yy + .5 - y) ** 2 <= r * r
        elif kind == "s":
            self.fill_rect(x - r, y - r, x + r, y + r, color, alpha)
            return
        elif kind in ("x", "+", "_"):
            if kind == "x":
                d = r / math.sqrt(2)
                segs = [(x - d, y - d, x + d, y + d),
                        (x - d, y + d, x + d, y - d)]
            elif kind == "+":
                segs = [(x - r, y, x + r, y), (x, y - r, x, y + r)]
            else:
                segs = [(x - r, y, x + r, y)]
            for sg in segs:
                self._segment(*sg, width, reg)
        else:
            raise ValueError(f"marker {kind!r} is not supported")
        self.blend(reg, color, alpha)

    def draw_text(self, text: str, x: float, y: float, fnt: "Font",
                  color=(0, 0, 0), ha: str = "left", va: str = "baseline",
                  rotation: float = 0.0) -> Tuple[float, float, float, float]:
        """Blit `text` with its anchor at (x, y): `ha` left, center or
        right and `va` baseline, bottom, center or top of the box, the
        box turned by `rotation` degrees (0, 30 or 90) counter-clockwise
        and then aligned by its extent, as matplotlib's rotation_mode
        "default" does.  Returns the drawn extent (x0, y0, x1, y1)."""
        cov, asc = fnt.render(text)
        if rotation:
            cov = _rotate(cov, rotation)
        bh, bw = cov.shape
        x0 = {"left": x, "center": x - bw / 2, "right": x - bw}[ha]
        if rotation:
            y0 = {"top": y, "center": y - bh / 2, "bottom": y - bh,
                  "baseline": y - bh}[va]
        else:
            y0 = {"top": y, "center": y - bh / 2, "bottom": y - bh,
                  "baseline": y - asc}[va]
        c0, r0 = int(round(x0)), int(round(y0))
        h, w = self.shape
        a0, a1 = max(r0, 0), min(r0 + bh, h)
        b0, b1 = max(c0, 0), min(c0 + bw, w)
        if a0 < a1 and b0 < b1:
            cover = cov[a0 - r0:a1 - r0, b0 - c0:b1 - c0] / 255.0
            self.blend(Region(a0, b0, cover > 0), color, 1.0, cover)
        return (c0, r0, c0 + bw, r0 + bh)


def _dash(segs, pattern):
    """Cut segments into the on-parts of a dash pattern (on, off, ...)
    that runs on along the polyline."""
    pattern = [float(p) for p in pattern]
    i, rem = 0, pattern[0]
    for x0, y0, x1, y1 in segs:
        n = math.hypot(x1 - x0, y1 - y0)
        s = 0.0
        while n - s > 1e-9:
            step = min(rem, n - s)
            if i % 2 == 0:
                t0, t1 = s / n, (s + step) / n
                yield (x0 + (x1 - x0) * t0, y0 + (y1 - y0) * t0,
                       x0 + (x1 - x0) * t1, y0 + (y1 - y0) * t1)
            s += step
            rem -= step
            if rem <= 1e-9:
                i = (i + 1) % len(pattern)
                rem = pattern[i]


def _rotate(cov: np.ndarray, deg: float) -> np.ndarray:
    """A coverage image turned counter-clockwise by deg (90 exactly, other
    angles by nearest-neighbour sampling)."""
    if deg % 360 == 90:
        return np.ascontiguousarray(np.rot90(cov))
    t = math.radians(deg)
    c, s = math.cos(t), math.sin(t)
    h, w = cov.shape
    # corners of the source, turned (x right, y up)
    xs = np.array([0, w, w, 0.0])
    ys = np.array([0, 0, -h, -h.__float__()])
    rx, ry = xs * c - ys * s, xs * s + ys * c
    W = int(math.ceil(rx.max() - rx.min()))
    H = int(math.ceil(ry.max() - ry.min()))
    X, Y = np.meshgrid(np.arange(W) + 0.5 + rx.min(),
                       -(np.arange(H) + 0.5) + ry.max())
    sx = X * c + Y * s
    sy = -(-X * s + Y * c)
    ci, ri = np.floor(sx).astype(int), np.floor(sy).astype(int)
    ok = (ci >= 0) & (ci < w) & (ri >= 0) & (ri < h)
    out = np.zeros((H, W), np.uint8)
    out[ok] = cov[ri[ok], ci[ok]]
    return out


# ---- text --------------------------------------------------------------------

class Font:
    """DejaVu Sans at one point size and dpi, from the committed glyph
    table; metrics in pixels as matplotlib's Agg text layout gives
    them."""

    def __init__(self, pt: float, dpi: float):
        d = _data()
        key = f"g{int(pt)}_{int(dpi)}_"
        if key + "meta" not in d:
            raise ValueError(f"no glyphs for {pt} pt at {dpi} dpi "
                             f"(scripts/make_figure_glyphs.py SIZES)")
        self.pt, self.dpi = pt, dpi
        chars = d["chars"].tobytes().decode("utf-32-le")
        self.index = {c: i for i, c in enumerate(chars)}
        self.pix, self.meta = d[key + "pix"], d[key + "meta"]
        self.pair = d[key + "pair"]
        lp = d[key + "lp"]
        self.lp_h, self.lp_d = lp[1] / 64.0, lp[2] / 64.0

    def _ids(self, text: str):
        q = self.index["?"]
        return [self.index.get(c, q) for c in text]

    def _lefts(self, ids):
        """Each glyph's ink left edge in 1/64 px from the first's: a
        pair's width less the second glyph's own."""
        lefts = [0]
        for a, b in zip(ids, ids[1:]):
            lefts.append(lefts[-1] + self.pair[a, b] - self.meta[b, 5])
        return lefts

    def metrics(self, text: str) -> Tuple[float, float, float]:
        """(width, height, descent) of one line, matplotlib's way: the
        ink box's width, the height and descent at least those of
        "lp"."""
        ids = self._ids(text)
        if not ids:
            return 0.0, self.lp_h, self.lp_d
        lefts = self._lefts(ids)
        width = (lefts[-1] + self.meta[ids[-1], 5]) / 64.0
        top = max(self.meta[i, 6] - self.meta[i, 4] for i in ids)
        bot = max(self.meta[i, 4] for i in ids)
        h = max((top + bot) / 64.0, self.lp_h)
        dsc = max(bot / 64.0, self.lp_d)
        return width, h, dsc

    def render(self, text: str) -> Tuple[np.ndarray, int]:
        """The text's coverage image (uint8) and the rows above its
        baseline; the box is as tall as matplotlib's line box."""
        ids = self._ids(text)
        w, h, dsc = self.metrics(text)
        asc = int(math.ceil(h - dsc))
        rows = asc + int(math.ceil(dsc))
        lefts = self._lefts(ids)
        width = int(math.ceil(w)) + 2
        out = np.zeros((max(rows, 1), max(width, 1)), np.uint8)
        for left, i in zip(lefts, ids):
            off, r, c, _, dsc_i, _, _ = self.meta[i]
            if r == 0 or c == 0:
                continue
            g = self.pix[off:off + r * c].reshape(r, c)
            c0 = int(round(left / 64.0))
            r0 = asc - (r - int(round(dsc_i / 64.0)))
            a0, a1 = max(r0, 0), min(r0 + r, out.shape[0])
            b0, b1 = max(c0, 0), min(c0 + c, out.shape[1])
            if a0 < a1 and b0 < b1:
                out[a0:a1, b0:b1] = np.maximum(
                    out[a0:a1, b0:b1], g[a0 - r0:a1 - r0, b0 - c0:b1 - c0])
        return out, asc


@functools.lru_cache(maxsize=None)
def font(pt: float, dpi: float) -> Font:
    return Font(pt, dpi)
