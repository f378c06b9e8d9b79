"""The port's figures without matplotlib: a `Figure` and `Axes` that take
the part of matplotlib's pyplot/Axes API the port's figure functions call,
with the same meanings, drawn by utils/raster.py into PNG (through
data/image_io.write_png) or a one-page PDF.

    from vatl4pose_tpu_torch.utils import figure as plt
    fig, ax = plt.subplots()
    ax.plot(x, y, "o", label="trial value")
    fig.savefig("history.png", dpi=140)

What follows matplotlib 3.10's defaults to the number: the figure size
(6.4 x 4.8 in at 100 dpi) and the subplot box (left .125, right .9, bottom
.11, top .88, wspace and hspace .2), the auto view limits (5% margins
added in the scale's space, sticky edges of bars and images, `nonsingular`,
the lazy autoscale that `axhline` and `set_xticks` trigger as matplotlib's
viewLim reads do), the tick values (AutoLocator: MaxNLocator with steps
1, 2, 2.5, 5, 10 and nbins from the axis length, LogLocator for log
axes), `colorbar`'s space stealing (0.15 of the parents' width, pad 0.05,
shrink, box aspect 20), `tight_layout`'s margins (pad 1.08 font sizes)
and `bbox_inches="tight"` (pad 0.1 in).  What is drawn is the same
content, not the same pixels: no anti-aliasing of lines and markers,
nearest-neighbour images, DejaVu Sans glyph bitmaps (utils/raster.Font)
with characters outside printable ASCII drawn as "?", a simplified legend
placement for loc "best" (the candidate box holding the fewest data
points), and the PDF is the raster image on a page of the figure's size
in points (matplotlib writes vectors).

Every `Axes` and `Figure` keeps the calls made on it as (method, args,
kwargs) in `.calls`.
"""

from __future__ import annotations

import math
import os
import zlib
from typing import List, Optional, Tuple

import numpy as np

from . import raster

__all__ = ["Figure", "Axes", "subplots", "close", "tick_values",
           "log_tick_values", "COLORS"]

DPI = 100.0
FIGSIZE = (6.4, 4.8)
SUBPLOT = dict(left=0.125, right=0.9, bottom=0.11, top=0.88, wspace=0.2,
               hspace=0.2)
FONT_PT = 10.0
CYCLE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
COLORS = {"b": (0, 0, 255), "g": (0, 128, 0), "r": (255, 0, 0),
          "c": (0, 191, 191), "m": (191, 0, 191), "y": (191, 191, 0),
          "k": (0, 0, 0), "w": (255, 255, 255), "blue": (0, 0, 255),
          "red": (255, 0, 0), "gray": (128, 128, 128),
          "grey": (128, 128, 128), "black": (0, 0, 0),
          "white": (255, 255, 255), "green": (0, 128, 0),
          "orange": (255, 165, 0)}
GRID = (176, 176, 176)
MARGIN = 0.05
LINE_W, MARKER_PT, EDGE_W = 1.5, 6.0, 1.0
DASHES = {"-": (), "--": (3.7, 1.6), ":": (1.0, 1.65), "-.": (6.4, 1.6, 1.0,
                                                              1.6)}
TICK_LEN, TICK_PAD, LABEL_PAD, TITLE_PAD = 3.5, 3.5, 4.0, 6.0


def to_rgb(c) -> Tuple[int, int, int]:
    """A matplotlib colour spec (name, single letter, "#rrggbb", "Cn",
    a gray level, an RGB(A) float tuple) as uint8 RGB."""
    if isinstance(c, str):
        if c in COLORS:
            return COLORS[c]
        if len(c) == 2 and c[0] == "C" and c[1].isdigit():
            c = CYCLE[int(c[1])]
        if c.startswith("#") and len(c) == 7:
            return tuple(int(c[k:k + 2], 16) for k in (1, 3, 5))
        try:
            g = float(c)                      # a gray level as a string
            return (int(round(g * 255)),) * 3
        except ValueError:
            raise ValueError(f"colour {c!r} is not supported") from None
    t = tuple(float(v) for v in c)[:3]
    return tuple(int(round(v * 255)) for v in t)


def _parse_fmt(fmt: str):
    """matplotlib's fmt string: (colour, marker, linestyle)."""
    color = marker = ls = None
    s = fmt
    for style in ("--", "-.", "-", ":"):
        if style in s:
            ls = style
            s = s.replace(style, "", 1)
            break
    for ch in s:
        if ch in "bgrcmykw":
            color = ch
        elif ch in "ox+s.":
            marker = ch
        else:
            raise ValueError(f"fmt {fmt!r} is not supported")
    if ls is None and marker is None:
        ls = "-"
    return color, marker, ls


# ---- ticks -------------------------------------------------------------------

def nonsingular(vmin, vmax, expander=0.001, tiny=1e-15, increasing=True):
    """matplotlib.transforms.nonsingular."""
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    swapped = False
    if vmax < vmin:
        vmin, vmax = vmax, vmin
        swapped = True
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    if swapped and not increasing:
        vmin, vmax = vmax, vmin
    return vmin, vmax


def _scale_range(vmin, vmax, n=1, threshold=100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < threshold:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / n) // 1)
    return scale, offset


class _Edge:
    def __init__(self, step, offset):
        self.step, self.offset = step, abs(offset)

    def closeto(self, ms, edge):
        if self.offset > 0:
            digits = np.log10(self.offset / self.step)
            tol = min(0.4999, max(1e-10, 10 ** (digits - 12)))
        else:
            tol = 1e-10
        return abs(ms - edge) < tol

    def le(self, x):
        d, m = divmod(x, self.step)
        return d + 1 if self.closeto(m / self.step, 1) else d

    def ge(self, x):
        d, m = divmod(x, self.step)
        return d if self.closeto(m / self.step, 0) else d + 1


_STEPS = np.array([1, 2, 2.5, 5, 10])
_EXT_STEPS = np.concatenate([0.1 * _STEPS[:-1], _STEPS, [10 * _STEPS[1]]])


def tick_values(vmin: float, vmax: float, nbins: int) -> np.ndarray:
    """AutoLocator().tick_values with nbins already chosen (matplotlib's
    MaxNLocator, steps 1, 2, 2.5, 5, 10, min_n_ticks 2)."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = _EXT_STEPS * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if large.any() else len(steps) - 1
    ticks = None
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        edge = _Edge(step, offset)
        low = edge.le(_vmin - best_vmin)
        high = edge.ge(_vmax - best_vmin)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def log_tick_values(vmin: float, vmax: float, numticks: int,
                    minpos: float = np.inf) -> np.ndarray:
    """LogLocator(base 10, subs (1,)).tick_values."""
    if vmin <= 0.0:
        vmin = minpos
        if vmin <= 0.0 or not np.isfinite(vmin):
            raise ValueError("Data has no positive values, and therefore "
                             "cannot be log-scaled.")
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    log_vmin = math.log(vmin) / math.log(10.0)
    log_vmax = math.log(vmax) / math.log(10.0)
    numdec = math.floor(log_vmax) - math.ceil(log_vmin)
    stride = numdec // numticks + 1
    if stride >= numdec:
        stride = max(1, numdec - 1)
    decades = np.arange(math.floor(log_vmin) - stride,
                        math.ceil(log_vmax) + 2 * stride, stride)
    return 10.0 ** decades


def _decade_less_equal(x):
    return 10.0 ** np.floor(np.log10(x)) if x > 0 else x


def _decade_greater_equal(x):
    return 10.0 ** np.ceil(np.log10(x)) if x > 0 else x


def _decade_less(x):
    less = _decade_less_equal(x)
    return less / 10.0 if less == x else less


def _decade_greater(x):
    greater = _decade_greater_equal(x)
    return greater * 10.0 if greater == x else greater


def _format_ticks(vals: np.ndarray, log: bool) -> List[str]:
    """Tick labels: ScalarFormatter's plain form (as many decimals as the
    step needs, U+2212 for minus), "10^k" on a log axis."""
    if log:
        return [f"10^{int(round(math.log10(v)))}" for v in vals]
    if len(vals) > 1:
        step = np.min(np.abs(np.diff(vals)))
    else:
        step = abs(vals[0]) if len(vals) and vals[0] else 1.0
    dec = 0
    while dec < 8 and step > 0 and abs(round(step * 10 ** dec)
                                       - step * 10 ** dec) > 1e-6 * 10 ** dec:
        dec += 1
    out = []
    for v in vals:
        s = f"{v:.{dec}f}"
        if float(s) == 0:
            s = s.lstrip("-")
        out.append(s.replace("-", "−"))
    return out


# ---- the artists ---------------------------------------------------------------

class _Artist:
    def __init__(self, kind, **kw):
        self.kind = kind
        self.__dict__.update(kw)
        self.sticky_x: List[float] = []
        self.sticky_y: List[float] = []

    def get_label(self):
        return getattr(self, "label", None)


class Axes:
    """One subplot: matplotlib's Axes for the calls the figures make."""

    def __init__(self, fig: "Figure", cell: Tuple[int, int, int, int]):
        self.figure = fig
        self.cell = cell                # (nrows, ncols, row, col)
        self.calls: List[tuple] = []
        self.artists: List[_Artist] = []
        self.xlabel = self.ylabel = self.title = ""
        self.xscale = "linear"
        self._grid = False
        self._axis_on = True
        self._legend = None
        self._xticks = None
        self._xticklabels = None
        self._xticklabel_kw = {}
        self._aspect_equal = False
        # matplotlib's two colour cycles: lines, and patches (scatter, bar)
        self._cycle = {"lines": 0, "patches": 0}
        self._datalim = [[np.inf, -np.inf], [np.inf, -np.inf]]
        self._minpos = [np.inf, np.inf]
        self._viewlim = [[0.0, 1.0], [0.0, 1.0]]
        self._auto = [True, True]
        self._stale = [False, False]
        self._mutated = [False, False]
        self.colorbar_of = None         # the Colorbar this axes draws
        self.position = fig._cell_box(cell)

    def _next_color(self, which):
        c = CYCLE[self._cycle[which] % len(CYCLE)]
        self._cycle[which] += 1
        return c

    def _record(self, name, args, kwargs):
        self.calls.append((name, args, kwargs))

    # -- data limits and autoscale (matplotlib's lazy viewLim) --
    def _update_datalim(self, xs=None, ys=None):
        for i, v in ((0, xs), (1, ys)):
            if v is None:
                continue
            v = np.asarray(v, np.float64).ravel()
            v = v[np.isfinite(v)]
            if not v.size:
                continue
            self._datalim[i][0] = min(self._datalim[i][0], v.min())
            self._datalim[i][1] = max(self._datalim[i][1], v.max())
            pos = v[v > 0]
            if pos.size:
                self._minpos[i] = min(self._minpos[i], pos.min())

    def _request_autoscale(self, x=True, y=True):
        if x:
            self._stale[0] = True
        if y:
            self._stale[1] = True

    def _unstale(self):
        if self._stale[0] or self._stale[1]:
            sx, sy = self._stale
            self._stale = [False, False]
            self._autoscale(sx, sy)

    def _autoscale(self, scalex=True, scaley=True):
        for i, scale in ((0, scalex), (1, scaley)):
            if not (scale and self._auto[i]):
                continue
            lo, hi = self._datalim[i]
            log = i == 0 and self.xscale == "log"
            if np.isfinite(lo) and np.isfinite(hi):
                x0, x1 = lo, hi
            elif self._mutated[i]:
                continue
            else:
                x0, x1 = -np.inf, np.inf
            x0, x1 = self._loc_nonsingular(i, x0, x1)
            stick = np.sort(np.array([s for a in self.artists for s in
                                      (a.sticky_x if i == 0 else a.sticky_y)],
                                     np.float64))
            if log:
                stick = stick[stick > 0]
            tol = 1e-5 * abs(x1 - x0)
            i0 = stick.searchsorted(x0 + tol) - 1
            b0 = stick[i0] if i0 != -1 else None
            i1 = stick.searchsorted(x1 - tol)
            b1 = stick[i1] if i1 != len(stick) else None
            if log:
                mp = self._minpos[i] if np.isfinite(self._minpos[i]) \
                    else 1e-300
                x0 = mp if x0 <= 0 else x0
                x1 = mp if x1 <= 0 else x1
                t0, t1 = np.log10([x0, x1])
                d = (t1 - t0) * MARGIN
                if not np.isfinite(d):
                    d = 0
                x0, x1 = np.power(10.0, [t0 - d, t1 + d])
            else:
                d = (x1 - x0) * MARGIN
                if not np.isfinite(d):
                    d = 0
                x0, x1 = x0 - d, x1 + d
            if b0 is not None:
                x0 = max(x0, b0)
            if b1 is not None:
                x1 = min(x1, b1)
            x0, x1 = self._loc_nonsingular(i, x0, x1) if log else \
                nonsingular(x0, x1)
            self._set_bound(i, float(x0), float(x1))

    def _loc_nonsingular(self, i, x0, x1):
        if i == 0 and self.xscale == "log":
            if x0 > x1:
                x0, x1 = x1, x0
            if not np.isfinite(x0) or not np.isfinite(x1) or x1 <= 0:
                return 1.0, 10.0
            mp = self._minpos[i] if np.isfinite(self._minpos[i]) else 1e-300
            if x0 <= 0:
                x0 = mp
            if x0 == x1:
                x0, x1 = _decade_less(x0), _decade_greater(x1)
            return x0, x1
        return nonsingular(x0, x1, expander=0.05)

    def _set_bound(self, i, lo, hi):
        v0, v1 = self._viewlim[i]
        if v1 < v0:                       # keep an inversion
            lo, hi = hi, lo
        self._viewlim[i] = [lo, hi]
        self._mutated[i] = True

    def get_xlim(self):
        self._unstale()
        return tuple(self._viewlim[0])

    def get_ylim(self):
        self._unstale()
        return tuple(self._viewlim[1])

    # -- the drawing calls --
    def plot(self, *args, **kwargs):
        self._record("plot", args, kwargs)
        args = list(args)
        fmt = None
        if args and isinstance(args[-1], str):
            fmt = args.pop()
        if len(args) == 1:
            y = np.asarray(args[0], np.float64).ravel()
            x = np.arange(len(y), dtype=np.float64)
        else:
            x = np.asarray(args[0], np.float64).ravel()
            y = np.asarray(args[1], np.float64).ravel()
        color, marker, ls = _parse_fmt(fmt) if fmt else (None, None, "-")
        marker = kwargs.get("marker", marker)
        ls = kwargs.get("ls", kwargs.get("linestyle", ls))
        color = kwargs.get("color", kwargs.get("c", color))
        if color is None:
            color = self._next_color("lines")
        a = _Artist("line", x=x, y=y, color=to_rgb(color), marker=marker,
                    ls=ls, ms=float(kwargs.get("markersize", MARKER_PT)),
                    alpha=float(kwargs.get("alpha", 1.0)),
                    label=kwargs.get("label"))
        self.artists.append(a)
        self._update_datalim(x, y)
        self._request_autoscale()
        return [a]

    def scatter(self, *args, **kwargs):
        self._record("scatter", args, kwargs)
        return self._scatter(*args, **kwargs)

    def _scatter(self, x, y, s=None, c=None, marker="o", cmap=None,
                 alpha=None, label=None):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        size = MARKER_PT ** 2 if s is None else float(s)
        values = None
        if c is None:
            colors = [to_rgb(self._next_color("patches"))] * len(x)
        elif isinstance(c, str):
            colors = [to_rgb(c)] * len(x)
        else:
            values = np.asarray(c, np.float64).ravel()
            vmin, vmax = float(values.min()), float(values.max())
            colors = [tuple(v) for v in raster.colormap(
                values, cmap or "viridis", vmin, vmax)]
        a = _Artist("scatter", x=x, y=y, size=size, colors=colors,
                    marker=marker, alpha=1.0 if alpha is None else alpha,
                    label=label, values=values, cmap=cmap or "viridis")
        if values is not None:
            a.vmin, a.vmax = float(values.min()), float(values.max())
        self.artists.append(a)
        self._update_datalim(x, y)
        self._request_autoscale()
        return a

    def bar(self, *args, **kwargs):
        self._record("bar", args, kwargs)
        self._bar(*args, **kwargs)

    def _bar(self, x, height, width=0.8, yerr=None, capsize=None,
             color=None):
        x = np.asarray(list(x), np.float64)
        h = np.asarray(height, np.float64)
        color = to_rgb(color or self._next_color("patches"))
        for xi, hi in zip(x, h):
            a = _Artist("rect", x0=xi - width / 2, x1=xi + width / 2,
                        y0=0.0, y1=hi, color=color)
            a.sticky_y.append(0.0)
            self.artists.append(a)
            self._update_datalim([xi - width / 2, xi + width / 2], [0.0, hi])
        if yerr is not None:
            e = np.broadcast_to(np.asarray(yerr, np.float64), h.shape)
            a = _Artist("errorbar", x=x, lo=h - e, hi=h + e,
                        cap=float(capsize or 0.0), color=(0, 0, 0))
            self.artists.append(a)
            self._update_datalim(x, np.concatenate([h - e, h + e]))
        self._request_autoscale()
        return None

    def imshow(self, *args, **kwargs):
        self._record("imshow", args, kwargs)
        return self._imshow(*args, **kwargs)

    def _imshow(self, data, cmap=None):
        z = np.asarray(data, np.float64)
        h, w = z.shape[:2]
        a = _Artist("image", z=z, cmap=cmap or "viridis",
                    vmin=float(np.nanmin(z)), vmax=float(np.nanmax(z)))
        a.sticky_x = [-0.5, w - 0.5]
        a.sticky_y = [h - 0.5, -0.5]
        self.artists.append(a)
        self._update_datalim([-0.5, w - 0.5], [-0.5, h - 0.5])
        self._aspect_equal = True
        if self._auto[0]:
            self._viewlim[0] = [-0.5, w - 0.5]
        if self._auto[1]:
            self._viewlim[1] = [h - 0.5, -0.5]
        self._mutated = [True, True]
        return a

    def axhline(self, y=0, **kwargs):
        self._record("axhline", (y,), kwargs)
        lo, hi = sorted(self.get_ylim())           # matplotlib reads bounds
        scaley = y < lo or y > hi
        # a bare Line2D: rcParams' lines.color, no cycle
        color = kwargs.get("color", kwargs.get("c", "C0"))
        a = _Artist("hline", y=float(y), color=to_rgb(color),
                    ls=kwargs.get("ls", kwargs.get("linestyle", "-")),
                    label=kwargs.get("label"), alpha=1.0, marker=None,
                    ms=MARKER_PT)
        self.artists.append(a)
        self._update_datalim(None, [y])
        if scaley:
            self._request_autoscale(False, True)
        return a

    def set_xlabel(self, s, **kwargs):
        self._record("set_xlabel", (s,), kwargs)
        self.xlabel = str(s)

    def set_ylabel(self, s, **kwargs):
        self._record("set_ylabel", (s,), kwargs)
        self.ylabel = str(s)

    def set_title(self, s, **kwargs):
        self._record("set_title", (s,), kwargs)
        self.title = str(s)

    def _set_lim(self, i, name, args, kwargs):
        self._record(name, args, kwargs)
        lo, hi = (args[0] if len(args) == 1 else args)
        if lo == hi:
            lo, hi = nonsingular(lo, hi, expander=0.05)
        self._viewlim[i] = [float(lo), float(hi)]
        self._auto[i] = False
        self._mutated[i] = True

    def set_xlim(self, *args, **kwargs):
        self._set_lim(0, "set_xlim", args, kwargs)

    def set_ylim(self, *args, **kwargs):
        self._set_lim(1, "set_ylim", args, kwargs)

    def set_xscale(self, value, **kwargs):
        self._record("set_xscale", (value,), kwargs)
        if value not in ("linear", "log"):
            raise ValueError(f"scale {value!r} is not supported")
        self.xscale = value
        self._request_autoscale(True, False)

    def set_xticks(self, ticks, **kwargs):
        self._record("set_xticks", (ticks,), kwargs)
        ticks = np.asarray(list(ticks), np.float64)
        if len(ticks):
            lo, hi = self.get_xlim()              # set_view_interval
            vmin, vmax = ticks.min(), ticks.max()
            if lo < hi:
                self._viewlim[0] = [min(vmin, lo), max(vmax, hi)]
            else:
                self._viewlim[0] = [max(vmax, lo), min(vmin, hi)]
        self._xticks = ticks

    def set_xticklabels(self, labels, **kwargs):
        self._record("set_xticklabels", (labels,), kwargs)
        self._xticklabels = [str(s) for s in labels]
        self._xticklabel_kw = kwargs

    def grid(self, visible=None, **kwargs):
        self._record("grid", () if visible is None else (visible,), kwargs)
        self._grid = True if visible is None else bool(visible)

    def legend(self, *args, **kwargs):
        self._record("legend", args, kwargs)
        self._legend = dict(kwargs)

    def axis(self, arg=None):
        self._record("axis", () if arg is None else (arg,), {})
        if arg == "off":
            self._axis_on = False
        elif arg == "on":
            self._axis_on = True
        return (*self.get_xlim(), *self.get_ylim())

    # -- geometry --
    def _box_px(self, W, H):
        """The drawn axes box (x0, y0, x1, y1) in pixels, y down, after
        an equal aspect shrinks it (anchored at its centre, or at the
        colorbar's panchor)."""
        fx0, fy0, fx1, fy1 = self.position
        x0, x1 = fx0 * W, fx1 * W
        y0, y1 = (1 - fy1) * H, (1 - fy0) * H
        if self._aspect_equal:
            (a0, a1), (b0, b1) = self._viewlim
            dw, dh = abs(a1 - a0), abs(b1 - b0)
            bw, bh = x1 - x0, y1 - y0
            if dw > 0 and dh > 0 and bw > 0 and bh > 0:
                if bh / bw > dh / dw:                 # too tall
                    nh = bw * dh / dw
                    y0 += (bh - nh) / 2
                    y1 = y0 + nh
                else:
                    nw = bh * dw / dh
                    ax_ = getattr(self, "_panchor_x", 0.5)
                    x0 += (bw - nw) * ax_
                    x1 = x0 + nw
        if self.colorbar_of is not None:               # box aspect 20
            bw, bh = x1 - x0, y1 - y0
            nw = bh / self.colorbar_of.aspect
            if nw < bw:
                x1 = x0 + nw
            else:
                nh = bw * self.colorbar_of.aspect
                y0 += (bh - nh) / 2
                y1 = y0 + nh
        return x0, y0, x1, y1

    def _tick_space(self, i):
        x0, y0, x1, y1 = self._box_px(self.figure.figsize[0] * 72,
                                      self.figure.figsize[1] * 72)
        length = (x1 - x0) if i == 0 else (y1 - y0)
        size = FONT_PT * (3 if i == 0 else 2)
        return int(np.floor(length / size))

    def get_xticks(self):
        if self._xticks is not None:
            return np.asarray(self._xticks)
        lo, hi = sorted(self.get_xlim())
        if self.xscale == "log":
            return log_tick_values(lo, hi, int(np.clip(self._tick_space(0),
                                                       2, 9)),
                                   self._minpos[0])
        return tick_values(lo, hi, int(np.clip(self._tick_space(0), 1, 9)))

    def get_yticks(self):
        lo, hi = sorted(self.get_ylim())
        return tick_values(lo, hi, int(np.clip(self._tick_space(1), 1, 9)))

    def _trans(self, W, H):
        """(x, y) data -> pixel (x right, y down) on a W x H canvas."""
        x0, y0, x1, y1 = self._box_px(W, H)
        (a0, a1), (b0, b1) = self.get_xlim(), self.get_ylim()
        log = self.xscale == "log"

        def tx(v):
            v = np.asarray(v, np.float64)
            if log:
                with np.errstate(divide="ignore", invalid="ignore"):
                    return x0 + (np.log10(v) - np.log10(a0)) / (
                        np.log10(a1) - np.log10(a0)) * (x1 - x0)
            return x0 + (v - a0) / (a1 - a0) * (x1 - x0)

        def ty(v):
            v = np.asarray(v, np.float64)
            return y1 - (v - b0) / (b1 - b0) * (y1 - y0)
        return tx, ty

    def transform(self, points, dpi: Optional[float] = None) -> np.ndarray:
        """Data points -> display pixels with matplotlib's convention (y
        up from the figure's bottom), at `dpi` (the figure's by default)."""
        dpi = dpi or self.figure.dpi
        W, H = self.figure.figsize[0] * dpi, self.figure.figsize[1] * dpi
        tx, ty = self._trans(W, H)
        p = np.asarray(points, np.float64).reshape(-1, 2)
        return np.stack([tx(p[:, 0]), H - ty(p[:, 1])], 1)

    # -- decorations' extents, for tight_layout and bbox_inches="tight" --
    def _decor_boxes(self, W, H, dpi):
        """The text boxes around the axes, (x0, y0, x1, y1) in pixels,
        at their drawn places."""
        boxes = []
        x0, y0, x1, y1 = self._box_px(W, H)
        px = dpi / 72.0
        if self._axis_on:
            f = raster.font(FONT_PT, dpi)
            bottom = y1 + (TICK_LEN + TICK_PAD) * px
            xt = self._xtick_items(W, H)
            for x, label, fnt, rot, ha in xt:
                w, h, d = fnt.metrics(label)
                boxes.append(_text_box(x, bottom, w, h, rot, ha, "top"))
            lab_top = max([b[3] for b in boxes] + [y1 + (TICK_LEN) * px])
            if self.xlabel:
                w, h, d = f.metrics(self.xlabel)
                top = lab_top + LABEL_PAD * px
                boxes.append(((x0 + x1) / 2 - w / 2, top,
                              (x0 + x1) / 2 + w / 2, top + h))
            left = x0 - (TICK_LEN + TICK_PAD) * px
            ylabs = []
            for y, label in self._ytick_items(W, H):
                w, h, d = f.metrics(label)
                ylabs.append((left - w, y - h / 2, left, y + h / 2))
            boxes += ylabs
            lab_left = min([b[0] for b in ylabs] + [x0 - TICK_LEN * px])
            if self.ylabel:
                w, h, d = f.metrics(self.ylabel)
                right = lab_left - LABEL_PAD * px
                boxes.append((right - h, (y0 + y1) / 2 - w / 2, right,
                              (y0 + y1) / 2 + w / 2))
        if self.title:
            f = raster.font(12, dpi)
            w, h, d = f.metrics(self.title)
            bottom = y0 - TITLE_PAD * px
            boxes.append(((x0 + x1) / 2 - w / 2, bottom - h,
                          (x0 + x1) / 2 + w / 2, bottom))
        return boxes

    def _xtick_items(self, W, H):
        """(pixel x, label, font, rotation, ha) of each visible x tick."""
        dpi = W / self.figure.figsize[0]
        tx, _ = self._trans(W, H)
        x0, _, x1, _ = self._box_px(W, H)
        ticks = self.get_xticks()
        lo, hi = sorted(self.get_xlim())
        if self._xticklabels is not None and self._xticks is not None:
            labels = self._xticklabels
            fs = float(self._xticklabel_kw.get("fontsize", FONT_PT))
            rot = float(self._xticklabel_kw.get("rotation", 0))
            ha = self._xticklabel_kw.get("ha", "center")
        else:
            labels = _format_ticks(np.asarray(ticks), self.xscale == "log")
            fs, rot, ha = FONT_PT, 0.0, "center"
        fnt = raster.font(fs, dpi)
        out = []
        for t, lab in zip(ticks, labels):
            if _visible(t, lo, hi, self.xscale == "log"):
                out.append((float(tx(t)), lab, fnt, rot, ha))
        return out

    def _ytick_items(self, W, H):
        _, ty = self._trans(W, H)
        ticks = self.get_yticks()
        lo, hi = sorted(self.get_ylim())
        labels = _format_ticks(np.asarray(ticks), False)
        return [(float(ty(t)), lab) for t, lab in zip(ticks, labels)
                if _visible(t, lo, hi, False)]


def _visible(t, lo, hi, log):
    if log:
        if t <= 0:
            return False
        a, b, v = math.log10(lo), math.log10(hi), math.log10(t)
    else:
        a, b, v = lo, hi, t
    tol = 1e-10 * max(abs(b - a), 1e-300)
    return a - tol <= v <= b + tol


def _text_box(x, y, w, h, rot, ha, va):
    """The extent of a w x h text box anchored at (x, y) (y down), turned
    by rot degrees, aligned as matplotlib's rotation_mode "default"."""
    if rot:
        t = math.radians(rot)
        bw = w * abs(math.cos(t)) + h * abs(math.sin(t))
        bh = w * abs(math.sin(t)) + h * abs(math.cos(t))
    else:
        bw, bh = w, h
    x0 = {"left": x, "center": x - bw / 2, "right": x - bw}[ha]
    y0 = {"top": y, "center": y - bh / 2, "bottom": y - bh}[va]
    return (x0, y0, x0 + bw, y0 + bh)


class Colorbar:
    def __init__(self, fig, mappable, parents, shrink, label):
        self.mappable, self.parents = mappable, parents
        self.shrink, self.label = float(shrink), str(label or "")
        self.fraction, self.pad, self.aspect = 0.15, 0.05, 20.0
        self.ax = Axes(fig, parents[0].cell)
        self.ax.colorbar_of = self
        self.ax._auto = [False, False]
        vmin, vmax = mappable.vmin, mappable.vmax
        self.ax._viewlim = [[0.0, 1.0], nonsingular(vmin, vmax,
                                                    expander=0.1)]


class Figure:
    """matplotlib's Figure for the calls the figures make."""

    def __init__(self, figsize=None, dpi=None):
        self.figsize = tuple(float(v) for v in (figsize or FIGSIZE))
        self.dpi = float(dpi or DPI)
        self.calls: List[tuple] = []
        self.axes: List[Axes] = []
        self.colorbars: List[Colorbar] = []
        self.subplotpars = dict(SUBPLOT)
        self._suptitle = ""
        self.grid_shape = (1, 1)
        self.text_boxes: List[tuple] = []     # the last save's text boxes

    def _cell_box(self, cell):
        nrows, ncols, r, c = cell
        p = self.subplotpars
        W = p["right"] - p["left"]
        H = p["top"] - p["bottom"]
        cw = W / (ncols + p["wspace"] * (ncols - 1))
        ch = H / (nrows + p["hspace"] * (nrows - 1))
        x0 = p["left"] + c * cw * (1 + p["wspace"])
        y1 = p["top"] - r * ch * (1 + p["hspace"])
        return (x0, y1 - ch, x0 + cw, y1)

    def _relayout(self):
        """Every axes back to its cell, then each colorbar takes its
        share of its parents."""
        for ax in self.axes:
            ax.position = self._cell_box(ax.cell)
        for cb in self.colorbars:
            boxes = [p.position for p in cb.parents]
            pb = (min(b[0] for b in boxes), min(b[1] for b in boxes),
                  max(b[2] for b in boxes), max(b[3] for b in boxes))
            w = pb[2] - pb[0]
            main_x1 = pb[0] + (1 - cb.fraction - cb.pad) * w
            for p in cb.parents:
                x0, y0, x1, y1 = p.position
                sx = (main_x1 - pb[0]) / w
                p.position = (pb[0] + (x0 - pb[0]) * sx, y0,
                              pb[0] + (x1 - pb[0]) * sx, y1)
                p._panchor_x = 1.0
            cx0 = pb[0] + (1 - cb.fraction) * w
            hh = (pb[3] - pb[1]) * cb.shrink
            cy0 = pb[1] + (pb[3] - pb[1] - hh) / 2
            cb.ax.position = (cx0, cy0, pb[2], cy0 + hh)

    def suptitle(self, t, **kwargs):
        self.calls.append(("suptitle", (t,), kwargs))
        self._suptitle = str(t)

    def colorbar(self, *args, **kwargs):
        self.calls.append(("colorbar", args, kwargs))
        return self._colorbar(*args, **kwargs)

    def _colorbar(self, mappable, ax=None, shrink=1.0, label=""):
        if isinstance(ax, Axes):
            parents = [ax]
        else:
            parents = list(np.asarray(ax, object).ravel())
        cb = Colorbar(self, mappable, parents, shrink, label)
        self.colorbars.append(cb)
        self._relayout()
        return cb

    def tight_layout(self, *args, **kwargs):
        """matplotlib's tight_layout: each subplot group's decorations
        (its colorbars' too) decide the subplot parameters."""
        self.calls.append(("tight_layout", args, kwargs))
        self._tight_layout(*args, **kwargs)

    def _tight_layout(self, pad=1.08):
        W, H = self.figsize[0] * self.dpi, self.figsize[1] * self.dpi
        nrows, ncols = self.grid_shape
        hs = np.zeros((nrows, ncols + 1))
        vs = np.zeros((nrows + 1, ncols))
        for ax in self.axes:
            _, _, r, c = ax.cell
            cell = self._cell_box(ax.cell)
            group = [ax] + [cb.ax for cb in self.colorbars
                            if ax in cb.parents]
            boxes = []
            for g in group:
                boxes.append(g._box_px(W, H))
                boxes += g._decor_boxes(W, H, self.dpi)
                if g.colorbar_of is not None:
                    boxes += self._colorbar_decor(g.colorbar_of, W, H,
                                                  self.dpi)
            tx0 = min(b[0] for b in boxes) / W
            tx1 = max(b[2] for b in boxes) / W
            ty1 = 1 - min(b[1] for b in boxes) / H
            ty0 = 1 - max(b[3] for b in boxes) / H
            hs[r, c] += cell[0] - tx0
            hs[r, c + 1] += tx1 - cell[2]
            vs[r, c] += ty1 - cell[3]
            vs[r + 1, c] += cell[1] - ty0
        fw, fh = self.figsize
        pad_in = pad * FONT_PT / 72
        left = max(hs[:, 0].max(), 0) + pad_in / fw
        right = max(hs[:, -1].max(), 0) + pad_in / fw
        top = max(vs[0, :].max(), 0) + pad_in / fh
        bottom = max(vs[-1, :].max(), 0) + pad_in / fh
        if self._suptitle:
            _, h, _ = raster.font(12, self.dpi).metrics(self._suptitle)
            top += h / H + pad_in / fh
        if left + right >= 1 or top + bottom >= 1:
            return
        p = dict(left=left, right=1 - right, bottom=bottom, top=1 - top,
                 wspace=self.subplotpars["wspace"],
                 hspace=self.subplotpars["hspace"])
        if ncols > 1:
            hspace = hs[:, 1:-1].max() + pad_in / fw
            h_axes = (1 - right - left - hspace * (ncols - 1)) / ncols
            if h_axes > 0:
                p["wspace"] = hspace / h_axes
        if nrows > 1:
            vspace = vs[1:-1, :].max() + pad_in / fh
            v_axes = (1 - top - bottom - vspace * (nrows - 1)) / nrows
            if v_axes > 0:
                p["hspace"] = vspace / v_axes
        self.subplotpars = p
        self._relayout()

    def _colorbar_decor(self, cb, W, H, dpi):
        x0, y0, x1, y1 = cb.ax._box_px(W, H)
        px = dpi / 72.0
        f = raster.font(FONT_PT, dpi)
        boxes = []
        left = x1 + (TICK_LEN + TICK_PAD) * px
        right = left
        for y, lab in self._cbar_ticks(cb, y0, y1):
            w, h, d = f.metrics(lab)
            boxes.append((left, y - h / 2, left + w, y + h / 2))
            right = max(right, left + w)
        if cb.label:
            w, h, d = f.metrics(cb.label)
            l0 = right + LABEL_PAD * px
            boxes.append((l0, (y0 + y1) / 2 - w / 2, l0 + h,
                          (y0 + y1) / 2 + w / 2))
        return boxes

    def _cbar_ticks(self, cb, y0, y1):
        lo, hi = cb.ax._viewlim[1]
        nb = int(np.clip(np.floor((y1 - y0) / self.dpi * 72 / 20), 1, 9))
        ticks = tick_values(lo, hi, nb)
        ticks = [t for t in ticks if _visible(t, lo, hi, False)]
        labels = _format_ticks(np.asarray(ticks), False)
        return [(y1 - (t - lo) / (hi - lo) * (y1 - y0), lab)
                for t, lab in zip(ticks, labels)]

    # -- drawing --
    def render(self, dpi: float, tight: bool = False) -> np.ndarray:
        """The figure as (H, W, 3) uint8 at `dpi`; `tight` crops (or
        grows) it to what is drawn plus 0.1 in, as bbox_inches="tight"."""
        W = int(round(self.figsize[0] * dpi))
        H = int(round(self.figsize[1] * dpi))
        pad = int(round(0.25 * max(W, H))) if tight else 0
        canvas = raster.Canvas(W + 2 * pad, H + 2 * pad)
        self.text_boxes = []
        drawn = []
        for ax in self.axes:
            drawn += _draw_axes(canvas, ax, W, H, dpi, pad, self.text_boxes)
        for cb in self.colorbars:
            drawn += _draw_colorbar(canvas, self, cb, W, H, dpi, pad,
                                    self.text_boxes)
        if self._suptitle:
            f = raster.font(12, dpi)
            box = canvas.draw_text(self._suptitle, pad + W / 2,
                                   pad + 0.02 * H, f, ha="center", va="top")
            self.text_boxes.append(box)
            drawn.append(box)
        img = canvas.img
        if tight:
            x0 = min(b[0] for b in drawn)
            y0 = min(b[1] for b in drawn)
            x1 = max(b[2] for b in drawn)
            y1 = max(b[3] for b in drawn)
            p = 0.1 * dpi
            c0, r0 = int(math.floor(x0 - p)), int(math.floor(y0 - p))
            c1, r1 = int(math.ceil(x1 + p)), int(math.ceil(y1 + p))
            c0, r0 = max(c0, 0), max(r0, 0)
            img = img[r0:r1, c0:c1]
            self.text_boxes = [(b[0] - c0, b[1] - r0, b[2] - c0, b[3] - r0)
                               for b in self.text_boxes]
        return np.ascontiguousarray(img)

    def savefig(self, *args, **kwargs):
        self.calls.append(("savefig", args, kwargs))
        return self._savefig(*args, **kwargs)

    def _savefig(self, path, dpi=None, bbox_inches=None):
        path = os.fspath(path)
        ext = os.path.splitext(path)[1].lower()
        img = self.render(float(dpi or self.dpi), bbox_inches == "tight")
        if ext == ".png":
            from ..data.image_io import write_png
            write_png(path, img)
        elif ext == ".pdf":
            d = float(dpi or self.dpi)
            write_pdf(path, img, img.shape[1] / d * 72, img.shape[0] / d * 72)
        else:
            raise ValueError(f"{path}: only .png and .pdf are written")
        return path


def _draw_axes(canvas, ax: Axes, W, H, dpi, pad, text_boxes):
    """Draw one axes; returns the extents drawn (for a tight box)."""
    px = dpi / 72.0
    x0, y0, x1, y1 = ax._box_px(W, H)
    X0, Y0, X1, Y1 = x0 + pad, y0 + pad, x1 + pad, y1 + pad
    drawn = [(X0, Y0, X1, Y1)]
    tx, ty = ax._trans(W, H)

    def TX(v):
        return tx(v) + pad

    def TY(v):
        return ty(v) + pad
    lw = max(1.0, round(0.8 * px))
    if ax._grid and ax._axis_on:
        for xp, *_ in ax._xtick_items(W, H):
            canvas.polyline([xp + pad] * 2, [Y0, Y1], GRID, lw)
        for yp, _ in ax._ytick_items(W, H):
            canvas.polyline([X0, X1], [yp + pad] * 2, GRID, lw)
    # the artists are clipped to the axes box: drawn on a copy of it
    r0, c0 = max(int(round(Y0)), 0), max(int(round(X0)), 0)
    r1, c1 = int(round(Y1)), int(round(X1))
    if r1 > r0 and c1 > c0:
        sub = raster.Canvas.of(canvas.img[r0:r1, c0:c1].copy())
        for a in ax.artists:
            _draw_artist(sub, a, lambda v: TX(v) - c0, lambda v: TY(v) - r0,
                         X0 - c0, X1 - c0, px)
        canvas.img[r0:r1, c0:c1] = sub.img
    if ax._axis_on:
        for xs, ys in (([X0, X1], [Y0, Y0]), ([X0, X1], [Y1, Y1]),
                       ([X0, X0], [Y0, Y1]), ([X1, X1], [Y0, Y1])):
            canvas.polyline(xs, ys, (0, 0, 0), lw)
        f = raster.font(FONT_PT, dpi)
        for xp, label, fnt, rot, ha in ax._xtick_items(W, H):
            canvas.polyline([xp + pad] * 2, [Y1, Y1 + TICK_LEN * px],
                            (0, 0, 0), lw)
            top = Y1 + (TICK_LEN + TICK_PAD) * px
            box = canvas.draw_text(label, xp + pad, top, fnt, ha=ha,
                                   va="top", rotation=rot)
            text_boxes.append(box)
            drawn.append(box)
        for yp, label in ax._ytick_items(W, H):
            canvas.polyline([X0 - TICK_LEN * px, X0], [yp + pad] * 2,
                            (0, 0, 0), lw)
            box = canvas.draw_text(label, X0 - (TICK_LEN + TICK_PAD) * px,
                                   yp + pad, f, ha="right", va="center")
            text_boxes.append(box)
            drawn.append(box)
        lab_bottom = max([b[3] for b in drawn[1:]] + [Y1 + TICK_LEN * px])
        if ax.xlabel:
            box = canvas.draw_text(ax.xlabel, (X0 + X1) / 2,
                                   lab_bottom + LABEL_PAD * px, f,
                                   ha="center", va="top")
            text_boxes.append(box)
            drawn.append(box)
        ylabs = [b for b in drawn[1:] if b[2] <= X0 + 0.5]
        lab_left = min([b[0] for b in ylabs] + [X0 - TICK_LEN * px])
        if ax.ylabel:
            box = canvas.draw_text(ax.ylabel, lab_left - LABEL_PAD * px,
                                   (Y0 + Y1) / 2, f, ha="right",
                                   va="center", rotation=90)
            text_boxes.append(box)
            drawn.append(box)
    if ax.title:
        box = canvas.draw_text(ax.title, (X0 + X1) / 2,
                               Y0 - TITLE_PAD * px, raster.font(12, dpi),
                               ha="center", va="bottom")
        text_boxes.append(box)
        drawn.append(box)
    if ax._legend is not None:
        box = _draw_legend(canvas, ax, TX, TY, (X0, Y0, X1, Y1), dpi)
        if box is not None:
            text_boxes.append(box)
            drawn.append(box)
    if not ax._axis_on:
        drawn = [(X0, Y0, X1, Y1)] + [b for b in drawn[1:]]
    return drawn


def _draw_artist(canvas, a: _Artist, TX, TY, X0, X1, px):
    if a.kind == "image":
        z = a.z
        h, w = z.shape
        cols = raster.colormap(z, a.cmap, a.vmin, a.vmax)
        xs = TX(np.arange(w + 1) - 0.5)
        ys = TY(np.arange(h + 1) - 0.5)
        ch, cw = canvas.shape
        c0 = int(max(np.floor(min(xs[0], xs[-1])), 0))
        c1 = int(min(np.ceil(max(xs[0], xs[-1])), cw))
        r0 = int(max(np.floor(min(ys[0], ys[-1])), 0))
        r1 = int(min(np.ceil(max(ys[0], ys[-1])), ch))
        if c0 >= c1 or r0 >= r1:
            return
        cx = np.arange(c0, c1) + 0.5
        cy = np.arange(r0, r1) + 0.5
        ix = np.floor((cx - xs[0]) / (xs[-1] - xs[0]) * w).astype(int)
        iy = np.floor((cy - ys[0]) / (ys[-1] - ys[0]) * h).astype(int)
        # the sample indices are monotonic: the rows and columns inside
        # the image are one run each
        okx = np.flatnonzero((ix >= 0) & (ix < w))
        oky = np.flatnonzero((iy >= 0) & (iy < h))
        if not len(okx) or not len(oky):
            return
        a0, a1, b0, b1 = oky[0], oky[-1] + 1, okx[0], okx[-1] + 1
        canvas.img[r0 + a0:r0 + a1, c0 + b0:c0 + b1] = \
            cols[iy[a0:a1]][:, ix[b0:b1]]
    elif a.kind == "rect":
        canvas.fill_rect(TX(a.x0), TY(a.y0), TX(a.x1), TY(a.y1), a.color)
    elif a.kind == "errorbar":
        lw = max(1.0, LINE_W * px)
        for x, lo, hi in zip(a.x, a.lo, a.hi):
            canvas.polyline([TX(x)] * 2, [TY(lo), TY(hi)], a.color, lw)
            if a.cap:
                for v in (lo, hi):
                    canvas.marker(float(TX(x)), float(TY(v)), "_",
                                  2 * a.cap * px, a.color, width=lw)
    elif a.kind == "hline":
        canvas.polyline([X0, X1], [TY(a.y)] * 2, a.color,
                        max(1.0, LINE_W * px), a.alpha,
                        [d * LINE_W * px for d in DASHES[a.ls or "-"]])
    elif a.kind == "line":
        xs, ys = TX(a.x), TY(a.y)
        if a.ls and a.ls != "None":
            canvas.polyline(xs, ys, a.color, max(1.0, LINE_W * px), a.alpha,
                            [d * LINE_W * px for d in DASHES[a.ls]])
        if a.marker:
            for x, y in zip(xs, ys):
                if np.isfinite(x) and np.isfinite(y):
                    canvas.marker(float(x), float(y), _mk(a.marker),
                                  a.ms * px, a.color, a.alpha,
                                  width=max(1.0, EDGE_W * px))
    elif a.kind == "scatter":
        d = math.sqrt(a.size) * px
        for x, y, c in zip(TX(a.x), TY(a.y), a.colors):
            if np.isfinite(x) and np.isfinite(y):
                canvas.marker(float(x), float(y), _mk(a.marker), d, c,
                              a.alpha, width=max(1.0, LINE_W * px))


def _mk(marker):
    return "o" if marker == "." else marker


def _legend_entries(ax):
    out = []
    for a in ax.artists:
        lab = a.get_label()
        if lab is None or str(lab).startswith("_"):
            continue
        out.append((str(lab), a))
    return out


def _draw_legend(canvas, ax, TX, TY, box, dpi):
    entries = _legend_entries(ax)
    if not entries:
        return None
    fs = float(ax._legend.get("fontsize", FONT_PT))
    f = raster.font(fs, dpi)
    px = dpi / 72.0
    em = fs * px
    sizes = [f.metrics(lab) for lab, _ in entries]
    row_h = max(max(s[1] for s in sizes), f.lp_h)
    handle_w = 2.0 * em
    width = 0.4 * em * 2 + handle_w + 0.8 * em + max(s[0] for s in sizes)
    height = 0.4 * em * 2 + len(entries) * row_h + (len(entries) - 1) * \
        0.5 * em
    X0, Y0, X1, Y1 = box
    m = 0.5 * em
    places = {
        "upper right": (X1 - m - width, Y0 + m),
        "upper left": (X0 + m, Y0 + m),
        "lower left": (X0 + m, Y1 - m - height),
        "lower right": (X1 - m - width, Y1 - m - height),
        "right": (X1 - m - width, (Y0 + Y1 - height) / 2),
        "center left": (X0 + m, (Y0 + Y1 - height) / 2),
        "center right": (X1 - m - width, (Y0 + Y1 - height) / 2),
        "lower center": ((X0 + X1 - width) / 2, Y1 - m - height),
        "upper center": ((X0 + X1 - width) / 2, Y0 + m),
        "center": ((X0 + X1 - width) / 2, (Y0 + Y1 - height) / 2)}
    loc = ax._legend.get("loc", "best")
    if loc in (0, "best", None):
        pts = []
        for a in ax.artists:
            if a.kind in ("line", "scatter"):
                pts.append(np.stack([TX(a.x), TY(a.y)], 1))
            elif a.kind == "rect":
                pts.append(np.array([[TX(a.x0), TY(a.y1)],
                                     [TX(a.x1), TY(a.y1)]]))
        pts = np.concatenate(pts) if pts else np.zeros((0, 2))
        best, bad = None, None
        for name, (lx, ly) in places.items():
            inside = ((pts[:, 0] >= lx) & (pts[:, 0] <= lx + width)
                      & (pts[:, 1] >= ly) & (pts[:, 1] <= ly + height)).sum()
            if bad is None or inside < bad:
                best, bad = name, inside
        loc = best
    lx, ly = places[loc]
    canvas.fill_rect(lx, ly, lx + width, ly + height, (255, 255, 255), 0.8)
    frame = (204, 204, 204)
    lw = max(1.0, round(0.8 * px))
    canvas.polyline([lx, lx + width, lx + width, lx, lx],
                    [ly, ly, ly + height, ly + height, ly], frame, lw)
    y = ly + 0.4 * em
    for (lab, a), (w, h, d) in zip(entries, sizes):
        cy = y + row_h / 2
        hx0 = lx + 0.4 * em
        if a.kind in ("line", "hline"):
            if a.kind == "hline" or (a.ls and a.ls != "None"):
                canvas.polyline([hx0, hx0 + handle_w], [cy, cy], a.color,
                                max(1.0, LINE_W * px), a.alpha,
                                [v * LINE_W * px for v in DASHES[a.ls or "-"]])
            if a.marker:
                canvas.marker(hx0 + handle_w / 2, cy, _mk(a.marker),
                              a.ms * px, a.color, a.alpha,
                              width=max(1.0, EDGE_W * px))
        elif a.kind == "scatter":
            canvas.marker(hx0 + handle_w / 2, cy, _mk(a.marker),
                          math.sqrt(a.size) * px, a.colors[0], a.alpha,
                          width=max(1.0, LINE_W * px))
        canvas.draw_text(lab, hx0 + handle_w + 0.8 * em, cy, f, ha="left",
                         va="center")
        y += row_h + 0.5 * em
    return (lx, ly, lx + width, ly + height)


def _draw_colorbar(canvas, fig, cb, W, H, dpi, pad, text_boxes):
    x0, y0, x1, y1 = cb.ax._box_px(W, H)
    X0, Y0, X1, Y1 = x0 + pad, y0 + pad, x1 + pad, y1 + pad
    lo, hi = cb.ax._viewlim[1]
    r0, r1 = int(round(Y0)), int(round(Y1))
    c0, c1 = int(round(X0)), int(round(X1))
    if r1 > r0 and c1 > c0:
        vals = hi - (np.arange(r0, r1) + 0.5 - Y0) / (Y1 - Y0) * (hi - lo)
        cols = raster.colormap(vals, cb.mappable.cmap, cb.mappable.vmin,
                               cb.mappable.vmax)
        canvas.img[max(r0, 0):r1, max(c0, 0):c1] = \
            cols[max(-r0, 0):, None, :]
    px = dpi / 72.0
    lw = max(1.0, round(0.8 * px))
    canvas.polyline([X0, X1, X1, X0, X0], [Y0, Y0, Y1, Y1, Y0], (0, 0, 0), lw)
    f = raster.font(FONT_PT, dpi)
    drawn = [(X0, Y0, X1, Y1)]
    right = X1 + (TICK_LEN + TICK_PAD) * px
    for y, lab in fig._cbar_ticks(cb, Y0, Y1):
        canvas.polyline([X1, X1 + TICK_LEN * px], [y, y], (0, 0, 0), lw)
        box = canvas.draw_text(lab, X1 + (TICK_LEN + TICK_PAD) * px, y, f,
                               ha="left", va="center")
        text_boxes.append(box)
        drawn.append(box)
        right = max(right, box[2])
    if cb.label:
        box = canvas.draw_text(cb.label, right + LABEL_PAD * px,
                               (Y0 + Y1) / 2, f, ha="left", va="center",
                               rotation=90)
        text_boxes.append(box)
        drawn.append(box)
    return drawn


def write_pdf(path, rgb: np.ndarray, width_pt: float, height_pt: float):
    """A one-page PDF: the (H, W, 3) uint8 image as a Flate-compressed
    DeviceRGB image XObject filling a width_pt x height_pt MediaBox."""
    h, w = rgb.shape[:2]
    data = zlib.compress(np.ascontiguousarray(rgb, np.uint8).tobytes())
    content = (f"q {width_pt:.4f} 0 0 {height_pt:.4f} 0 0 cm /Im0 Do Q"
               ).encode()
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {width_pt:.4f} "
         f"{height_pt:.4f}] /Resources << /XObject << /Im0 5 0 R >> >> "
         f"/Contents 4 0 R >>").encode(),
        b"<< /Length %d >>\nstream\n" % len(content) + content
        + b"\nendstream",
        (f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
         f"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode "
         f"/Length {len(data)} >>\nstream\n").encode() + data
        + b"\nendstream",
    ]
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, xref))
    with open(path, "wb") as fh:
        fh.write(bytes(out))


# ---- pyplot's two calls --------------------------------------------------------

def subplots(*args, **kwargs):
    """matplotlib.pyplot.subplots: (Figure, Axes or an object array of
    them)."""
    return _subplots(("subplots", args, kwargs), *args, **kwargs)


def _subplots(call, nrows: int = 1, ncols: int = 1, figsize=None,
              squeeze=True):
    fig = Figure(figsize=figsize)
    fig.calls.append(call)
    fig.grid_shape = (nrows, ncols)
    arr = np.empty((nrows, ncols), object)
    for r in range(nrows):
        for c in range(ncols):
            ax = Axes(fig, (nrows, ncols, r, c))
            fig.axes.append(ax)
            arr[r, c] = ax
    if squeeze:
        if arr.size == 1:
            return fig, arr[0, 0]
        return fig, arr.squeeze()
    return fig, arr


def close(fig: Figure) -> None:
    """pyplot.close: nothing is held open."""
