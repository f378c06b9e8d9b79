"""Write vatl4pose_tpu_torch/utils/figure_data.npz: the glyph bitmaps and
metrics of DejaVu Sans and the viridis and magma colour tables that the
port's figure layer (utils/figure.py, utils/raster.py) draws with.

    python scripts/make_figure_glyphs.py [dest.npz]

It needs matplotlib, and only here: the glyphs are rasterised once by
matplotlib's FreeType wrapper (ft2font) from the DejaVuSans.ttf that ships
in matplotlib's mpl-data, with matplotlib's Agg defaults (hinting factor 8,
forced autohinting, antialiasing), so the port reads no font file at run
time.  DejaVu's licence (utils/LICENSE_DEJAVU, copied beside the data)
permits redistributing the glyphs with its notice.  The colour tables are
matplotlib's `_cm_listed` data (CC0), as `cmap(np.arange(256),
bytes=True)` gives them.

Each (point size, dpi) the figures use gets, under the key prefix
"g{pt}_{dpi}_": `pix` (every glyph's 8-bit coverage, row-major, one after
the other), `meta` (a row a character: offset into pix, rows, cols, the
bitmap's x offset and descent in 1/64 px, the single-character text's
width and height in 1/64 px), `pair` (the ink width of each ordered
pair of characters in 1/64 px, which places the second glyph after the
first: pen advance and kerning together), plus `lp` (the width, height
and descent of "lp", matplotlib's least line height).
"""

import os
import sys

import numpy as np

CHARS = "".join(chr(c) for c in range(32, 127)) + "−"   # + minus
SIZES = [(pt, dpi) for pt in (7, 10, 12) for dpi in (100, 110, 140)]
DEST = os.path.join(os.path.dirname(__file__), os.pardir,
                    "vatl4pose_tpu_torch", "utils", "figure_data.npz")


def font():
    import matplotlib
    from matplotlib import ft2font
    path = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                        "fonts", "ttf", "DejaVuSans.ttf")
    return ft2font, ft2font.FT2Font(path, hinting_factor=8)


def build():
    ft2font, f = font()
    flags = ft2font.LoadFlags.FORCE_AUTOHINT
    out = {"chars": np.frombuffer(CHARS.encode("utf-32-le"), np.uint32)}

    def text(s):
        f.set_text(s, 0.0, flags=flags)
        f.draw_glyphs_to_bitmap(antialiased=True)
        w, h = f.get_width_height()
        return (np.array(f.get_image(), np.uint8), f.get_bitmap_offset()[0],
                f.get_descent(), w, h)

    for pt, dpi in SIZES:
        f.set_size(pt, dpi)
        key = f"g{pt}_{dpi}_"
        pix, meta = [], []
        for c in CHARS:
            img, xo, d, w, h = text(c)
            meta.append((sum(p.size for p in pix), img.shape[0],
                         img.shape[1], xo, d, w, h))
            pix.append(img.reshape(-1))
        # the ink width of every ordered pair: with the single widths it
        # places each glyph (pen advance and kerning together)
        pair = np.empty((len(CHARS), len(CHARS)), np.int32)
        for i, a in enumerate(CHARS):
            for j, b in enumerate(CHARS):
                f.set_text(a + b, 0.0, flags=flags)
                pair[i, j] = f.get_width_height()[0]
        out[key + "pix"] = np.concatenate(pix)
        out[key + "meta"] = np.array(meta, np.int32)
        out[key + "pair"] = pair
        _, _, d, w, h = text("lp")
        out[key + "lp"] = np.array([w, h, d], np.int32)
    from matplotlib import _cm_listed, colors
    for name in ("viridis", "magma"):
        cmap = colors.ListedColormap(getattr(_cm_listed, f"_{name}_data"))
        out[f"lut_{name}"] = cmap(np.arange(256), bytes=True)[:, :3]
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dest = argv[0] if argv else DEST
    np.savez_compressed(dest, **build())
    print(dest)


if __name__ == "__main__":
    main()
