"""Convert figure images in a directory to EPS (counterpart of
vatl4pose_tpu/cli/convert_to_eps.py; parity: scripts/convert_to_eps.py —
a 9-line PIL loop over docs/paper), without PIL.

    python -m vatl4pose_tpu_torch.cli.convert_to_eps --dir FIGURES

The reference opens every file in the directory blindly (and says "pdf
images", which PIL cannot read); this version converts the raster formats
it can load, skips the rest, and takes the directory as an argument
instead of hard-coding docs/paper.  Files are read by
data/image_io.read_image_mode (PNG, JPEG, BMP and TIFF, the file's own
mode as PIL's Image.open gives it) and written by `write_eps`, byte for
byte what PIL's EpsImagePlugin writes: RGBA, P and LA are converted to RGB
first, as the JAX package's main does, L is written as `image`, CMYK as
`false 4 colorimage`; any other mode ("1", "I;16") raises
ValueError("image mode is not supported"), as PIL's writer does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.image_io import palette_to_rgb, read_image_mode

__all__ = ["RASTER_EXT", "write_eps", "main"]

RASTER_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
_LINE = 78                      # hex digits a line, as PIL's EpsEncode


def write_eps(path: str, mode: str, px: np.ndarray) -> None:
    """An L (H, W), RGB (H, W, 3) or CMYK (H, W, 4) uint8 image as PIL's
    EPS writer (EpsImagePlugin._save with eps=1) writes it."""
    if mode == "L":
        ch, op = 1, b"image"
    elif mode == "RGB":
        ch, op = 3, b"false 3 colorimage"
    elif mode == "CMYK":
        ch, op = 4, b"false 4 colorimage"
    else:
        raise ValueError("image mode is not supported")
    h, w = px.shape[:2]
    hexs = np.ascontiguousarray(px, np.uint8).tobytes().hex().encode()
    body = b"\n".join(hexs[i:i + _LINE] for i in range(0, len(hexs), _LINE))
    with open(path, "wb") as f:
        f.write(b"%!PS-Adobe-3.0 EPSF-3.0\n")
        f.write(b"%%Creator: PIL 0.1 EpsEncode\n")
        f.write(b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h))
        f.write(b"%%Pages: 1\n")
        f.write(b"%%EndComments\n")
        f.write(b"%%Page: 1 1\n")
        f.write(b"%%ImageData: %d %d " % (w, h))
        f.write(b'%d %d 0 1 1 "%s"\n' % (8, ch, op))
        f.write(b"gsave\n")
        f.write(b"10 dict begin\n")
        f.write(b"/buf %d string def\n" % (w * ch))
        f.write(b"%d %d scale\n" % (w, h))
        f.write(b"%d %d 8\n" % (w, h))
        f.write(b"[%d 0 0 -%d 0 %d]\n" % (w, h, h))
        f.write(b"{ currentfile buf readhexstring pop } bind\n")
        f.write(op + b"\n")
        f.write(body)
        f.write(b"\n%%%%EndBinary\n")
        f.write(b"grestore end\n")


def main(argv=None):
    p = argparse.ArgumentParser(description="figure -> EPS conversion")
    p.add_argument("--dir", default="docs/paper",
                   help="directory of figures (reference default)")
    args = p.parse_args(argv)

    converted = []
    for fig in sorted(os.listdir(args.dir)):
        base, ext = os.path.splitext(fig)
        if ext.lower() not in RASTER_EXT:
            continue
        mode, px, palette = read_image_mode(os.path.join(args.dir, fig))
        if mode == "P":
            mode, px = "RGB", palette_to_rgb(px, palette)
        elif mode == "LA":
            mode, px = "RGB", np.repeat(px[..., :1], 3, axis=2)
        elif mode == "RGBA":
            mode, px = "RGB", px[..., :3]      # EPS has no alpha channel
        out = os.path.join(args.dir, base + ".eps")
        write_eps(out, mode, px)
        converted.append(out)
    print(f"converted {len(converted)} figures to EPS in {args.dir}")
    return converted


if __name__ == "__main__":
    main()
