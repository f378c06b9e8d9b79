"""Convert figure images in a directory to EPS (counterpart of
vatl4pose_tpu/cli/convert_to_eps.py; PIL, imported inside `main`; parity:
scripts/convert_to_eps.py — a 9-line PIL loop over docs/paper).

The reference opens every file in the directory blindly (and says "pdf
images", which PIL cannot read); this version converts the raster formats
PIL can actually load, skips the rest, and takes the directory as an
argument instead of hard-coding docs/paper.
"""

from __future__ import annotations

import argparse
import os

__all__ = ["RASTER_EXT", "main"]

RASTER_EXT = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def main(argv=None):
    p = argparse.ArgumentParser(description="figure -> EPS conversion")
    p.add_argument("--dir", default="docs/paper",
                   help="directory of figures (reference default)")
    args = p.parse_args(argv)
    from PIL import Image

    converted = []
    for fig in sorted(os.listdir(args.dir)):
        base, ext = os.path.splitext(fig)
        if ext.lower() not in RASTER_EXT:
            continue
        im = Image.open(os.path.join(args.dir, fig))
        if im.mode in ("RGBA", "P", "LA"):
            im = im.convert("RGB")     # EPS has no alpha channel
        out = os.path.join(args.dir, base + ".eps")
        im.save(out)
        converted.append(out)
    print(f"converted {len(converted)} figures to EPS in {args.dir}")
    return converted


if __name__ == "__main__":
    main()
