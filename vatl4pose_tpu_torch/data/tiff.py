"""TIFF files without cv2 and PIL: one parse, two views (for
data/image_io.py).

The first IFD of a little- or big-endian file, wherever the file puts it;
strips or tiles; chunky samples (PlanarConfiguration 1); Compression 1
(none), 5 (LZW) and 32773 (PackBits) through data/image_codecs.py, 8 and
32946 (Deflate) through zlib; Predictor 1 or 2.  Photometric 0 and 1 at 1
or 8 bits (with an alpha sample at 8), 2 (RGB, RGBA through
ExtraSamples), 3 (an 8-bit palette with its 16-bit ColorMap) and 5 (CMYK),
at 8 bits a sample.

* `decode_cv2`: (H, W, 3) uint8 RGB, what cv2.imread(path, IMREAD_COLOR)
  and BGR->RGB give: OpenCV reads 8-bit TIFFs through libtiff's
  TIFFRGBAImage (tif_getimage.c), so WhiteIsZero is inverted, an
  unassociated alpha (ExtraSamples 2) is premultiplied,
  (c * a + 127) // 255, then dropped; a ColorMap with any entry above 255
  is taken >> 8, else as it is; CMYK becomes
  (255 - K) * (255 - C) // 255 ...
* `decode_pil`: (mode, pixels, palette) as PIL's Image.open gives them
  (TiffImagePlugin's OPEN_INFO): "1", "L", "LA", "P" (the ColorMap // 256),
  "RGB", "RGBA" (an associated alpha unpremultiplied) or "CMYK".

Any other field value raises ValueError naming the file and the field,
for example "TIFF Compression=7".
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

__all__ = ["size_from_file", "decode_cv2", "decode_pil"]

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i"}
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILLORDER, _STRIPS, _ORIENTATION, _SPP, _ROWS = 266, 273, 274, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _COLORMAP = 279, 284, 317, 320
_TILE_W, _TILE_L, _TILES, _TILE_BYTES = 322, 323, 324, 325
_INKSET, _EXTRA, _SAMPLEFORMAT = 332, 338, 339
_NAMES = {_BITS: "BitsPerSample", _COMPRESSION: "Compression",
          _PHOTOMETRIC: "PhotometricInterpretation", _FILLORDER: "FillOrder",
          _ORIENTATION: "Orientation", _SPP: "SamplesPerPixel",
          _PLANAR: "PlanarConfiguration", _PREDICTOR: "Predictor",
          _INKSET: "InkSet", _EXTRA: "ExtraSamples",
          _SAMPLEFORMAT: "SampleFormat"}


def _refuse(path, tag, value):
    if isinstance(value, tuple) and len(value) == 1:
        value = value[0]
    raise ValueError(f"{path}: TIFF {_NAMES.get(tag, tag)}={value} is not "
                     f"supported")


def _ifd(read, path) -> Tuple[str, Dict[int, tuple]]:
    """The byte order and the first IFD's tags, each a tuple of values;
    `read(offset, n)` gives the file's n bytes at offset (fewer at its
    end), so only the header and the IFD are read."""
    head = read(0, 8)
    if head[:4] == b"II*\0":
        order = "<"
    elif head[:4] == b"MM\0*":
        order = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    if len(head) < 8:
        raise ValueError(f"{path}: truncated TIFF header")
    pos = struct.unpack_from(order + "I", head, 4)[0]
    count = read(pos, 2)
    if len(count) < 2:
        raise ValueError(f"{path}: TIFF IFD offset {pos} past the file's end")
    count = struct.unpack(order + "H", count)[0]
    entries = read(pos + 2, 12 * count)
    if len(entries) < 12 * count:
        raise ValueError(f"{path}: truncated TIFF IFD")
    tags = {}
    for i in range(count):
        tag, typ, n, value = struct.unpack_from(order + "HHI4s", entries,
                                                12 * i)
        if typ not in _TYPES:
            continue                  # rationals, floats, ...: not needed
        fmt = _TYPES[typ]
        nbytes = struct.calcsize(fmt) * n
        if nbytes > 4:
            value = read(struct.unpack(order + "I", value)[0], nbytes)
            if len(value) < nbytes:
                raise ValueError(f"{path}: TIFF tag {tag} past the file's "
                                 f"end")
        tags[tag] = struct.unpack_from(f"{order}{n}{fmt}", value)
    return order, tags


def _sides(tags, path) -> Tuple[int, int]:
    if _WIDTH not in tags or _LENGTH not in tags:
        raise ValueError(f"{path}: TIFF without ImageWidth or ImageLength")
    return int(tags[_WIDTH][0]), int(tags[_LENGTH][0])


def size_from_file(f, path) -> Tuple[int, int]:
    """(width, height) from the first IFD of the open binary file `f`."""
    def read(offset, n):
        f.seek(offset)
        return f.read(n)
    return _sides(_ifd(read, path)[1], path)


class _Image:
    """The first IFD's samples: `px` (H, W, spp) uint8, or (H, W) of 0/1
    at 1 bit, plus the fields the views read."""

    def __init__(self, data: bytes, path):
        _, tags = _ifd(lambda offset, n: data[offset:offset + n], path)
        self.path = path
        get = tags.get
        self.width, self.height = _sides(tags, path)
        self.spp = get(_SPP, (1,))[0]
        bits = get(_BITS, (1,))
        if len(set(bits)) != 1 or bits[0] not in (1, 8):
            _refuse(path, _BITS, bits)
        self.bits = bits[0]
        self.photometric = get(_PHOTOMETRIC, (None,))[0]
        self.extra = get(_EXTRA, ())
        self.colormap = get(_COLORMAP, None)
        compression = get(_COMPRESSION, (1,))[0]
        predictor = get(_PREDICTOR, (1,))[0]
        for tag, ok in ((_COMPRESSION, (1, 5, 8, 32773, 32946)),
                        (_PLANAR, (1,)), (_FILLORDER, (1,)),
                        (_ORIENTATION, (1,)), (_PREDICTOR, (1, 2)),
                        (_SAMPLEFORMAT, (1,)), (_INKSET, (1,))):
            if tag in tags and any(v not in ok for v in tags[tag]):
                _refuse(path, tag, tags[tag])
        kinds = {0: (1, 2), 1: (1, 2), 2: (3, 4), 3: (1,), 5: (4,)}
        if self.photometric not in kinds:
            _refuse(path, _PHOTOMETRIC, self.photometric)
        if self.spp not in kinds[self.photometric]:
            _refuse(path, _SPP, self.spp)
        if self.bits == 1 and (self.spp != 1 or self.photometric > 1):
            _refuse(path, _BITS, bits)
        base = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4}[self.photometric]
        extra_ok = {2: [(2,)], 4: [(), (0,), (1,), (2,)]}.get(self.spp, [()])
        if self.spp - base != len(self.extra) and self.extra != () \
                or self.extra not in extra_ok:
            _refuse(path, _EXTRA, self.extra or "none")
        if self.photometric == 3 and (
                self.colormap is None or len(self.colormap) != 3 * 256):
            raise ValueError(f"{path}: TIFF palette image without a "
                             f"256-entry ColorMap")
        if predictor == 2 and self.bits != 8:
            _refuse(path, _PREDICTOR, predictor)
        if _TILES in tags:
            tw, tl = get(_TILE_W, (0,))[0], get(_TILE_L, (0,))[0]
            offsets, counts = tags[_TILES], get(_TILE_BYTES, ())
        else:
            tw = self.width
            tl = min(get(_ROWS, (2 ** 32 - 1,))[0], self.height)
            offsets, counts = get(_STRIPS, ()), get(_STRIP_BYTES, ())
        if tw <= 0 or tl <= 0 or len(counts) != len(offsets):
            raise ValueError(f"{path}: TIFF without a valid strip or tile "
                             f"layout")
        stride = (tw * self.spp * self.bits + 7) // 8
        across = -(-self.width // tw)
        down = -(-self.height // tl)
        if len(offsets) != across * down:
            raise ValueError(f"{path}: TIFF has {len(offsets)} strips or "
                             f"tiles, not {across * down}")
        full = np.zeros((down * tl, across * stride), np.uint8)
        for i, (off, n) in enumerate(zip(offsets, counts)):
            r, c = divmod(i, across)
            rows = tl if _TILES in tags else min(tl, self.height - r * tl)
            chunk = self._decompress(compression, data[off:off + n],
                                     rows * stride)
            block = np.frombuffer(chunk, np.uint8).reshape(rows, stride)
            if predictor == 2:
                block = np.cumsum(block.reshape(rows, tw, self.spp), axis=1,
                                  dtype=np.uint8).reshape(rows, stride)
            full[r * tl:r * tl + rows, c * stride:(c + 1) * stride] = block
        if self.bits == 1:
            bits_ = np.unpackbits(full.reshape(down * tl, across, stride),
                                  axis=2)[:, :, :tw]
            self.px = bits_.reshape(down * tl, across * tw)[
                :self.height, :self.width]
        else:
            self.px = full.reshape(down * tl, across * tw, self.spp)[
                :self.height, :self.width]

    def _decompress(self, method, raw, n):
        if method == 1:
            out = raw
        elif method in (8, 32946):
            try:
                out = zlib.decompress(raw)
            except zlib.error as e:
                raise ValueError(f"{self.path}: TIFF Compression={method}: "
                                 f"corrupt Deflate data ({e})") from None
        else:
            from .image_codecs import tiff_decompress
            return tiff_decompress(method, raw, n, self.path)
        if len(out) < n:
            raise ValueError(f"{self.path}: TIFF strip or tile of "
                             f"{len(out)} bytes, not {n}")
        return out[:n]


def decode_cv2(data: bytes, path) -> np.ndarray:
    im = _Image(data, path)
    px = im.px
    if im.photometric in (0, 1):
        gray = px if im.bits == 1 else px[..., 0]
        if im.bits == 1:
            gray = gray * np.uint8(255)
        if im.photometric == 0:
            gray = 255 - gray
        return np.repeat(gray[..., None], 3, axis=2)
    if im.photometric == 2:
        rgb = px[..., :3]
        if im.spp == 4 and im.extra == (2,):         # premultiplied
            a = px[..., 3:].astype(np.uint32)
            rgb = ((rgb * a + 127) // 255).astype(np.uint8)
        return np.ascontiguousarray(rgb)
    if im.photometric == 3:
        cmap = np.array(im.colormap, np.uint32).reshape(3, 256).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[px[..., 0]]
    k = 255 - px[..., 3:].astype(np.uint32)
    return ((255 - px[..., :3].astype(np.uint32)) * k // 255).astype(np.uint8)


def decode_pil(data: bytes, path):
    im = _Image(data, path)
    px = im.px
    if im.photometric in (0, 1):
        if im.bits == 1:
            return "1", (px == (im.photometric == 1)), None
        if im.spp == 2:
            if im.photometric == 0:
                _refuse(path, _PHOTOMETRIC, 0)
            return "LA", np.ascontiguousarray(px), None
        gray = px[..., 0]
        return "L", np.ascontiguousarray(
            255 - gray if im.photometric == 0 else gray), None
    if im.photometric == 2:
        if im.spp == 3 or im.extra == (0,):
            return "RGB", np.ascontiguousarray(px[..., :3]), None
        if im.extra == (1,):                 # associated: unpremultiplied
            a = px[..., 3:].astype(np.uint32)
            rgb = np.where(a == 0, 0, np.minimum(
                px[..., :3] * np.uint32(255) // np.maximum(a, 1), 255))
            px = np.concatenate([rgb, a], -1).astype(np.uint8)
            px[px[..., 3] == 0] = 0
        return "RGBA", np.ascontiguousarray(px), None
    if im.photometric == 3:
        cmap = np.array(im.colormap, np.uint32).reshape(3, 256).T // 256
        return "P", np.ascontiguousarray(px[..., 0]), cmap.astype(np.uint8)
    return "CMYK", np.ascontiguousarray(px), None
