"""BMP files without cv2 and PIL: one parse, two views (for
data/image_io.py).

* `decode_cv2`: (H, W, 3) uint8 RGB, what cv2.imread(path, IMREAD_COLOR)
  and BGR->RGB give (OpenCV's grfmt_bmp.cpp): palettes looked up (indices
  past the palette black), 16-bit 5-5-5 and 5-6-5 samples shifted up
  without replication, 32-bit pixels through their BI_BITFIELDS masks
  when the header (56 bytes or more) carries them, alpha dropped.  As in
  OpenCV, a 16-bit BI_BITFIELDS file takes its masks from the 12 bytes
  after the header, so a V4/V5 one raises.
* `decode_pil`: (mode, pixels, palette) as PIL's Image.open gives them
  (BmpImagePlugin): "1" or "L" when the palette is black and white or the
  identity grey ramp, else "P" with the palette; "RGB" for 16-, 24- and
  32-bit BI_RGB files (5-bit channels scaled by 255/31, 6-bit by 255/63);
  "RGB" or "RGBA" for the BI_BITFIELDS layouts PIL lists.

Headers: CORE (12 bytes), INFO (40), V2/V3 (52/56), V4 (108), V5 (124);
bottom-up and top-down rows; 1-, 4- and 8-bit palettes, 16-, 24- and
32-bit pixels, BI_RLE8 and BI_RLE4 (data/image_codecs.py).  Anything else
raises ValueError naming the file and the field.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["size", "decode_cv2", "decode_pil"]

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_RGB, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# PIL's BmpImagePlugin: 32-bit (R, G, B, A) masks -> its raw mode
_PIL32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
          (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
          (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
          (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
          (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
          (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
          (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
          (0x0, 0x0, 0x0, 0x0): "BGRA"}
_MASK555 = (0x7C00, 0x3E0, 0x1F)
_MASK565 = (0xF800, 0x7E0, 0x1F)


class Header(NamedTuple):
    size: int            # of the info header
    width: int
    height: int          # > 0: rows bottom-up
    bits: int
    compression: int
    colors: int          # biClrUsed (0: none given)
    offset: int          # bfOffBits
    masks: Optional[Tuple[int, ...]]   # (R, G, B, A) inside the header


def _header(data: bytes, path) -> Header:
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    hsize = struct.unpack_from("<I", data, 14)[0]
    if hsize not in _HEADERS:
        raise ValueError(f"{path}: BMP header size {hsize}")
    if len(data) < 14 + hsize:
        raise ValueError(f"{path}: truncated BMP header")
    if hsize == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", data, 18)
        return Header(12, w, h, bits, _RGB, 0, offset, None)
    w, h, _, bits, comp = struct.unpack_from("<iiHHI", data, 18)
    colors = struct.unpack_from("<I", data, 46)[0]
    masks = None
    if hsize >= 52:
        masks = struct.unpack_from("<III", data, 54)
        masks += (struct.unpack_from("<I", data, 66)[0],) if hsize >= 56 \
            else (0,)
    return Header(hsize, w, h, bits, comp, colors, offset, masks)


def size(data: bytes, path) -> Tuple[int, int]:
    """(width, height) of the decode, from the header."""
    h = _header(data, path)
    return h.width, abs(h.height)


def _check(h: Header, path):
    ok = {_RGB: (1, 4, 8, 16, 24, 32), _RLE8: (8,), _RLE4: (4,),
          _BITFIELDS: (16, 32)}
    if h.compression not in ok:
        raise ValueError(f"{path}: BMP compression {h.compression}")
    if h.bits not in ok[h.compression]:
        raise ValueError(f"{path}: BMP compression {h.compression} at "
                         f"BitCount {h.bits}")
    if h.width <= 0 or h.height == 0:
        raise ValueError(f"{path}: BMP of width {h.width}, height "
                         f"{h.height}")
    if h.compression in (_RLE8, _RLE4) and h.height < 0:
        raise ValueError(f"{path}: top-down BMP with compression "
                         f"{h.compression}")


def _palette(data: bytes, h: Header, count: int, path) -> np.ndarray:
    """`count` palette entries after the header, as (count, 3) RGB."""
    step = 3 if h.size == 12 else 4
    start = 14 + h.size
    raw = data[start:start + step * count]
    if len(raw) < step * count:
        raise ValueError(f"{path}: truncated BMP palette")
    return np.frombuffer(raw, np.uint8).reshape(count, step)[:, 2::-1].copy()


def _indices(data: bytes, h: Header, path) -> np.ndarray:
    """The palette indices, (H, W), top row first."""
    height = abs(h.height)
    if h.compression in (_RLE8, _RLE4):
        from .image_codecs import rle_decode
        idx = rle_decode(data[h.offset:], h.width, height,
                         h.compression == _RLE4, path)
    else:
        stride = (h.width * h.bits + 31) // 32 * 4
        rows = _rows(data, h, stride, path)
        bits = np.unpackbits(rows, axis=1)[:, :h.width * h.bits]
        bits = bits.reshape(height, h.width, h.bits)
        weights = (1 << np.arange(h.bits - 1, -1, -1)).astype(np.uint16)
        idx = (bits * weights).sum(2, dtype=np.uint16).astype(np.uint8)
    return idx[::-1] if h.height > 0 else idx


def _rows(data: bytes, h: Header, stride: int, path) -> np.ndarray:
    """The stored rows, (|height|, stride) uint8, in the file's order."""
    n = stride * abs(h.height)
    raw = data[h.offset:h.offset + n]
    if len(raw) < n:
        raise ValueError(f"{path}: truncated BMP pixel data ({len(raw)} of "
                         f"{n} bytes)")
    return np.frombuffer(raw, np.uint8).reshape(abs(h.height), stride)


def _words(data: bytes, h: Header, nbytes: int, path) -> np.ndarray:
    """16- or 32-bit pixels, (H, W) little-endian words, top row first."""
    stride = (h.width * h.bits + 31) // 32 * 4
    rows = _rows(data, h, stride, path)[:, :h.width * nbytes]
    px = rows.copy().view("<u2" if nbytes == 2 else "<u4")
    return px[::-1] if h.height > 0 else px


def _bgr(data: bytes, h: Header, path) -> np.ndarray:
    """24- or 32-bit pixels as (H, W, 3 or 4) bytes in the file's order."""
    n = h.bits // 8
    stride = (h.width * h.bits + 31) // 32 * 4
    px = _rows(data, h, stride, path)[:, :h.width * n]
    px = px.reshape(abs(h.height), h.width, n)
    return px[::-1] if h.height > 0 else px


def _field(px: np.ndarray, mask: int) -> np.ndarray:
    """(px & mask) >> the mask's lowest set bit, truncated to uint8."""
    shift = (mask & -mask).bit_length() - 1
    return ((px.astype(np.uint32) & mask) >> shift).astype(np.uint8)


def decode_cv2(data: bytes, path) -> np.ndarray:
    h = _header(data, path)
    _check(h, path)
    if h.bits <= 8:
        count = h.colors or (1 << h.bits)
        if count > 256:
            raise ValueError(f"{path}: BMP palette of {count} colours")
        full = np.zeros((256, 3), np.uint8)
        full[:count] = _palette(data, h, count, path)
        return np.ascontiguousarray(full[_indices(data, h, path)])
    if h.bits == 16:
        masks = _MASK555
        if h.compression == _BITFIELDS:
            # OpenCV reads the three masks from the 12 bytes after the header
            start = 14 + h.size
            masks = struct.unpack_from("<III", data, start) \
                if len(data) >= start + 12 else ()
            if masks not in (_MASK555, _MASK565):
                raise ValueError(f"{path}: BMP 16-bit BI_BITFIELDS masks "
                                 f"{[hex(m) for m in masks]} after its "
                                 f"{h.size}-byte header")
        px = _words(data, h, 2, path).astype(np.int32)
        if masks == _MASK555:
            rgb = ((px >> 7) & ~7, (px >> 2) & ~7, px << 3)
        else:
            rgb = ((px >> 8) & ~7, (px >> 3) & ~3, px << 3)
        return np.stack(rgb, -1).astype(np.uint8)
    bgr = _bgr(data, h, path)
    if h.bits == 32 and h.compression == _BITFIELDS and h.size >= 56 \
            and all(h.masks[:3]):
        px = _words(data, h, 4, path)
        return np.stack([_field(px, m) for m in h.masks[:3]], -1)
    return np.ascontiguousarray(bgr[..., 2::-1])


def decode_pil(data: bytes, path):
    h = _header(data, path)
    _check(h, path)
    if h.bits <= 8:
        count = h.colors or (1 << h.bits)
        palette = _palette(data, h, count, path)
        idx = _indices(data, h, path)
        grey = (0, 255) if count == 2 else range(count)
        if all((palette[i] == v).all() for i, v in enumerate(grey)):
            if count == 2:
                return "1", idx.astype(bool), None
            return "L", idx, None
        return "P", idx, palette
    if h.bits == 16:
        masks = _MASK555
        if h.compression == _BITFIELDS:
            masks = h.masks[:3] if h.size >= 52 else struct.unpack_from(
                "<III", data, 14 + h.size)
            if masks not in (_MASK555, _MASK565):
                raise ValueError(f"{path}: BMP 16-bit BI_BITFIELDS masks "
                                 f"{[hex(m) for m in masks]}")
        px = _words(data, h, 2, path).astype(np.uint32)
        if masks == _MASK555:
            rgb = (((px >> 10) & 31) * 255 // 31, ((px >> 5) & 31) * 255 // 31,
                   (px & 31) * 255 // 31)
        else:
            rgb = (((px >> 11) & 31) * 255 // 31, ((px >> 5) & 63) * 255 // 63,
                   (px & 31) * 255 // 31)
        return "RGB", np.stack(rgb, -1).astype(np.uint8), None
    bgr = _bgr(data, h, path)
    if h.compression == _BITFIELDS:
        masks = h.masks if h.size >= 52 else struct.unpack_from(
            "<III", data, 14 + h.size) + (0,)
        if h.bits != 32 or masks not in _PIL32:
            raise ValueError(f"{path}: BMP {h.bits}-bit BI_BITFIELDS masks "
                             f"{[hex(m) for m in masks]}")
        raw = _PIL32[masks]
        out = np.stack([bgr[..., raw.index(c)] for c in "RGB"], -1)
        if "A" in raw:
            return "RGBA", np.concatenate(
                [out, bgr[..., raw.index("A"), None]], -1), None
        return "RGB", out, None
    return "RGB", np.ascontiguousarray(bgr[..., 2::-1]), None
