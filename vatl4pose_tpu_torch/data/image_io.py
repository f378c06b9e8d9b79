"""Frame files without cv2: JPEG and PNG decoding, header sizes and a PNG
writer.

The JAX package reads frames with `cv2.imread(path, IMREAD_COLOR)` and a
BGR->RGB conversion; the machine with the card has no cv2, so the port
decodes them itself, to the same (H, W, 3) uint8 RGB arrays:

* JPEG through the port's host C++ decoder (csrc/jpeg_decode.cpp),
  bit-identical to libjpeg-turbo's defaults as cv2 uses them (ISLOW IDCT,
  fancy upsampling, fixed-point YCbCr->RGB), grayscale replicated into
  three channels, the EXIF orientation applied as IMREAD_COLOR applies
  it.  It is compiled with g++ at first use into vatl4pose_tpu_torch/build/
  (data/native_warp.py's `build_host_library`) and decodes a list of
  frames on several threads.  Baseline and extended sequential Huffman
  8-bit files only: progressive, arithmetic, lossless, 12-bit and CMYK
  files raise ValueError.
* PNG with zlib and numpy: 8-bit gray, gray+alpha, RGB and RGBA, all five
  filter types, alpha dropped; 16-bit, palette, sub-byte and interlaced
  images raise ValueError.

The file's kind comes from its first bytes, as cv2.imread finds it.

`read_image_mode` keeps the file's mode instead, as PIL's Image.open
gives it (for cli/convert_to_eps.py): "L", "LA", "RGB" or "RGBA" for
8-bit PNGs, "P" with its palette for palette PNGs of 1, 2, 4 or 8 bits
(`palette_to_rgb` expands them as PIL's convert("RGB") does: indices
past the palette are black), and "L" or "RGB" for JPEGs, without the
EXIF orientation (Image.open does not apply it).  Sub-byte and 16-bit
gray and colour, and interlaced PNGs raise ValueError.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["read_images", "read_image_mode", "palette_to_rgb", "image_size",
           "write_png"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cpp"
_JPEG_MAGIC = b"\xff\xd8"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_ERRLEN = 512

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from .native_warp import build_host_library
            lib = build_host_library(SOURCE, "jpeg_decode")
            lib.jpeg_info.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_int]
            lib.jpeg_decode_batch.restype = ctypes.c_int
            _lib = lib
        return _lib


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _kind(data: bytes, path) -> str:
    if data.startswith(_JPEG_MAGIC):
        return "jpeg"
    if data.startswith(_PNG_MAGIC):
        return "png"
    raise ValueError(f"{path}: not a JPEG or PNG file")


# ---- JPEG ------------------------------------------------------------------

def _jpeg_info(data: bytes, path) -> Tuple[int, int, int, int]:
    """(width, height, components, EXIF orientation) from the headers,
    before the orientation is applied."""
    lib = _load()
    vals = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    buf = np.frombuffer(data, np.uint8)
    p = vals.ctypes.data
    if lib.jpeg_info(buf.ctypes.data, len(data), p, p + 4, p + 8, p + 12,
                     err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return int(vals[0]), int(vals[1]), int(vals[2]), int(vals[3])


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation applied as OpenCV's imread applies it
    (ApplyExifOrientation): 2 mirror, 3 rotate 180, 4 flip, 5 transpose,
    6-8 transpose then mirror, both or flip; any other value leaves the
    image as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _decode_jpegs(datas: Sequence[bytes], paths, num_threads: int = 0,
                  orient: bool = True) -> List[np.ndarray]:
    n = len(datas)
    if n == 0:
        return []
    lib = _load()
    infos = [_jpeg_info(d, p) for d, p in zip(datas, paths)]
    bufs = [np.frombuffer(d, np.uint8) for d in datas]
    outs = [np.empty((h, w, 3), np.uint8) for w, h, _, _ in infos]
    ptrs = np.array([b.ctypes.data for b in bufs], np.uintp)
    sizes = np.array([len(d) for d in datas], np.uintp)
    optrs = np.array([o.ctypes.data for o in outs], np.uintp)
    status = np.zeros(n, np.int32)
    errs = ctypes.create_string_buffer(_ERRLEN * n)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    if lib.jpeg_decode_batch(ptrs.ctypes.data, sizes.ctypes.data,
                             optrs.ctypes.data, n, num_threads,
                             status.ctypes.data, errs, _ERRLEN):
        i = int(np.flatnonzero(status)[0])
        msg = errs.raw[i * _ERRLEN:(i + 1) * _ERRLEN].split(b"\0")[0]
        raise ValueError(f"{paths[i]}: {msg.decode()}")
    if not orient:
        return outs
    return [_orient(o, info[3]) for o, info in zip(outs, infos)]


# ---- PNG -------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> samples a pixel


def _png_chunks(data: bytes, path):
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _png_header(data: bytes, path):
    """IHDR's (width, height, bit depth, colour type, interlace)."""
    if data[12:16] != b"IHDR" or len(data) < 33:
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    return struct.unpack(">IIBBBBB", data[16:29])[:4] + (data[28],)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int,
              path) -> np.ndarray:
    """The five PNG filters (None, Sub, Up, Average, Paeth) undone, row by
    row; Sub and Up by numpy, Average and Paeth byte by byte."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height + 1, stride), np.uint8)   # row 0: the zero prior
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        prior, cur = out[y], out[y + 1]
        if ftype == 0:
            cur[:] = line
        elif ftype == 1:
            cur[:] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur[:] = line + prior
        elif ftype in (3, 4):
            ln, pr = line.tolist(), prior.tolist()
            rec = [0] * stride
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = pr[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = pr[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                rec[i] = (ln[i] + pred) & 0xFF
            cur[:] = rec
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} in row {y}")
    return out[1:]


def _png_pixels(data: bytes, path):
    """A PNG's samples as stored: (mode, (H, W) or (H, W, C) uint8,
    palette or None); palette images at 1, 2, 4 or 8 bits unpacked to one
    index a pixel."""
    width, height, depth, ctype, interlace = _png_header(data, path)
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype != 3:
        return ({0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}.get(ctype, "?"),
                _decode_png(data, path, keep=True), None)
    if depth not in (1, 2, 4, 8):
        raise ValueError(f"{path}: {depth}-bit palette PNG")
    chunks = list(_png_chunks(data, path))
    plte = [body for kind, body in chunks if kind == b"PLTE"]
    if not plte or len(plte[0]) % 3:
        raise ValueError(f"{path}: palette PNG without a valid PLTE chunk")
    palette = np.frombuffer(plte[0], np.uint8).reshape(-1, 3)
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    stride = (width * depth + 7) // 8
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes, not "
                         f"{height * (stride + 1)}")
    rows = _unfilter(raw, height, stride, 1, path)
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    idx = (bits * weights).sum(2, dtype=np.uint16)[:, :width]
    return "P", idx.astype(np.uint8), palette


def palette_to_rgb(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette indices to (H, W, 3) RGB, as PIL's convert("RGB"): an
    index past the palette is black."""
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette[:256]
    return full[idx]


def _decode_png(data: bytes, path, keep: bool = False) -> np.ndarray:
    width, height, depth, ctype, interlace = _png_header(data, path)
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         f"supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported, only "
                         f"8-bit")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    idat = b"".join(body for kind, body in _png_chunks(data, path)
                    if kind == b"IDAT")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    ch = _PNG_CHANNELS[ctype]
    stride = width * ch
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes, not "
                         f"{height * (stride + 1)}")
    px = _unfilter(raw, height, stride, ch, path).reshape(height, width, ch)
    if keep:                                     # the file's own samples
        return px[..., 0] if ch == 1 else px
    if ch <= 2:                                  # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def write_png(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as an 8-bit RGB PNG (filter 0 on
    every row, zlib level 1: cv2.imwrite's PNG default, a third of the
    default level's time on a 3400x600 figure)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not {rgb.shape}")
    h, w = rgb.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_PNG_MAGIC
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


# ---- the public functions --------------------------------------------------

def read_images(paths: Sequence[str], num_threads: int = 0
                ) -> List[np.ndarray]:
    """Each file decoded to (H, W, 3) uint8 RGB, as cv2.imread with
    IMREAD_COLOR and BGR->RGB gives it; the JPEGs on up to `num_threads`
    threads (0: one a core)."""
    datas = [_read(p) for p in paths]
    kinds = [_kind(d, p) for d, p in zip(datas, paths)]
    out = [None] * len(paths)
    jpeg = [i for i, k in enumerate(kinds) if k == "jpeg"]
    for i, img in zip(jpeg, _decode_jpegs([datas[i] for i in jpeg],
                                          [paths[i] for i in jpeg],
                                          num_threads)):
        out[i] = img
    for i, k in enumerate(kinds):
        if k == "png":
            out[i] = _decode_png(datas[i], paths[i])
    return out


def read_image_mode(path: str) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
    """(mode, pixels, palette) as PIL's Image.open gives the file: see the
    module's docstring."""
    data = _read(path)
    if _kind(data, path) == "png":
        return _png_pixels(data, path)
    rgb = _decode_jpegs([data], [path], 1, orient=False)[0]
    if _jpeg_info(data, path)[2] == 1:
        return "L", np.ascontiguousarray(rgb[..., 0]), None
    return "RGB", rgb, None


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of the decoded image, from the headers alone: a
    JPEG's frame header with its EXIF orientation (5-8 swap the sides), a
    PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(64)
        kind = _kind(head, path)
        if kind == "png":
            w, h = _png_header(head, path)[:2]
            return int(w), int(h)
        data = head + f.read()
    w, h, _, orientation = _jpeg_info(data, path)
    return (h, w) if orientation in (5, 6, 7, 8) else (w, h)
