"""Image files without cv2 and PIL: JPEG, PNG, BMP and TIFF decoding,
header sizes, and the JPEG, PNG and BMP writers.

The JAX package reads frames with `cv2.imread(path, IMREAD_COLOR)` and a
BGR->RGB conversion, writes the synthetic video's frames with
`cv2.imwrite`, and cli/convert_to_eps.py opens figures with PIL; the
machine with the card has neither, so the port reads and writes them
itself.  `read_images` gives cv2's view, (H, W, 3) uint8 RGB:

* JPEG through the port's host C++ decoder (csrc/jpeg_decode.cpp),
  bit-identical to libjpeg-turbo's defaults as cv2 uses them (ISLOW IDCT,
  fancy upsampling, fixed-point YCbCr->RGB), grayscale replicated into
  three channels, the EXIF orientation applied as IMREAD_COLOR applies
  it.  It is compiled with g++ at first use into vatl4pose_tpu_torch/build/
  (data/native_warp.py's `build_host_library`) and decodes a list of
  frames on several threads.  Baseline, extended sequential and
  progressive Huffman 8-bit files: arithmetic, lossless, hierarchical,
  12-bit and CMYK files, and progressive files whose scans break their
  order or leave coefficient bits unread, raise ValueError.
* PNG with zlib and numpy: every colour type and bit depth, all five
  filter types, Adam7 interlacing; as libpng's transforms in cv2 give it,
  alpha (and tRNS) dropped, palettes expanded, 1-, 2- and 4-bit gray
  scaled to 8 bits, 16-bit samples cut to their high byte.
* BMP (data/bmp.py) and TIFF (data/tiff.py), each with the fields it
  reads listed there.

The file's kind comes from its first bytes, as cv2.imread finds it:
FFD8FF, \x89PNG, BM, II*\0 and MM\0*.

`read_image_mode` keeps the file's mode instead, as PIL's Image.open
gives it (for cli/convert_to_eps.py): for PNG "1", "L" (2- and 4-bit gray
scaled), "I;16", "LA", "RGB" and "RGBA" (16-bit colour cut to 8 bits, as
PIL cuts it, 16-bit gray+alpha as "RGBA"), "P" with its palette for
palette PNGs (`palette_to_rgb` expands them as PIL's convert("RGB") does:
indices past the palette are black); "L" or "RGB" for JPEGs, without the
EXIF orientation (Image.open does not apply it); BMP's and TIFF's modes as
data/bmp.py and data/tiff.py list them.

`encode_jpeg`/`write_jpeg` write what cv2.imencode/cv2.imwrite write, byte
for byte (csrc/jpeg_encode.cpp); `write_bmp` what cv2.imwrite writes for
a .bmp; `write_png` an 8-bit RGB PNG.
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

from . import bmp, tiff

__all__ = ["read_images", "read_image_mode", "palette_to_rgb", "image_size",
           "write_png", "encode_jpeg", "write_jpeg", "write_bmp"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg_decode.cpp"
ENCODER_SOURCE = SOURCE.with_name("jpeg_encode.cpp")
_JPEG_MAGIC = b"\xff\xd8\xff"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_KINDS = ((_JPEG_MAGIC, "jpeg"), (_PNG_MAGIC, "png"), (b"BM", "bmp"),
          (b"II*\0", "tiff"), (b"MM\0*", "tiff"))
_ERRLEN = 512

_lock = threading.Lock()
_lib = None
_enc = None


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


def _load_encoder():
    global _enc
    with _lock:
        if _enc is None:
            from .native_warp import build_host_library
            lib = build_host_library(ENCODER_SOURCE, "jpeg_encode")
            lib.jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_encode.restype = ctypes.c_long
            _enc = lib
        return _enc


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _kind(data: bytes, path) -> str:
    for magic, kind in _KINDS:
        if data.startswith(magic):
            return kind
    raise ValueError(f"{path}: not a JPEG, PNG, BMP or TIFF file (first "
                     f"bytes {data[:4].hex()})")


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

_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples


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


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_unpack(rows: np.ndarray, width: int, ch: int, depth: int
                ) -> np.ndarray:
    """Unfiltered rows to (h, width, ch) samples: uint8, or uint16 at 16
    bits; 1-, 2- and 4-bit samples as their integer values."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * ch].reshape(h, width, ch)
    if depth == 16:
        return rows[:, :2 * width * ch].copy().view(">u2").astype(
            np.uint16).reshape(h, width, ch)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, width, depth) * weights).sum(
        2, dtype=np.uint16).astype(np.uint8)[..., None]


def _png_samples(data: bytes, path):
    """A PNG's samples as stored, (H, W, channels) uint8 (uint16 at 16
    bits), with (colour type, bit depth, PLTE as (n, 3) or None)."""
    width, height, depth, ctype, interlace = _png_header(data, path)
    if ctype not in _PNG_DEPTHS:
        raise ValueError(f"{path}: PNG colour type {ctype}")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace}")
    chunks = list(_png_chunks(data, path))
    palette = None
    if ctype == 3:
        plte = [body for kind, body in chunks if kind == b"PLTE"]
        if not plte or len(plte[0]) % 3:
            raise ValueError(f"{path}: palette PNG without a valid PLTE "
                             f"chunk")
        palette = np.frombuffer(plte[0], np.uint8).reshape(-1, 3)
    idat = b"".join(body for kind, body in chunks if kind == b"IDAT")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((height, width, ch), np.uint16 if depth == 16
                   else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError(f"{path}: PNG data of {raw.size} bytes, too "
                             f"short for its image")
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp, path)
        out[y0::dy, x0::dx] = _png_unpack(rows, pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError(f"{path}: PNG data of {raw.size} bytes, not {pos}")
    return out, ctype, depth, palette


def palette_to_rgb(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette indices to (H, W, 3) RGB, as PIL's convert("RGB"): an
    index past the palette is black."""
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette[:256]
    return full[idx]


def _png_cv2(data: bytes, path) -> np.ndarray:
    px, ctype, depth, palette = _png_samples(data, path)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if ctype == 3:
        return palette_to_rgb(px[..., 0], palette)
    if ctype in (0, 4):
        gray = px[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _png_pil(data: bytes, path):
    """(mode, pixels, palette) as PIL's PngImagePlugin gives them."""
    px, ctype, depth, palette = _png_samples(data, path)
    if ctype == 3:
        return "P", np.ascontiguousarray(px[..., 0]), palette
    if ctype == 0:
        if depth == 16:
            return "I;16", px[..., 0].astype("<u2"), None
        if depth == 1:
            return "1", px[..., 0].astype(bool), None
        gray = px[..., 0] * np.uint8(255 // ((1 << depth) - 1))
        return "L", np.ascontiguousarray(gray), None
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
        if ctype == 4:                          # "LA;16B" -> "RGBA"
            return "RGBA", np.ascontiguousarray(px[..., [0, 0, 0, 1]]), None
    mode = {2: "RGB", 4: "LA", 6: "RGBA"}[ctype]
    return mode, np.ascontiguousarray(px), None


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


# ---- the writers -----------------------------------------------------------

_SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def encode_jpeg(img: np.ndarray, quality: int = 95,
                sampling: str = "420") -> bytes:
    """An (H, W, 3) uint8 RGB or (H, W) gray image as the JPEG bytes that
    cv2.imencode(".jpg") writes for it (the RGB image given to cv2 as BGR)
    with IMWRITE_JPEG_QUALITY `quality` (1-100) and
    IMWRITE_JPEG_SAMPLING_FACTOR "444", "422" or "420" (cv2's default);
    a gray image is one component, whatever the sampling.  It writes
    baseline JPEGs with the standard Huffman tables and no restart
    intervals only."""
    if sampling not in _SAMPLING:
        raise ValueError(f"sampling {sampling!r}: one of {list(_SAMPLING)}")
    if not 1 <= int(quality) <= 100:
        raise ValueError(f"quality {quality}: 1-100")
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes (H, W, 3) or (H, W) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    lib = _load_encoder()
    hy, vy = _SAMPLING[sampling]
    # a block never takes more than 1 KiB (26 bits a coefficient, doubled
    # by 0xFF stuffing)
    blocks = (-(-w // 16) * 2) * (-(-h // 16) * 2) * (1 if ch == 1 else 3)
    out = np.empty(blocks * 1024 + 4096, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.jpeg_encode(img.ctypes.data, w, h, ch, int(quality), hy, vy,
                        out.ctypes.data, out.size, err, _ERRLEN)
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    if n > out.size:
        raise RuntimeError(f"encode_jpeg: {n} bytes past the bound "
                           f"{out.size}")
    return out[:n].tobytes()


def write_jpeg(path, img: np.ndarray, quality: int = 95,
               sampling: str = "420") -> None:
    """encode_jpeg's bytes written to `path` (cv2.imwrite's file)."""
    data = encode_jpeg(img, quality, sampling)
    with open(path, "wb") as f:
        f.write(data)


def write_bmp(path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 RGB image as the BMP that cv2.imwrite writes:
    BITMAPINFOHEADER, 24-bit BGR rows bottom-up, each padded to 4 bytes
    with zeros; the image-size, resolution and colour-count fields 0."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_bmp takes (H, W, 3) uint8, not {rgb.shape}")
    h, w = rgb.shape[:2]
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    head = 14 + 40
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", head + stride * h, 0, 0, head))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0,
                            0))
        f.write(rows.tobytes())


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
    others = {"png": _png_cv2, "bmp": bmp.decode_cv2,
              "tiff": tiff.decode_cv2}
    for i, k in enumerate(kinds):
        if k in others:
            out[i] = others[k](datas[i], paths[i])
    return out


def read_image_mode(path: str) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
    """(mode, pixels, palette) as PIL's Image.open gives the file: see the
    module's docstring."""
    data = _read(path)
    kind = _kind(data, path)
    if kind == "png":
        return _png_pil(data, path)
    if kind == "bmp":
        return bmp.decode_pil(data, path)
    if kind == "tiff":
        return tiff.decode_pil(data, path)
    rgb = _decode_jpegs([data], [path], 1, orient=False)[0]
    if _jpeg_info(data, path)[2] == 1:
        return "L", np.ascontiguousarray(rgb[..., 0]), None
    return "RGB", rgb, None


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of the decoded image, from the headers alone: a
    JPEG's frame header with its EXIF orientation (5-8 swap the sides), a
    PNG's IHDR, a BMP's info header, a TIFF's first IFD (read where the
    file puts it)."""
    with open(path, "rb") as f:
        head = f.read(14 + 124)                 # BMP's largest header
        kind = _kind(head, path)
        if kind == "png":
            w, h = _png_header(head, path)[:2]
            return int(w), int(h)
        if kind == "bmp":
            return bmp.size(head, path)
        if kind == "tiff":
            return tiff.size_from_file(f, path)
        data = head + f.read()
    w, h, _, orientation = _jpeg_info(data, path)
    return (h, w) if orientation in (5, 6, 7, 8) else (w, h)
