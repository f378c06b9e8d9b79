"""ctypes binding of csrc/image_codecs.cpp: BMP RLE8/RLE4, TIFF LZW and
PackBits, the per-code loops that numpy cannot vectorise.  The library is
compiled with g++ at first use into vatl4pose_tpu_torch/build/
(native_warp.build_host_library)."""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "rle_decode", "tiff_decompress"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "image_codecs.cpp"
_ERRLEN = 256

_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is None:
            from .native_warp import build_host_library
            lib = build_host_library(SOURCE, "image_codecs")
            lib.bmp_rle_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.bmp_rle_decode.restype = ctypes.c_int
            lib.tiff_decompress.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_int]
            lib.tiff_decompress.restype = ctypes.c_int
            _lib = lib
        return _lib


def rle_decode(data: bytes, width: int, height: int, rle4: bool,
               path) -> np.ndarray:
    """A BMP's RLE8 or RLE4 stream to (height, width) palette indices, rows
    in the file's bottom-up order; pixels the stream skips are index 0."""
    lib = _load()
    out = np.empty((height, width), np.uint8)
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.bmp_rle_decode(src.ctypes.data, src.size, width, height,
                          int(rle4), out.ctypes.data, err, _ERRLEN):
        kind = "RLE4" if rle4 else "RLE8"
        raise ValueError(f"{path}: BMP {kind}: {err.value.decode()}")
    return out


def tiff_decompress(method: int, data: bytes, size: int, path) -> bytes:
    """One TIFF strip or tile of `size` bytes from LZW (5) or PackBits
    (32773) data."""
    lib = _load()
    out = np.empty(size, np.uint8)
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.tiff_decompress(method, src.ctypes.data, src.size,
                           out.ctypes.data, size, err, _ERRLEN):
        raise ValueError(f"{path}: TIFF Compression={method}: "
                         f"{err.value.decode()}")
    return out.tobytes()
