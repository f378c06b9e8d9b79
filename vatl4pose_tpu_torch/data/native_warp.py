"""ctypes binding for the native batched host warp (counterpart of
vatl4pose_tpu/data/native_warp.py).

cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) person crops of uint8
frames on the host, many threads, from the shared C++ source
native/warp/warp_affine.cpp: mode 1 is cv2 >= 5's float32 bilinear with
round-half-even, mode 0 the classic 5-bit fixed-point scheme.  The device
crop (kernels/rot_warp.py) is float bilinear and differs from mode 1 by up
to 1 LSB of uint8.

At first use the source is compiled with g++ into
vatl4pose_tpu_torch/build/ (git-ignored), named by a hash of the source,
the flags and the compiler's `--version`, so that another compiler builds
anew; the JAX package's library under native/ is never read or written.
A failed build raises; `available()` only asks whether the library
loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["warp_affine_batch", "lib_path", "available"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "warp" \
    / "warp_affine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def compiler_version(cxx: str) -> str:
    """What `cxx --version` prints."""
    return subprocess.run([cxx, "--version"], capture_output=True,
                          text=True, check=True).stdout


def lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
        + compiler_version(_cxx()).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libwarp_affine-{digest}.so"


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_cxx(), *CXX_FLAGS, "-o", str(tmp),
                 str(SOURCE)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"host warp build failed (exit "
                                   f"{proc.returncode}):\n{proc.stdout}"
                                   f"{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.warp_affine_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.warp_affine_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the host warp's library builds and loads."""
    try:
        _load()
        return True
    except Exception:
        return False


def warp_affine_batch(frames: np.ndarray, frame_idx: np.ndarray,
                      fwd_mats: np.ndarray, out_size, num_threads: int = 0,
                      mode: int = 1) -> np.ndarray:
    """frames (F, H, W, C) uint8; frame_idx (N,); fwd_mats (N, 2, 3)
    forward (src->dst) affines, the cv2.warpAffine convention.  Returns
    (N, out_h, out_w, C) uint8."""
    if mode not in (0, 1):
        raise ValueError(f"warp mode {mode} is not 0 or 1")
    lib = _load()
    frames = np.ascontiguousarray(frames, np.uint8)
    fi = np.ascontiguousarray(frame_idx, np.int32)
    if len(fi) and (fi.min() < 0 or fi.max() >= frames.shape[0]):
        raise IndexError(f"frame index outside [0, {frames.shape[0]})")
    mats = np.ascontiguousarray(fwd_mats, np.float64).reshape(len(fi), 6)
    out_h, out_w = int(out_size[0]), int(out_size[1])
    n = len(fi)
    out = np.empty((n, out_h, out_w, frames.shape[3]), np.uint8)
    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    lib.warp_affine_batch(
        frames.ctypes.data, frames.shape[0], frames.shape[1],
        frames.shape[2], frames.shape[3], fi.ctypes.data, mats.ctypes.data,
        n, out.ctypes.data, out_h, out_w, num_threads, mode)
    return out
