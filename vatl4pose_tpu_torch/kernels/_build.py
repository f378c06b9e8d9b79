"""Build the CUDA sources under csrc/ with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/lib<name>-<hash>.so` (the directory is git-ignored), at first use
and again only when the source, the flags or the toolkit change: the hash
covers what `nvcc --version` prints, so that a library built by another
nvcc is never loaded.  `build()` starts one nvcc per
source, all at once, and waits for them; a failed build raises with
nvcc's output.  Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p (never cut to 32
# bits), every size an int; each entry returns cudaGetLastError()
SIGNATURES = {
    "fused_bottleneck": {
        "fused_bottleneck_chain_f32": [_P] * 16 + [_I] * 6 + [_P],
        "fused_bottleneck_chain_bf16": [_P] * 13 + [_I] * 6 + [_P],
        "k_major_split_f32": [_P] * 9 + [_I] * 3 + [_P],
    },
    "postprocess": {
        "heatmap_postprocess_f32": [_P] * 4 + [_I] * 4 + [_P],
    },
    "rot_warp": {
        f"{variant}_{src}_{out}": [_P] * 4 + [_I] * 6 + [_F] * 4 + [_P]
        for variant in ("rot_warp", "rot_warp_copy")
        for src in ("u8", "f32") for out in ("f32", "bf16")
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
ptxas_info: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def toolkit_version() -> str:
    """What `nvcc --version` prints."""
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        + toolkit_version().encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES), verbose: bool = False):
    """Compile every named source that has no current library, one nvcc
    process each, all started together.  verbose adds `-Xptxas -v` and
    keeps its report (registers, shared memory, spills) in `ptxas_info`."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            lib = lib_path(name)
            if lib.exists() and not verbose:
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose
                                            else []) \
                + ["-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, lib,
                           time.perf_counter())
        failed = []
        for name, (proc, tmp, lib, t0) in procs.items():
            out, _ = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
                continue
            ptxas_info[name] = out
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The bound library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = lib_path(name)
    if not path.exists():
        build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
