"""K1 as it was before its f32 weights came split from the wrapper: the
frozen source scripts/k1_study_base.cu, built with nvcc and launched the
way its wrapper launched it (K-major weights laid out by three copies, the
split done by the consumers in shared memory).

scripts/k1_f32_precision.py builds its schemes from this source, and
scripts/k1_products.py holds the shipped kernel against it bit for bit and
in time.  Both run on one CUDA card and need nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess

# the frozen source's C entries: x, out, y1, y2, w1t, s1, b1, w2t, s2, b2,
# w3t, s3, b3, then N, H, W, C, P, nb and the stream
SIGNATURE = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
ENTRIES = ("fused_bottleneck_chain_f32", "fused_bottleneck_chain_bf16")


def nvcc(src, out, defines=()):
    """A started nvcc of `src` into the shared library `out`, with
    `-Xptxas -v`; the caller collects it."""
    from vatl4pose_tpu_torch.kernels import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-Xptxas", "-v",
         "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path):
    lib = ctypes.CDLL(str(path))
    for fn in ENTRIES:
        getattr(lib, fn).argtypes = SIGNATURE
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launch(lib, x, *ws):
    """The chain through `lib`, a build of the frozen source, as its own
    wrapper ran it."""
    import torch
    from vatl4pose_tpu_torch.kernels import _build
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        _check_operands, _k_major)
    N, H, W, C, P, nb = _check_operands(x, ws)
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = ws
    w1t, w2t, w3t = _k_major(w1, w2, w3)
    fn = (lib.fused_bottleneck_chain_f32 if x.dtype == torch.float32
          else lib.fused_bottleneck_chain_bf16)
    out = torch.empty_like(x)
    y1 = torch.empty((N, H, W, P), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), y1.data_ptr(), y2.data_ptr(),
             *(w.data_ptr() for w in (w1t, s1, b1, w2t, s2, b2, w3t, s3,
                                      b3)), N, H, W, C, P, nb, stream)
    _build.check(err, "the frozen chain kernel")
    return out
