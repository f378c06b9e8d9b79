#!/usr/bin/env python3
"""K1 against its source at another git revision on one card: bit for
bit, the time of each chain in turns, and the time of each product beside
its bound.

    python3 scripts/k1_products.py [--base REV] [--out PATH]

--base names the revision whose vatl4pose_tpu_torch/csrc/fused_bottleneck.cu
the shipped one is held against (default HEAD~1, the parent).  The source
is read with `git show` (in a copy of the tree without .git, point GIT_DIR
at a clone of the repository), built with nvcc, and launched through the
shipped wrapper with its library in place of the shipped one; the
revision's f32 weights must come split by the wrapper (its source has
k_major_split_f32), as in every tree since K1's weights were split once a
call.

1. Equal bit for bit, f32 and bf16: the four SimplePose-R50 tails at N=512
   on chip_smoke.py phase 2's random operands and at N=120, the shapes of
   tests/test_torch_cuda.py::test_chain_kernel_at_stage_and_edge_shapes
   on its He-scaled operands, and its cancelling operands (C1).
2. Each tail at N=512: CUDA-event medians of the chain, base, shipped,
   shipped, base (chip_smoke.cuda_ms).
3. Each tail at N=512: every launch of the chain under torch.profiler, each
   conv_gemm_kernel instance summed by product (conv1, the 3x3 conv2,
   conv3 with the residual) and the wrapper's other kernels (the weights'
   layout), a median over the calls; each product beside its bound, by
   the arithmetic of benchmark/bounds.py for one product: the larger of
   its operations over the peak (f32: the lesser of F on the CUDA cores
   and 3F on TF32) and its operands read once and its output written once
   over HBM.
Prints a line a measurement and writes every number, with the card's name
and power limit, as JSON to --out (default k1_products.json in the package's
build directory, which git ignores).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "vatl4pose_tpu_torch/csrc/fused_bottleneck.cu"
N120 = 120
PRODUCT = re.compile(r"conv_gemm_kernel<([^,]+), (\d+), (true|false), "
                     r"(true|false)>")


def product_of(name):
    """'conv1', 'conv2' (3x3) or 'conv3' for a conv_gemm_kernel launch,
    'layout' for any other kernel of the wrapper."""
    m = PRODUCT.search(name)
    if m is None:
        return "layout"
    return "conv2" if m.group(3) == "true" else \
        "conv3" if m.group(4) == "true" else "conv1"


def product_bounds_ms(N, H, W, C, P, nb, itemsize):
    """Each product's least time over the chain's nb blocks, in ms."""
    from benchmark import chip
    M = N * H * W
    shapes = {"conv1": (C, P, 0), "conv2": (9 * P, P, 0),
              "conv3": (P, C, C)}   # K, Cout, residual channels
    out = {}
    for name, (K, cout, res) in shapes.items():
        flops = 2.0 * M * K * cout * nb
        cin = K // 9 if name == "conv2" else K
        nbytes = nb * (M * (cin + cout + res) * itemsize
                       + K * cout * itemsize + 2 * cout * 4)
        t_ops = (min(flops / chip.F32_FLOPS, 3 * flops / chip.TF32_FLOPS)
                 if itemsize == 4 else flops / chip.BF16_FLOPS)
        out[name] = 1e3 * max(t_ops, nbytes / chip.HBM_BYTES_PER_S)
    return out


def profile_ms(fn, calls=6):
    """Device ms of each product in one fn() call: the median over `calls`
    profiled calls of each product's summed kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        sums = {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA \
                    and not ev.is_user_annotation():
                key = product_of(ev.name())
                sums[key] = sums.get(key, 0.0) \
                    + (ev.end_ns() - ev.start_ns()) / 1e6
        per_call.append(sums)
    keys = sorted({k for s in per_call for k in s})
    return {k: statistics.median(s.get(k, 0.0) for s in per_call)
            for k in keys}


def build_base(rev, out_dir):
    """The library of `rev`'s fused_bottleneck.cu, built with `-Xptxas -v`
    into out_dir and bound with the shipped C signatures of the entries
    it has: (library, nvcc's output)."""
    import ctypes
    from vatl4pose_tpu_torch.kernels import _build
    src = out_dir / "base.cu"
    src.write_text(subprocess.run(
        ["git", "show", f"{rev}:{SOURCE}"], cwd=ROOT, check=True,
        capture_output=True, text=True).stdout)
    lib_path = out_dir / "libbase.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(lib_path), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {rev}'s source failed:\n"
                           f"{proc.stdout[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    if not hasattr(lib, "k_major_split_f32"):
        raise RuntimeError(f"{rev}'s K1 splits its f32 weights in the "
                           "kernel: the shipped wrapper cannot launch it")
    for fn, argtypes in _build.SIGNATURES["fused_bottleneck"].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib, proc.stdout


def bitwise_equal(a, b):
    import torch
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="HEAD~1")
    ap.add_argument("--out", default=str(ROOT / "vatl4pose_tpu_torch" /
                                         "build" / "k1_products.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_products: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from benchmark.bounds import resnet_tails
    from tests.test_torch_cuda import (cancelling_chain_operands,
                                       he_chain_operands)
    from vatl4pose_tpu_torch.kernels import _build, fused_bottleneck_chain
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cs.log(card)
    _build.build(["fused_bottleneck"], verbose=True)
    out_dir = _build.BUILD_DIR / "k1_base"
    out_dir.mkdir(parents=True, exist_ok=True)
    base, base_ptxas = build_base(args.base, out_dir)
    for who, text in (("shipped", _build.ptxas_info["fused_bottleneck"]),
                      ("base", base_ptxas)):
        for line in text.splitlines():
            if re.search(r"registers|spill|[Ww]arning", line):
                cs.log(f"  ptxas {who}: {line.strip()}")

    def run_base(x, *ws):
        shipped = _build.load("fused_bottleneck")
        _build._libs["fused_bottleneck"] = base
        try:
            return fused_bottleneck_chain(x, *ws)
        finally:
            _build._libs["fused_bottleneck"] = shipped

    res = {"card": card, "base": args.base, "equal": {}, "chain_ms": {},
           "products_ms": {}, "bounds_ms": {}}
    equal = res["equal"]

    def check(key, x, ws):
        got = fused_bottleneck_chain(x, *ws)
        ref = run_base(x, *ws)
        torch.cuda.synchronize()
        equal[key] = bool(bitwise_equal(got, ref))
        cs.log(f"{key}: bit for bit {'equal' if equal[key] else 'DIFFERENT'}"
               + ("" if equal[key] else
                  f", max|diff| {(got.float() - ref.float()).abs().max()}"))

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for (H, W, C, P, nb) in resnet_tails(50, (256, 192)):
            tail = f"{dt} {H}x{W} C={C} P={P} nb={nb}"
            x, ws = cs._chain_inputs(cs.BATCH, H, W, C, P, nb, dtype, gen)
            check(f"{tail} N={cs.BATCH}", x, ws)
            t = [cs.cuda_ms(lambda: run_base(x, *ws)),
                 cs.cuda_ms(lambda: fused_bottleneck_chain(x, *ws)),
                 cs.cuda_ms(lambda: fused_bottleneck_chain(x, *ws)),
                 cs.cuda_ms(lambda: run_base(x, *ws))]
            res["chain_ms"][tail] = {"base": [t[0], t[3]],
                                     "shipped": [t[1], t[2]]}
            prods = {"base": profile_ms(lambda: run_base(x, *ws)),
                     "shipped": profile_ms(
                         lambda: fused_bottleneck_chain(x, *ws))}
            res["products_ms"][tail] = prods
            bounds = product_bounds_ms(cs.BATCH, H, W, C, P, nb,
                                       x.element_size())
            res["bounds_ms"][tail] = bounds
            cs.log(f"{tail} N={cs.BATCH}: chain base {t[0]:.3f}/{t[3]:.3f}"
                   f" ms, shipped {t[1]:.3f}/{t[2]:.3f} ms")
            for k in sorted(set(prods["base"]) | set(prods["shipped"])):
                b = bounds.get(k)
                cs.log(f"    {k}: base {prods['base'].get(k, 0.0):.3f} ms,"
                       f" shipped {prods['shipped'].get(k, 0.0):.3f} ms"
                       + ("" if b is None else
                          f", bound {b:.3f} ms, share base "
                          f"{b / max(prods['base'].get(k, 0.0), 1e-9):.3f}"
                          f" shipped "
                          f"{b / max(prods['shipped'].get(k, 0.0), 1e-9):.3f}"))
            del x, ws
            torch.cuda.empty_cache()
            x, ws = cs._chain_inputs(N120, H, W, C, P, nb, dtype, gen)
            check(f"{tail} N={N120}", x, ws)
            del x, ws
        rng = np.random.default_rng(8111)
        for (N, H, W, C, P, nb) in [
                (2, 64, 48, 256, 64, 2), (2, 32, 24, 512, 128, 3),
                (2, 16, 12, 1024, 256, 5), (2, 8, 6, 2048, 512, 2),
                (3, 1, 37, 64, 16, 2), (3, 29, 1, 64, 16, 2),
                (1, 5, 6, 32, 8, 2)]:
            x = torch.tensor(rng.normal(0, 1, (N, H, W, C)), dtype=dtype,
                             device="cuda").relu()
            check(f"{dt} edge N={N} {H}x{W} C={C} P={P} nb={nb}", x,
                  he_chain_operands(nb, C, P, dtype, "cuda"))
    x, ws = cancelling_chain_operands("cuda", np.random.default_rng(8111))
    check("float32 cancelling operands", x, ws)
    for dt in ("float32", "bfloat16"):
        tot = {side: sum(statistics.median(v[side])
                         for k, v in res["chain_ms"].items()
                         if k.startswith(dt)) for side in ("base",
                                                           "shipped")}
        res[f"total_ms_{dt}"] = tot
        cs.log(f"four tails {dt} N={cs.BATCH}: base {tot['base']:.3f} ms, "
               f"shipped {tot['shipped']:.3f} ms "
               f"({tot['shipped'] / tot['base'] - 1:+.2%})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    n_diff = sum(not v for v in equal.values())
    cs.log(f"{len(equal) - n_diff} of {len(equal)} equal bit for bit; {card}")
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
