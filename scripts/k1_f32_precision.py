#!/usr/bin/env python3
"""Where K1's f32 error comes from: the chain kernel built once per f32
summation scheme, each measured on one card against float64.

    python3 scripts/k1_f32_precision.py [--no-loop]

The study's base, scripts/k1_study_base.cu, is the chain kernel as it was
when the study measured it: it splits its f32 operands in shared memory and
sums their products one way, scheme 12, the arithmetic that the shipped
kernel (csrc/fused_bottleneck.cu) still does, bit for bit, with its weights
split by the wrapper and each promotion run under the next chunk's
products.
scripts/k1_f32_schemes.patch turns the base into the study source, in
which a macro K1_F32_SCHEME picks one of 13 (the patch lists them); the
patched source must hash to STUDY_SHA256, the source this study measured,
or the script refuses.  Each scheme is compiled with nvcc into
build/k1_study/ and launched as the base's own wrapper launched it
(scripts/k1_base.py).

For each scheme:
  1. the four R50 chains at N=512 on chip_smoke.py phase 2's random
     operands (the same generator and order): max|err| / max from the
     chain in float64 (cuDNN, channels-last) and from K1's plain version,
     and the CUDA-event time of the four chains;
  2. the cancelling operands of tests/test_torch_cuda.py (R50's last
     stage, sums that cancel to a few percent): max|err| / max from f64,
     beside K1's plain version (cuDNN f32);
  3. unless --no-loop: chip_smoke.py phase 5's AL loop is run, and on its
     retrained weights the backbone's output and the heatmaps of 16
     scoring crops through K1 with each scheme, against a float64 CPU
     forward of the unfused graph, beside cuDNN's unfused f32 forward on
     the card (TF32 off) and K1's plain version (the same fold).
Prints one JSON line of every number before the card's name and power
limit.  Needs one CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import copy
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PATCH = ROOT / "scripts" / "k1_f32_schemes.patch"
BASE = ROOT / "scripts" / "k1_study_base.cu"
STUDY_SHA256 = \
    "283bf7744e6d0018c2e058a28f11b6026642d5f7062cdf8e38539e5cd0d7505a"
SCHEMES = {0: "3 products, one accumulator", 1: "hi*hi only",
           2: "4 products, one accumulator",
           3: "3 products, promotion a k-block",
           4: "hi*hi and corrections apart",
           5: "4 products, promotion a k-block",
           6: "3 products, promotion a k-step",
           7: "bf16x6, promotion a k-step",
           8: "bf16x6, promotion a k-block",
           9: "bf16x6, promotion a k-step, sign flipped every second",
           10: "3 products, promotion a k-step, sign flipped every second",
           11: "bf16x6, promotion a k-step, last bit set",
           12: "3 products, promotion a k-step, last bit set"}
LIBS = {}        # scheme -> its bound ctypes library
PTXAS = {}       # scheme -> nvcc's -Xptxas -v report


def apply_patch(text, patch):
    """`text` with the unified diff `patch` applied; every context and
    removed line must match where its hunk says."""
    src = text.splitlines(keepends=True)
    out, pos = [], 0
    lines = patch.splitlines(keepends=True)
    i = 0
    while i < len(lines):
        m = re.match(r"@@ -(\d+)(?:,(\d+))? \+\d+(?:,\d+)? @@", lines[i])
        i += 1
        if not m:
            continue
        start = int(m.group(1)) - (0 if m.group(2) == "0" else 1)
        out += src[pos:start]
        pos = start
        while i < len(lines) and not lines[i].startswith("@@"):
            tag, body = lines[i][0], lines[i][1:]
            if tag in " -":
                if src[pos] != body:
                    raise ValueError(f"the patch does not apply at line "
                                     f"{pos + 1}: the shipped kernel has "
                                     f"changed since the study")
                pos += 1
            if tag in " +":
                out.append(body)
            i += 1
    return "".join(out + src[pos:])


def study_source():
    text = apply_patch(BASE.read_text(), PATCH.read_text())
    digest = hashlib.sha256(text.encode()).hexdigest()
    if digest != STUDY_SHA256:
        raise ValueError(f"the study source hashes to {digest}, not to the "
                         f"source the study measured")
    return text


def build_schemes():
    """nvcc, once per scheme, all at once; binds each that builds."""
    from scripts import k1_base
    from vatl4pose_tpu_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "k1_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fused_bottleneck_schemes.cu"
    src.write_text(study_source())
    procs = {s: k1_base.nvcc(src, out_dir / f"scheme{s}.so",
                             [f"-DK1_F32_SCHEME={s}"])
             for s in SCHEMES}
    for s, proc in procs.items():
        PTXAS[s] = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"scheme {s}: nvcc exit {proc.returncode}\n"
                  f"{PTXAS[s][-4000:]}", file=sys.stderr)
            continue
        LIBS[s] = k1_base.bind(out_dir / f"scheme{s}.so")
    return sorted(LIBS)


def launch(scheme, x, *ws):
    from scripts import k1_base
    return k1_base.launch(LIBS[scheme], x, *ws)


def chain_errors(cs, built):
    """Step 1: the random operands of phase 2, every built scheme."""
    import torch
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {s: {"vs_f64": 0.0, "vs_plain": 0.0, "ms": 0.0} for s in built}
    plain_f64 = 0.0
    for (H, W, C, P, nb) in cs.R50_CHAINS:
        x, ws = cs._chain_inputs(cs.BATCH, H, W, C, P, nb, torch.float32,
                                 gen)
        exact = cs.cudnn_chain(x.double(), [w.double() for w in ws])
        exact = exact.permute(0, 2, 3, 1)
        scale = exact.abs().max().item()
        plain = bottleneck_chain_reference(x, *ws)
        plain_f64 = max(plain_f64,
                        (plain.double() - exact).abs().max().item() / scale)
        for s in built:
            got = launch(s, x, *ws)
            torch.cuda.synchronize()
            r = res[s]
            r["vs_f64"] = max(r["vs_f64"], (got.double() - exact).abs()
                              .max().item() / scale)
            r["vs_plain"] = max(r["vs_plain"], (got - plain).abs().max()
                                .item() / plain.abs().max().item())
            r["ms"] += cs.cuda_ms(lambda: launch(s, x, *ws))
            del got
        del x, ws, exact, plain
        torch.cuda.empty_cache()
    for s, r in res.items():
        cs.log(f"scheme {s} ({SCHEMES[s]}), random operands N={cs.BATCH}: "
               f"max|err|/max from f64 {r['vs_f64']:.3e}, from the plain "
               f"version {r['vs_plain']:.3e}; four chains {r['ms']:.3f} ms")
    cs.log(f"K1's plain version from f64: {plain_f64:.3e}")
    return res, plain_f64


def cancelling_errors(cs, built):
    """Step 2: the cancelling operands of tests/test_torch_cuda.py."""
    import numpy as np
    import torch
    from tests.test_torch_cuda import _chain_f64, cancelling_chain_operands
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference)
    x, ws = cancelling_chain_operands("cuda", np.random.default_rng(8111))
    exact = _chain_f64(x, ws)
    scale = exact.abs().max().item()
    res = {"cuDNN f32": (bottleneck_chain_reference(x, *ws).double()
                         - exact).abs().max().item() / scale}
    for s in built:
        got = launch(s, x, *ws)
        torch.cuda.synchronize()
        res[f"scheme {s}"] = (got.double() - exact).abs().max().item() / scale
    cs.log("cancelling operands, max|err|/max from f64: " + ", ".join(
        f"{k} {v:.3e}" for k, v in res.items()))
    return res


def retrained_errors(cs, built):
    """Step 3: wraps chip_smoke.fold_check, which phase 5 calls on the
    loop's retrained model, to measure every scheme there first."""
    import torch
    import vatl4pose_tpu_torch.models.resnet as resnet_mod
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference)
    from vatl4pose_tpu_torch.ops import crop_batch
    out = {}
    orig = cs.fold_check

    def measured(model, video, n=16):
        d = video.data
        crops = crop_batch(video.frames_dev, d.frame_idx[:n], d.bboxes[:n],
                           cs.INPUT_SIZE)[0].permute(0, 3, 1, 2)
        exact = copy.deepcopy(model).double().cpu().eval()
        kernel = resnet_mod.fused_bottleneck_chain
        was_training = model.training
        model.eval()
        runs = [("f64", exact, crops.double().cpu(), False, kernel),
                ("cuDNN unfused", model, crops, False, kernel),
                ("K1 plain", model, crops, True, bottleneck_chain_reference)]
        runs += [(f"scheme {s}", model, crops, True,
                  (lambda s: lambda *a: launch(s, *a))(s))
                 for s in built]
        feats = {}
        try:
            with torch.no_grad():
                for key, m, x, fused, chain in runs:
                    m.preact.fused_eval = fused
                    resnet_mod.fused_bottleneck_chain = chain
                    f = m.preact(x)
                    feats[key] = (f.double().cpu(), m.final_layer(
                        m.deconv_layers(f)).double().cpu())
        finally:
            resnet_mod.fused_bottleneck_chain = kernel
            model.preact.fused_eval = True
            model.train(was_training)
        for key, (fb, fh) in feats.items():
            if key == "f64":
                continue
            eb, eh = feats["f64"]
            out[key] = {
                "backbone": ((fb - eb).abs().max() / eb.abs().max()).item(),
                "heatmaps": ((fh - eh).abs().max() / eh.abs().max()).item()}
            cs.log(f"retrained weights ({n} samples), {key}: max|err|/max "
                   f"from f64 at the backbone {out[key]['backbone']:.3e}, "
                   f"at the heatmaps {out[key]['heatmaps']:.3e}")
        return orig(model, video, n)

    cs.fold_check = measured
    try:
        video = cs.make_video(0)
        cs.phase_al_loop(video, "", 0)
    finally:
        cs.fold_check = orig
    return out


def ptxas_summary(report):
    """Registers and spill bytes of each f32 instance of the kernel
    (mangled 'conv_gemm_kernelIf...') in a `-Xptxas -v` report."""
    rows, fn = [], None
    for line in report.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "conv_gemm_kernelIf" in fn:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append(f"{m.group(1)} regs/{spill} B spilled")
                fn = None
    return ", ".join(rows) or "no report"


def main():
    import torch
    if not torch.cuda.is_available():
        print("k1_f32_precision: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    built = build_schemes()
    for s in built:
        cs.log(f"  ptxas scheme {s}, f32 kernels: "
               + ptxas_summary(PTXAS[s]))
    cs.log(f"built schemes {built}; {card}")
    res = {"card": card, "schemes": SCHEMES}
    res["random"], res["plain_from_f64"] = chain_errors(cs, built)
    res["cancelling"] = cancelling_errors(cs, built)
    if "--no-loop" not in sys.argv:
        res["retrained"] = retrained_errors(cs, built)
    print(json.dumps(res))
    print(card)
    return 0 if len(built) == len(SCHEMES) else 1


if __name__ == "__main__":
    sys.exit(main())
