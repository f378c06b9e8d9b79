#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vatl4pose_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:
  1. card and build: the card's name and power limit, torch/CUDA versions,
     both CUDA kernels built with nvcc from csrc/ (ptxas report included);
  2. kernel vs plain PyTorch version on the card, at the shapes of the
     main path, with median CUDA-event times, bounds and errors;
  3. main path: one THC+WPU scoring pass (ScoringEngine, fused_eval) of
     SimplePose-R50 at 256x192 over a synthetic video of 512 samples, in
     f32 parity mode and in bf16, with the launch counters reset before
     each pass and checked after it; outputs checked for shape and
     finiteness; warm samples/s and a torch.profiler breakdown of one warm
     pass; the first 32 samples' heatmaps and embeddings held against the
     same port run on the CPU;
  4. a `{"kernels": [...]}` line, then the last line
     `{"ok": true, "device": {...}}`.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # CUDA cores, no tensor cores
BF16_FLOPS = 989e12          # tensor cores

# SimplePose-R50 at 256x192: (H, W, C, P, blocks in the fused tail)
R50_CHAINS = [(64, 48, 256, 64, 2), (32, 24, 512, 128, 3),
              (16, 12, 1024, 256, 5), (8, 6, 2048, 512, 2)]
BATCH = 512
HM_SHAPE = (BATCH, 17, 64, 48)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warm=2):
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card_and_build():
    import torch
    from vatl4pose_tpu_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in
                    _build.build_seconds.items()))
    for name, info in _build.ptxas_info.items():
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def _chain_inputs(N, H, W, C, P, nb, dtype, gen):
    import torch
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * std

    def uni(*shape, lo=0.5, hi=1.5):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    x = randn(N, H, W, C).relu().to(dtype)
    ws = (randn(nb, C, P, std=(2.0 / C) ** 0.5).to(dtype),
          uni(nb, P), randn(nb, P, std=0.1),
          randn(nb, 3, 3, P, P, std=(2.0 / (9 * P)) ** 0.5).to(dtype),
          uni(nb, P), randn(nb, P, std=0.1),
          randn(nb, P, C, std=(2.0 / P) ** 0.5).to(dtype),
          uni(nb, C, lo=0.1, hi=0.3), randn(nb, C, std=0.1))
    return x, ws


def phase_chain_kernel(dtype, gen):
    """K1 at the four R50 stage shapes, N=512.  Tolerances: f32 (TF32 off)
    differs from cuDNN only by summation order, so max|err| <= 1e-4 of the
    output's max; bf16 rounds each of 3*nb epilogues to 8 mantissa bits,
    and a one-ulp flip in either version propagates down the chain, so
    max|err| <= 5e-2 and mean|err| <= 5e-3 of the output's max."""
    import torch
    from vatl4pose_tpu_torch.kernels.fused_bottleneck import (
        bottleneck_chain_reference, fused_bottleneck_chain)
    f32 = dtype == torch.float32
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0}
    bound_share = {"operations": 0.0, "bytes": 0.0}
    for (H, W, C, P, nb) in R50_CHAINS:
        x, ws = _chain_inputs(BATCH, H, W, C, P, nb, dtype, gen)
        got = fused_bottleneck_chain(x, *ws)
        ref = bottleneck_chain_reference(x, *ws)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        max_err, mean_err = err.max().item(), err.mean().item()
        ok = (max_err <= 1e-4 * scale) if f32 else \
            (max_err <= 5e-2 * scale and mean_err <= 5e-3 * scale)
        ms = cuda_ms(lambda: fused_bottleneck_chain(x, *ws))
        plain_ms = cuda_ms(lambda: bottleneck_chain_reference(x, *ws),
                           reps=5)
        flops = 2.0 * BATCH * H * W * (2 * C * P + 9 * P * P) * nb
        nbytes = 2 * x.numel() * x.element_size() \
            + sum(w.numel() * w.element_size() for w in ws)
        t_ops = flops / (F32_FLOPS if f32 else BF16_FLOPS) * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_share["operations" if t_ops >= t_bytes else "bytes"] += \
            max(t_ops, t_bytes)
        log(f"  K1 {str(dtype)[6:]} N={BATCH} {H}x{W} C={C} P={P} nb={nb}: "
            f"max|err| {max_err:.3e} mean|err| {mean_err:.3e} "
            f"(|ref|max {scale:.3e}) kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms bound {max(t_ops, t_bytes):.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s)")
        if not ok:
            raise AssertionError(f"K1 {dtype} {H}x{W}: kernel disagrees "
                                 "with the plain version")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += max(t_ops, t_bytes)
        tot["max_abs_err"] = max(tot["max_abs_err"], max_err)
        del x, ws, got, ref
    # the summed bound is labelled by the side that bounds most of it
    tot["bound_by"] = max(bound_share, key=bound_share.get)
    return tot


def planted_heatmaps(gen):
    """(512, 17, 64, 48) f32 maps: noise, plus every 4th sample all
    negative, every 4th quantized to few levels (many argmax and peak
    ties), every 4th with a planted tie of the max (joints 0-5), a max in
    the corner (6-11) or on the bottom border (12-16)."""
    import torch
    N, K, H, W = HM_SHAPE
    hms = torch.randn(HM_SHAPE, generator=gen, device="cuda") * 0.4 + 0.1
    hms[1::4] = -hms[1::4].abs() - 1e-3
    hms[2::4] = torch.round(hms[2::4] * 4) / 4
    tie = hms[3::4]
    peak = tie.amax(dim=(-2, -1)) + 1.0                 # (n, K)
    flat = tie.view(tie.shape[0], K, H * W)
    flat[:, :, 200] = peak
    flat[:, :, 1000] = peak                             # tie: 200 wins
    flat[:, 6:12, 0] = peak[:, 6:12] + 1.0
    flat[:, 12:, H * W - 1 - W // 2] = peak[:, 12:] + 1.0
    return hms


def phase_postprocess_kernel(gen):
    """K2 at (512, 17, 64, 48).  coords and maxvals must be bit-exact; gc
    is a float sum in another order: rtol 1e-5."""
    import torch
    from vatl4pose_tpu_torch.kernels.postprocess import (
        fused_postprocess, postprocess_reference)
    hms = planted_heatmaps(gen)
    c, m, g = fused_postprocess(hms)
    rc, rm, rg = postprocess_reference(hms)
    torch.cuda.synchronize()
    exact = torch.equal(c, rc) and torch.equal(m, rm)
    gc_err = ((g - rg).abs() / rg.abs().clamp(min=1e-30)).max().item()
    max_err = max((c - rc).abs().max().item(), (m - rm).abs().max().item(),
                  (g - rg).abs().max().item())
    ms = cuda_ms(lambda: fused_postprocess(hms), reps=20)
    plain_ms = cuda_ms(lambda: postprocess_reference(hms), reps=10)
    nbytes = hms.numel() * 4 + (BATCH * 7 * 17 + BATCH * 17 * 2 + BATCH) * 4
    ops = hms.numel() * 20.0          # ~9 max + compares + adds per pixel
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    log(f"  K2 {tuple(hms.shape)}: coords/maxvals exact {exact}, gc max "
        f"rel err {gc_err:.3e}, kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {max(t_bytes, t_ops):.4f} ms")
    if not exact or gc_err > 1e-5:
        raise AssertionError("K2 disagrees with the plain version")
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max_err}


def randomize_(model, gen):
    """Seeded random weights, BN running stats included, so the fold
    matters; He-scaled convs and small bn3 gains keep activations O(1)."""
    import torch
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
                fan_in = m.weight[0].numel()
                if isinstance(m, torch.nn.ConvTranspose2d):
                    fan_in = m.weight.shape[0] * 4
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.05)
            elif isinstance(m, torch.nn.BatchNorm2d):
                lo, hi = (0.1, 0.3) if name.endswith(("bn3", "downsample.1")) \
                    else (0.5, 1.0)
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return model


def make_video(seed):
    """The main path's input: a synthetic video of 64 frames x 8 persons
    at 640x360 (512 samples), decoded to (F, H, W, 3) uint8 frames, and
    the score() arguments."""
    import numpy as np
    from vatl4pose_tpu_torch.data import build_dataset, make_synthetic_video
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, ann = make_synthetic_video(tmp, num_frames=64, num_persons=8,
                                         width=640, height=360, seed=seed)
        ds = build_dataset({"TYPE": "Posetrack21", "ROOT": root,
                            "ANN": ann})
        frames = ds.load_frames()
        log(f"synthetic video: {len(ds)} samples, {frames.shape[0]} frames "
            f"{frames.shape[2]}x{frames.shape[1]}, generated in "
            f"{time.perf_counter() - t0:.1f} s")
    d = ds.data
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    return frames, (frames, d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann,
                    d.is_prev, d.is_next)


def make_models(seed):
    """SimplePose-R50 at full width (deconv 256x3, 17 joints, fused_eval)
    and a WholeBodyAE (z=4, 38 inputs), seeded random weights, on the
    CPU."""
    import torch
    from vatl4pose_tpu_torch.models import SimplePose, WholeBodyAE
    gen = torch.Generator().manual_seed(seed)
    model = randomize_(SimplePose(num_joints=17, num_layers=50,
                                  deconv_dim=(256, 256, 256),
                                  fused_eval=True, device="cpu"), gen)
    ae = randomize_(WholeBodyAE(z_dim=4, input_dim=38, device="cpu"), gen)
    return model, ae


def phase_main_path(seed):
    import torch
    from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
    from vatl4pose_tpu_torch.kernels import (KERNELS, fused_bottleneck_chain,
                                             fused_postprocess,
                                             reset_launch_counts)

    frames, args = make_video(seed)
    frame_idx, bboxes = args[1], args[2]
    n = len(frame_idx)
    if n < BATCH:
        raise AssertionError(f"the video has {n} samples, fewer than one "
                             f"full chunk of {BATCH}")
    model, ae = make_models(seed)
    model_cpu, ae_cpu = copy.deepcopy(model), copy.deepcopy(ae)
    model.cuda()
    ae.cuda()
    # the decoded frames stay on the card across passes, as an AL loop
    # keeps them across rounds
    args = (torch.from_numpy(frames).cuda(),) + args[1:]

    counts, rates, results = {}, {}, {}
    for mode in ("f32", "bf16"):
        cfg = ScoringConfig(uncertainty="THC+WPU", bf16=mode == "bf16")
        engine = ScoringEngine(model, cfg, ae_model=ae, chunk=BATCH)
        reset_launch_counts()
        res = engine.score(*args)
        torch.cuda.synchronize()
        counts[mode] = {k.__name__: k.launches for k in KERNELS}
        log(f"main path {mode}: launches {counts[mode]}")
        if fused_bottleneck_chain.launches == 0 \
                or fused_postprocess.launches == 0:
            raise AssertionError(f"{mode}: a kernel of the path never ran")
        check_outputs(res, n)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.score(*args, keep_heatmaps=False)
            times.append(time.perf_counter() - t0)
        rates[mode] = n / statistics.median(times)
        log(f"main path {mode}: warm scoring {rates[mode]:.1f} samples/s "
            f"({n} samples, median of 3: {statistics.median(times):.3f} s)")
        profile_pass(engine, args, mode)
        results[mode] = res

    # the same port on the CPU, first 32 samples, f32 (plain versions)
    ref = ScoringEngine(model_cpu, ScoringConfig(uncertainty="THC+WPU"),
                        ae_model=ae_cpu, chunk=32, device="cpu")
    hm_cpu, emb_cpu, _ = ref.forward_video(frames, frame_idx[:32],
                                           bboxes[:32])
    # f32: TF32 off, so the GPU and CPU differ by summation order only;
    # bf16 rounds every layer's input to 8 mantissa bits over ~60 layers
    for mode, tol in (("f32", 1e-3), ("bf16", 0.25)):
        hm = results[mode]["heatmaps"][:32].float().cpu()
        emb = torch.as_tensor(results[mode]["embeddings"][:32])
        e_hm = ((hm - hm_cpu).abs().max() / hm_cpu.abs().max()).item()
        e_emb = ((emb - emb_cpu).abs().max() / emb_cpu.abs().max()).item()
        log(f"main path {mode} vs CPU (32 samples): heatmaps max|err|/max "
            f"{e_hm:.3e}, embeddings {e_emb:.3e} (tolerance {tol})")
        if e_hm > tol or e_emb > tol:
            raise AssertionError(f"{mode}: GPU run disagrees with the CPU")
    return counts, rates


def profile_pass(engine, args, mode, top=12):
    """One more warm pass under torch.profiler: device time by kernel, and
    the share of the pass's wall time (profiler overhead included) in
    which the card ran nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.score(*args, keep_heatmaps=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    if not dev:
        log(f"profile {mode}: the profiler recorded no device time "
            "(breakdown not measured)")
        return
    busy = sum(t for _, t, _ in dev)
    log(f"profile {mode}: pass wall {wall_ms:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f}")
    for key, t, count in sorted(dev, key=lambda r: -r[1])[:top]:
        log(f"  {t:9.3f} ms {100 * t / busy:5.1f}% x{count:<4d} {key[:110]}")


def check_outputs(res, n):
    import numpy as np
    shapes = {"coords": (n, 17, 2), "scores": (n, 17), "kpts": (n, 51),
              "oks": (n,), "det_score": (n,), "unc": (n,), "unc2": (n,),
              "gc": (n,), "embeddings": (n, 2048), "bbox_crop": (n, 4)}
    for k, shape in shapes.items():
        v = res[k]
        if v.shape != shape or not np.isfinite(v).all():
            raise AssertionError(f"output {k}: shape {v.shape}, finite "
                                 f"{np.isfinite(v).all()}")
    hm = res["heatmaps"]
    if tuple(hm.shape) != (n, 17, 64, 48) or not hm.isfinite().all():
        raise AssertionError("heatmaps: wrong shape or not finite")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "vatl4pose_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    # parity mode: no TF32 anywhere (the JAX tests pin 'highest')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = 0

    log("== phase 1: card and build")
    card = phase_card_and_build()
    log("== phase 2: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k1 = {"f32": phase_chain_kernel(torch.float32, gen),
          "bf16": phase_chain_kernel(torch.bfloat16, gen)}
    k2 = phase_postprocess_kernel(gen)
    log("== phase 3: main path")
    counts, rates = phase_main_path(seed)

    kernels = []
    for mode in ("f32", "bf16"):
        kernels.append({
            "name": f"fused_bottleneck_chain_{mode}", "route": "cuda",
            "source": "vatl4pose_tpu_torch/csrc/fused_bottleneck.cu",
            "replaces": "vatl4pose_tpu/kernels/fused_bottleneck.py:111",
            "launches": counts[mode]["fused_bottleneck_chain"],
            "max_abs_err": k1[mode]["max_abs_err"], "ms": k1[mode]["ms"],
            "plain_ms": k1[mode]["plain_ms"],
            "bound_ms": k1[mode]["bound_ms"],
            "bound_by": k1[mode]["bound_by"], "library_ms": None})
    kernels.append({
        "name": "heatmap_postprocess_f32", "route": "cuda",
        "source": "vatl4pose_tpu_torch/csrc/postprocess.cu",
        "replaces": "vatl4pose_tpu/kernels/pallas_postprocess.py:129",
        "launches": sum(c["fused_postprocess"] for c in counts.values()),
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None})
    log(json.dumps({"scoring_samples_per_s": rates, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
