"""Readings of the benchmark's `simplepose_r50` configuration on the card,
beside the cell's own runs (benchmark/run.py), on the cell's seeded
weights and the first chunk of 512 crops of its score video:

  k6        each of the three deconvolution stages (ConvTranspose2d
            4x4/2/1, eval BN, ReLU) on its own input, as the module graph
            hands it on: K6's max|err|/max from a float64 stage (cuDNN in
            f64) beside the module graph's in f32 (cuDNN, TF32 off); the
            wrapper's time (the weights' split and the product; CUDA
            events, median of 20) and each of its kernels' device time
            (torch.profiler) beside its bound (benchmark/deconv_bounds.py);
            the plain version's time, the module graph's stage and its
            ConvTranspose2d alone (median of 5) with their largest kernels;
  head      `final_layer` (1x1, 256 -> 17) on K6's channels-last output
            and on an NCHW copy of it (the copy's time apart), and the
            whole head through K6 and through the module graph;
  k5        SHA-256 digests of K5's outputs (kernels/duc_conv.py) at
            FastPose's two DUC shapes at N = 512, on the operands of
            tests/test_torch_duc.py; --root points at another checkout
            whose K5 makes them.

    python3 scripts/simplepose_probe.py [k6] [head] [k5]
        [--seed N] [--root DIR]

Prints one JSON line a reading.
"""

import argparse
import hashlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "simplepose_r50.score"


def emit(row):
    print(json.dumps(row), flush=True)


def cuda_ms(fn, reps):
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def top_kernels(fn, reps=1, n=3):
    """(ms a call, name) of fn's largest device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.self_device_time_total / 1e3 / reps, e.key[:90])
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)[:n]


def k5_digests(n=512):
    """{case: SHA-256 of K5's f32 output bytes} at FastPose's two DUC
    shapes at batch n, on tests/test_torch_duc.py's seeded operands
    (made on the CPU, so that any card gets the same ones)."""
    import torch
    from tests.test_torch_duc import SHAPES, duc, stream
    from vatl4pose_tpu_torch.kernels import fold_bn_module, shuffle_conv3x3
    out = {}
    with torch.no_grad():
        for cin, cout, h, w in SHAPES:
            m = duc(cin, cout, seed=cin + n, device="cuda")
            x = stream(n, cin, h, w, seed=n, device="cuda")
            y = shuffle_conv3x3(x.permute(0, 2, 3, 1).contiguous(),
                                m.conv.weight, *fold_bn_module(m.bn))
            out[f"{cin}->{cout} at {h}x{w}, N={n}"] = hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()
            del m, x, y
            torch.cuda.empty_cache()
    return out


def chunk(seed):
    """The seeded model (fused eval, eval mode) and its first chunk of
    512 crops of the score video (the plain reference's crops)."""
    import torch
    from benchmark import core, port
    from benchmark.reference import scoring as ref
    from benchmark.video import make_video
    _, _, cfg, traffic, _ = core.load_spec(CELL)
    dev = torch.device("cuda")
    video = make_video(traffic["video"], seed, dev)
    model, _ = port.build_models(cfg, seed, dev, with_ae=False)
    size = tuple(cfg["DATA_PRESET"]["IMAGE_SIZE"])
    boxes = torch.as_tensor(video.bboxes[:512], device=dev)
    mats, _ = ref.crop_geometry(boxes, size)
    fi = torch.as_tensor(video.frame_idx[:512], device=dev)
    x = ref.crops(video.frames, fi, mats, size).permute(0, 3, 1, 2)
    return cfg, model.eval(), x


def stage_f64(conv, bn, x):
    """A deconvolution stage in float64, NHWC."""
    import torch
    y = torch.nn.functional.conv_transpose2d(
        x.double(), conv.weight.double(), stride=2, padding=1)
    s = bn.weight.double() * torch.rsqrt(bn.running_var.double() + bn.eps)
    b = bn.bias.double() - bn.running_mean.double() * s
    return torch.relu(y * s[:, None, None] + b[:, None, None]) \
        .permute(0, 2, 3, 1)


def probe_k6(seed):
    import torch
    from benchmark import deconv_bounds
    from vatl4pose_tpu_torch.kernels import (fold_bn_module,
                                             subpixel_deconv4x4,
                                             subpixel_deconv4x4_reference)
    cfg, model, x = chunk(seed)
    layers = model.deconv_layers
    total = {"k6_ms": 0.0, "bound_ms": 0.0, "module_ms": 0.0}
    with torch.no_grad():
        x = model.backbone(x)
        for i, shape in enumerate(deconv_bounds.deconv_layers(cfg)):
            conv, bn, relu = layers[3 * i:3 * i + 3]
            s, b = fold_bn_module(bn)
            w = conv.weight
            xs = x.permute(0, 2, 3, 1).contiguous()
            exact = stage_f64(conv, bn, x)
            scale = exact.abs().max().item()
            graph = relu(bn(conv(x)))
            got = {"K6": subpixel_deconv4x4(xs, w, s, b),
                   "module graph": graph.permute(0, 2, 3, 1)}
            dist = {k: (v.double() - exact).abs().max().item() / scale
                    for k, v in got.items()}
            del exact, got
            k6 = cuda_ms(lambda: subpixel_deconv4x4(xs, w, s, b), 20)
            kernels = top_kernels(lambda: subpixel_deconv4x4(xs, w, s, b), 5)
            plain = cuda_ms(
                lambda: subpixel_deconv4x4_reference(xs, w, s, b), 5)
            stage = cuda_ms(lambda: relu(bn(conv(x))), 5)
            alone = cuda_ms(lambda: conv(x), 5)
            lib_kernels = top_kernels(lambda: relu(bn(conv(x))))
            bound = deconv_bounds.k6_bound_s(512, [shape]) * 1e3
            for k, v in (("k6_ms", k6), ("bound_ms", bound),
                         ("module_ms", stage)):
                total[k] += v
            emit({"probe": "k6", "stage": i + 1, "shape": [512, *shape],
                  "input_channels_last":
                      x.is_contiguous(memory_format=torch.channels_last),
                  "dist_from_f64": dist, "k6_ms": k6,
                  "k6_kernels_ms": kernels, "bound_ms": bound,
                  "share": bound / k6,
                  "plain_ms": plain, "module_stage_ms": stage,
                  "module_deconv_ms": alone, "module_kernels_ms": lib_kernels})
            x = graph
            del xs
            torch.cuda.empty_cache()
    emit({"probe": "k6", "stage": "all 3", **total,
          "share": total["bound_ms"] / total["k6_ms"]})


def probe_head(seed):
    import torch
    from vatl4pose_tpu_torch.kernels import (fold_bn_module,
                                             subpixel_deconv4x4)
    _, model, x = chunk(seed)
    fl = model.final_layer
    with torch.no_grad():
        feat = model.backbone(x)
        fused = model.head(feat)
        model.fused_eval = False
        graph = model.head(feat)
        model.fused_eval = True
        gap = ((fused - graph).abs().max() / graph.abs().max()).item()
        # K6's last stage output, as the head hands it to final_layer
        t = feat.permute(0, 2, 3, 1).contiguous()
        layers = model.deconv_layers
        for i in range(3):
            t = subpixel_deconv4x4(t, layers[3 * i].weight,
                                   *fold_bn_module(layers[3 * i + 1]))
        cl = t.permute(0, 3, 1, 2)
        nchw = cl.contiguous()
        row = {"probe": "head", "fused_vs_graph": gap,
               "final_nhwc_ms": cuda_ms(lambda: fl(cl), 20),
               "final_nhwc_kernels": top_kernels(lambda: fl(cl)),
               "nchw_copy_ms": cuda_ms(lambda: cl.contiguous(), 20),
               "final_nchw_ms": cuda_ms(lambda: fl(nchw), 20),
               "final_nchw_kernels": top_kernels(lambda: fl(nchw)),
               "head_k6_ms": cuda_ms(lambda: model.head(feat), 10)}
        model.fused_eval = False
        row["head_graph_ms"] = cuda_ms(lambda: model.head(feat), 5)
        model.fused_eval = True
    emit(row)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("probes", nargs="+",
                    choices=("k6", "head", "k5"))
    ap.add_argument("--seed", type=int, default=3000000011)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose port runs (k5)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from benchmark import chip, port
    port.setup_precision("f32")
    port.build_kernels()
    emit({"card": chip.power_limit(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "root": args.root})
    for p in args.probes:
        if p == "k6":
            probe_k6(args.seed)
        elif p == "head":
            probe_head(args.seed)
        else:
            emit({"probe": "k5", "digests": k5_digests()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
