"""Readings of the benchmark's `fastpose_dcn_r50` configuration on the
card, beside the cell's own runs (benchmark/run.py):

  k4        the deformable im2col kernel K4 at the configuration's 13
            deformable 3x3s at a chunk of 512: its columns against the
            eager route's bit for bit, its time (CUDA events, median of
            20 launches) beside its bound (benchmark/dcn_bounds.py) and
            the eager route's time (median of 5);
  k5        the DUC kernel K5 at the configuration's two DUCs at a chunk
            of 512 (He-scaled weights, random BN statistics, the inputs in
            the memory format the eager head gives them): the wrapper's
            time (the weights' split and the product; CUDA events, median
            of 20) and each of its kernels' device time (torch.profiler),
            beside its bound (benchmark/duc_bounds.py), the plain
            version's time, the eager DUC's and its cuDNN convolution's
            alone (median of 5), and K5's max|err|/max from the eager DUC;
  stages    one chunk of 512 through the fused eval model stage by stage
            (stem, layer1-4, the DUCs, conv_out on its NCHW input, as
            `FastPose.head` feeds it): each stage's time (CUDA
            events, median of 5) and its three largest device kernels
            (torch.profiler).

    python3 scripts/fastpose_dcn_probe.py [k4] [k5] [stages] [--seed N]

Prints one JSON line a reading.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELL = "fastpose_dcn_r50.score"


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


def probe_k4(seed):
    import torch
    from benchmark import core, dcn_bounds
    from vatl4pose_tpu_torch.kernels import deform_columns, deform_im2col
    cfg = core.load_spec(CELL)[2]
    g = torch.Generator(device="cuda").manual_seed(seed)
    total = {"k4_ms": 0.0, "eager_ms": 0.0, "bound_ms": 0.0}
    for i, conv in enumerate(dcn_bounds.dcn_convs(cfg)):
        C, H, W, Ho, Wo, s, G, _ = conv
        x = torch.randn((512, C, H, W), device="cuda", generator=g).relu() \
            .contiguous(memory_format=torch.channels_last)
        off = (torch.randn((512, 18 * G, Ho, Wo), device="cuda",
                           generator=g) * 1.5) \
            .contiguous(memory_format=torch.channels_last)
        same = torch.equal(deform_im2col(x, off, 3, s, 1),
                           deform_columns(x, off, 3, s, 1))
        k4 = cuda_ms(lambda: deform_im2col(x, off, 3, s, 1), 20)
        eager = cuda_ms(lambda: deform_columns(x, off, 3, s, 1), 5)
        bound = dcn_bounds.k4_bound_s(512, [conv]) * 1e3
        for k, v in (("k4_ms", k4), ("eager_ms", eager), ("bound_ms", bound)):
            total[k] += v
        emit({"probe": "k4", "conv": i, "shape": conv, "bit_for_bit": same,
              "k4_ms": k4, "eager_ms": eager, "bound_ms": bound,
              "share": bound / k4})
        del x, off
        torch.cuda.empty_cache()
    emit({"probe": "k4", "conv": "all 13", **total,
          "share": total["bound_ms"] / total["k4_ms"]})


def probe_k5(seed):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from benchmark import core, duc_bounds
    from vatl4pose_tpu_torch.kernels import (fold_bn_module, shuffle_conv3x3,
                                             shuffle_conv3x3_reference)
    from vatl4pose_tpu_torch.models.layers import DUC
    cfg = core.load_spec(CELL)[2]
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the eager head's input: the backbone's channels-last feature
    # shuffled; duc2's: duc1's eager output
    x = torch.nn.functional.pixel_shuffle(
        torch.randn((512, 2048, 8, 6), device="cuda", generator=g).relu()
        .contiguous(memory_format=torch.channels_last), 2)
    total = {"k5_ms": 0.0, "bound_ms": 0.0}
    for i, (cin, cout, h, w) in enumerate(duc_bounds.duc_convs(cfg)):
        m = DUC(cin, cout).cuda().eval()
        with torch.no_grad():
            m.conv.weight.copy_(torch.randn(m.conv.weight.shape,
                                            device="cuda", generator=g)
                                * (2.0 / (9 * cin)) ** 0.5)
            m.bn.running_var.uniform_(0.5, 1.5)
            m.bn.running_mean.normal_(0, 0.1)
            s, b = fold_bn_module(m.bn)
            xs = x.permute(0, 2, 3, 1).contiguous()
            wt = m.conv.weight
            eager = m(x)
            got = shuffle_conv3x3(xs, wt, s, b)
            gap = ((got.permute(0, 3, 1, 2) - eager).abs().max()
                   / eager.abs().max()).item()
            k5 = cuda_ms(lambda: shuffle_conv3x3(xs, wt, s, b), 20)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    shuffle_conv3x3(xs, wt, s, b)
                torch.cuda.synchronize()
            kernels = {e.key[:60]: e.self_device_time_total / 1e3 / 5
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0}
            plain = cuda_ms(lambda: shuffle_conv3x3_reference(xs, wt, s, b),
                            5)
            whole = cuda_ms(lambda: m(x), 5)
            library = cuda_ms(lambda: m.conv(x), 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                m.conv(x)
                torch.cuda.synchronize()
            lib_kernels = sorted(((e.self_device_time_total / 1e3, e.key[:90])
                                  for e in prof.key_averages()
                                  if e.self_device_time_total > 0),
                                 reverse=True)[:3]
        bound = duc_bounds.k5_bound_s(512, [(cin, cout, h, w)]) * 1e3
        total["k5_ms"] += k5
        total["bound_ms"] += bound
        emit({"probe": "k5", "duc": i + 1, "shape": [512, cin, cout, h, w],
              "input_channels_last":
                  x.is_contiguous(memory_format=torch.channels_last),
              "k5_ms": k5, "k5_kernels_ms": kernels, "bound_ms": bound,
              "share": bound / k5, "plain_ms": plain, "eager_duc_ms": whole,
              "library_conv_ms": library, "library_kernels_ms": lib_kernels,
              "tflops": 2 * 512 * cin * 9 * cout * h * w / k5 / 1e9,
              "max_rel_gap_vs_eager": gap})
        x = eager
        del m, xs, got
        torch.cuda.empty_cache()
    emit({"probe": "k5", "duc": "both", **total,
          "share": total["bound_ms"] / total["k5_ms"]})


def _chunk(seed):
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
    return model.eval(), x


def probe_stages(seed):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vatl4pose_tpu_torch.models.resnet import _fused_tail
    model, x = _chunk(seed)
    pre = model.preact

    def layer(li):
        blocks = getattr(pre, f"layer{li + 1}")
        if pre.fused_eval and not pre.stage_dcn[li]:
            return lambda t: _fused_tail(blocks[0](t), blocks[1:])
        return blocks

    stages = [("stem", lambda t: pre.maxpool(torch.relu(pre.bn1(
        pre.conv1(t.contiguous(memory_format=torch.channels_last))))))]
    stages += [(f"layer{li + 1}", layer(li)) for li in range(4)]
    stages += [("suffle1+duc1", lambda t: model.duc1(model.suffle1(t))),
               ("duc2", model.duc2),
               ("conv_out", lambda t: model.conv_out(t.contiguous()))]
    with torch.no_grad():
        for name, fn in stages:
            ms = cuda_ms(lambda: fn(x), 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x)
                torch.cuda.synchronize()
            top = sorted(((e.self_device_time_total / 1e3, e.key[:90])
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0), reverse=True)
            emit({"probe": "stages", "stage": name, "ms": ms,
                  "top_kernels_ms": top[:3]})
            x = fn(x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("probes", nargs="+", choices=("k4", "k5", "stages"))
    ap.add_argument("--seed", type=int, default=3000000011)
    args = ap.parse_args(argv)
    import torch
    from benchmark import chip, port
    port.setup_precision("f32")
    port.build_kernels()
    emit({"card": chip.power_limit(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    for p in args.probes:
        if p == "k4":
            probe_k4(args.seed)
        elif p == "k5":
            probe_k5(args.seed)
        else:
            probe_stages(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
