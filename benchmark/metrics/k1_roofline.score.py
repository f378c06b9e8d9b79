"""K1's share of its roofline in the traced scoring passes, in %: the
bound of the fused bottleneck chain (benchmark/bounds.py) for the ResNet
stage tails at each chunk of each traced pass, over the device time of
the kernel that computes them (csrc/fused_bottleneck.cu's
conv_gemm_kernel).  Nothing where no such kernel ran."""

from benchmark import bounds

KERNEL = "conv_gemm_kernel"


def read(ctx):
    busy = sum(e - s for n, s, e in ctx.trace.kernels if KERNEL in n)
    if busy == 0:
        return None
    tails = bounds.resnet_tails(ctx.cfg["MODEL"].get("NUM_LAYERS", 50),
                                ctx.cfg["DATA_PRESET"]["IMAGE_SIZE"])
    bound = sum(bounds.k1_bound_s(n, tails) for n in ctx.chunks) \
        * ctx.traced_units
    return 100.0 * bound / (busy / 1e9)
