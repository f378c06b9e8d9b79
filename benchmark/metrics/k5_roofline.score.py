"""K5's share of its roofline in the traced scoring passes, in %: the
bound of the DUC convolutions (benchmark/duc_bounds.py) for the
configuration's two DUCs at each chunk of each traced pass, over the
device time of the kernel that computes them (csrc/fused_bottleneck.cu's
shuffle_conv3x3_kernel).  Nothing where no such kernel ran."""

from benchmark import duc_bounds

KERNEL = "shuffle_conv3x3"


def read(ctx):
    busy = sum(e - s for n, s, e in ctx.trace.kernels if KERNEL in n)
    if busy == 0:
        return None
    convs = duc_bounds.duc_convs(ctx.cfg)
    bound = sum(duc_bounds.k5_bound_s(n, convs) for n in ctx.chunks) \
        * ctx.traced_units
    return 100.0 * bound / (busy / 1e9)
