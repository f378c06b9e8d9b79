"""K6's share of its roofline in the traced scoring passes, in %: the
bound of the deconvolution stages (benchmark/deconv_bounds.py) for the
configuration's SimplePose head at each chunk of each traced pass, over
the device time of the kernel that computes them
(csrc/fused_bottleneck.cu's subpixel_deconv4x4_kernel).  Nothing where no
such kernel ran."""

from benchmark import deconv_bounds

KERNEL = "subpixel_deconv4x4"


def read(ctx):
    busy = sum(e - s for n, s, e in ctx.trace.kernels if KERNEL in n)
    if busy == 0:
        return None
    layers = deconv_bounds.deconv_layers(ctx.cfg)
    bound = sum(deconv_bounds.k6_bound_s(n, layers) for n in ctx.chunks) \
        * ctx.traced_units
    return 100.0 * bound / (busy / 1e9)
