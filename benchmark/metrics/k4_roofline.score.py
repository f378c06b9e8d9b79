"""K4's share of its roofline in the traced scoring passes, in %: the
bound of the deformable im2col (benchmark/dcn_bounds.py) for the
configuration's deformable 3x3s at each chunk of each traced pass, over
the device time of the kernel that writes their columns
(csrc/deform_im2col.cu's deform_im2col_kernel).  Nothing where no such
kernel ran."""

from benchmark import dcn_bounds

KERNEL = "deform_im2col"


def read(ctx):
    busy = sum(e - s for n, s, e in ctx.trace.kernels if KERNEL in n)
    if busy == 0:
        return None
    convs = dcn_bounds.dcn_convs(ctx.cfg)
    bound = sum(dcn_bounds.k4_bound_s(n, convs) for n in ctx.chunks) \
        * ctx.traced_units
    return 100.0 * bound / (busy / 1e9)
