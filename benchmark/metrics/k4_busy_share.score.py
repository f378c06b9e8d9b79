"""K4's share of the card's busy time in the traced scoring passes, in %:
the device time of the deformable im2col kernel (csrc/deform_im2col.cu's
deform_im2col_kernel) over the union of every device activity's interval.
Nothing where no such kernel ran."""

KERNEL = "deform_im2col"


def read(ctx):
    busy = sum(e - s for n, s, e in ctx.trace.kernels if KERNEL in n)
    if busy == 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (busy / 1e9) / ctx.trace.busy_s
