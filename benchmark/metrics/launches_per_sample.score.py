"""Kernel launches (device activities other than copies and sets) in the
traced scoring passes, per sample scored."""


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.traced_samples if n else None
