"""The scoring pass's share of the card's TF32 tensor-core peak (495
TFLOP/s, the highest rate at which it multiplies f32 inputs), in %: the
estimator's forward FLOPs a sample, counted from the configuration's
layer shapes, times the window's samples/s."""

from benchmark import chip
from benchmark.flops import forward_flops


def read(ctx):
    return 100.0 * forward_flops(ctx.cfg) * ctx.rate / chip.TF32_FLOPS
