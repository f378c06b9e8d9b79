"""The retraining step's share of the card's TF32 tensor-core peak (495
TFLOP/s), in %: 3 x the estimator's forward FLOPs a sample (forward,
and the backward's two products) times the window's real rows a second.
Rows that cycle-pad an epoch's last batch are work the card does and
are not counted."""

from benchmark import chip
from benchmark.flops import forward_flops


def read(ctx):
    return 300.0 * forward_flops(ctx.cfg) * ctx.rate / chip.TF32_FLOPS
