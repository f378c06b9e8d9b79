"""Share of the traced retraining call in which the card ran nothing:
1 - (union of every device activity's interval) / the segment's span."""


def read(ctx):
    t = ctx.trace
    return 1.0 - t.busy_s / t.window_s if t.busy_s > 0 else None
