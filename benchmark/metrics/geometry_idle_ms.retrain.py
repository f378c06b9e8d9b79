"""The card's idle while the host draws a retraining call's geometry, in
ms a traced call: the seconds of the traced segment's idle gaps labelled
by the program's `retrain.geometry` span (every step's augmentation and
crop matrices, host numpy), x 1000 / the traced units.

A lower bound: the breakdown labels only the 200 longest gaps and keeps
the ten largest labels, and a gap whose middle falls inside a torch
operation keeps that operation's label.  0.0 where the program's
`retrain.*` spans label some gap but not this one; nothing where none
does (a program without the spans)."""

SPAN = "retrain.geometry"


def read(ctx):
    gaps = [(n, t) for n, t in ctx.trace.breakdown["idle_gaps"]
            if n.startswith("retrain.")]
    if not gaps:
        return None
    return 1e3 * sum(t for n, t in gaps if n == SPAN) / ctx.traced_units
