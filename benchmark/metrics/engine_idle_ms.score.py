"""The card's idle while the host is in the scoring engine's own Python,
in ms a traced pass: the seconds of the traced segment's idle gaps
labelled by any of the program's `score.*` spans (the pass, stage 1, a
chunk's crop geometry and forward, stage 2, the host fetch), x 1000 /
the traced units.

A lower bound: the breakdown labels only the 200 longest gaps and keeps
the ten largest labels, and a gap whose middle falls inside a torch
operation keeps that operation's label.  Nothing where no gap carries a
`score.*` label (a program without the spans)."""

PREFIX = "score."


def read(ctx):
    gaps = [t for n, t in ctx.trace.breakdown["idle_gaps"]
            if n.startswith(PREFIX)]
    return 1e3 * sum(gaps) / ctx.traced_units if gaps else None
