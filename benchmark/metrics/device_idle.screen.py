"""The share of the traced window in which no kernel, copy or fill ran
on the card, in percent (the union of the card's activity intervals)."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.names:
        return None
    return trace.idle_pct(ctx.trace)
