"""The host's milliseconds a call inside the program's ranges
"ldw.lr.tile.k1", "ldw.lr.tile.k2" and "ldw.lr.flush" (their union over
the traced window, over the window's calls): the host's time to launch a
call's tiles and folds, to set beside the card's time a call."""

import os

from benchmark import harness


def read(ctx):
    if ctx.trace is None or not ctx.trace.names or not ctx.records:
        return None
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dispatch = harness.load_module("metrics", "idle_dispatch.screen", bench)
    starts, ends = dispatch.union(ctx.trace, dispatch.DISPATCH)
    if not starts.size:
        return None
    return 1e3 * float((ends - starts).sum()) / len(ctx.records)
