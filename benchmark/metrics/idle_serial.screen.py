"""The share of the traced window in which the card is idle while no
dispatch range is open (the program's plan, pull and merge of each
call, and everything between calls), in percent: `device_idle.screen`
less `idle_dispatch.screen`."""

import os

from benchmark import harness, trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.names:
        return None
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dispatch = harness.load_module("metrics", "idle_dispatch.screen", bench)
    idle = dispatch.dispatch_idle_s(ctx.trace)
    if idle is None:
        return None
    return trace.idle_pct(ctx.trace) - 100.0 * idle / ctx.trace.window_s
