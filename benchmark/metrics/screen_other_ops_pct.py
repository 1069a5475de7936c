"""The card's time in the traced window outside K1 and K2 (masks,
top-k, merges, sorts, copies) as a share of its busy time, in percent."""

from benchmark import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.names:
        return None
    other = trace.device_s(ctx.trace) - trace.kernel_s(ctx.trace, trace.K1, trace.K2)
    return 100.0 * other / trace.busy_s(ctx.trace)
