"""The host seconds of the program's span "ldw.prepare"
(`prepare_fast_sweep`: stratify, upload, marginals) in the process, from
`ldweaver_tpu_torch.utils.profiling.totals()`; read after a traced run
on the card."""


def totals(ctx):
    """The program's span totals, or None (an untraced or a CPU run, or a
    program without them)."""
    if ctx.trace is None or not ctx.trace.names:
        return None
    from ldweaver_tpu_torch.utils import profiling

    read_totals = getattr(profiling, "totals", None)
    return None if read_totals is None else read_totals()


def read(ctx):
    t = totals(ctx) or {}
    return t["ldw.prepare"][1] if "ldw.prepare" in t else None
