"""pairs_per_s: the SNP pairs of every call in the window over the
window's time (its start to the end of its last call)."""


def read(ctx):
    pairs = [rec["pairs"] for rec in ctx.records if "pairs" in rec]
    return sum(pairs) / ctx.window_s if pairs else None
