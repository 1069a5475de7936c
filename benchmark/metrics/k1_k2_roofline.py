"""The share of their roofline (benchmark/counts.py: the window's
long-range pairs) that the traced launches of K1 (rank_mi_kernel) and K2
(fused_tile_kernel) reached, in percent."""

from benchmark import counts, trace


def read(ctx):
    return counts.roofline_pct(ctx, trace.K1, trace.K2)
