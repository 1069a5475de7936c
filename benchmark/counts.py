"""The roofline arithmetic: the least time one H100 could take for the
MI of a set of SNP pairs, from the generated inputs alone.

Operations: 2 S (r_i - 1)(r_j - 1) for each needed pair (i, j), S the
genomes and r a site's distinct alleles: the joint counts of the
(r_i - 1)(r_j - 1) allele pairs that the marginals do not give.  What
implements it (buckets, padding, weight terms) is not counted, so the
count is the same work whatever computes it.

Bytes: the allele codes (one byte a genome and a site) read once and one
float32 MI a needed pair written once.

Bound: the larger of the operations at the bf16 dense tensor-core peak
and the bytes at the HBM bandwidth (NVIDIA H100 SXM data sheet; those
rates assume the card's full 700 W, so every reading is printed beside
the card's power limit).
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM


def _short_range_sums(a: np.ndarray, pos: np.ndarray, g: int, sr_dist: int):
    """(sum over pairs at circular distance <= sr_dist of a_i a_j, their
    number): each pair is counted once, from the site whose forward
    distance to the other is in (0, sr_dist] (sr_dist < g / 2)."""
    order = np.argsort(pos, kind="stable")
    p, a = pos[order].astype(np.int64), a[order]
    p2 = np.concatenate([p, p + g])
    a2 = np.concatenate([a, a])
    c = np.concatenate([[0.0], np.cumsum(a2)])
    hi = np.searchsorted(p2, p + sr_dist, side="right")
    idx = np.arange(p.size)
    return float((a * (c[hi] - c[idx + 1])).sum()), int((hi - idx - 1).sum())


def needed_work(r: np.ndarray, nseq: int, needed: str, pos=None, g=None,
                sr_dist=None):
    """(operations, bytes) of one pass over the `needed` pairs: "all"
    pairs of distinct sites, or the "long_range" ones (circular distance
    above sr_dist)."""
    a = np.asarray(r, np.float64) - 1.0
    n = a.size
    prod = (a.sum() ** 2 - (a * a).sum()) / 2.0
    pairs = n * (n - 1) // 2
    if needed == "long_range":
        sr_prod, sr_pairs = _short_range_sums(a, np.asarray(pos), int(g), int(sr_dist))
        prod -= sr_prod
        pairs -= sr_pairs
    elif needed != "all":
        raise ValueError(f"unknown set of pairs: {needed}")
    return 2.0 * nseq * prod, float(nseq * n + 4 * pairs)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time in seconds: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def window_bound_s(ctx) -> float:
    """The least time of the needed work of every call in the
    window (each record names its set of pairs in `needed`)."""
    inputs = ctx.inputs
    r = (inputs.acgtn > 0).sum(axis=0)
    sr_dist = int(ctx.traffic.get("sr_dist", ctx.config["sr_dist"]))
    per = {}
    total = 0.0
    for rec in ctx.records:
        kind = rec["needed"]
        if kind not in per:
            per[kind] = bound_s(*needed_work(r, inputs.nseq, kind, inputs.pos, inputs.g,
                                             sr_dist))
        total += per[kind]
    return total


def roofline_pct(ctx, *patterns):
    """The share of their roofline that the traced launches of the
    kernels matching `patterns` reached: the window's least time over
    their device time, in percent (None without a trace or a launch)."""
    from benchmark import trace as tr

    if ctx.trace is None:
        return None
    spent = tr.kernel_s(ctx.trace, *patterns)
    return 100.0 * window_bound_s(ctx) / spent if spent > 0 else None
