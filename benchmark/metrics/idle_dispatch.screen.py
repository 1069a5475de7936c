"""The share of the traced window in which the card is idle while the
host launches the screen's tiles or folds their top-k, in percent: the
window's idle gaps intersected exactly with the union of the program's
ranges "ldw.lr.tile.k1", "ldw.lr.tile.k2" and "ldw.lr.flush"."""

import numpy as np

from benchmark import trace

DISPATCH = ("ldw.lr.tile.k1", "ldw.lr.tile.k2", "ldw.lr.flush")


def union(tr, names):
    """The union of the host ranges named in `names`: sorted disjoint
    (starts, ends), empty when there is none."""
    iv = np.array([(a, b) for n, a, b in tr.ranges if n in names], np.float64).reshape(-1, 2)
    if not iv.size:
        return np.zeros(0), np.zeros(0)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    a, b = iv[:, 0], np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.concatenate([[True], a[1:] > b[:-1]]))
    return a[first], b[np.concatenate([first[1:] - 1, [a.size - 1]])]


def covered(starts, ends, a, b):
    """Seconds of each stretch [a_i, b_i] that the sorted disjoint
    intervals (starts, ends) cover."""
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def upto(t):  # covered seconds before t
        k = np.searchsorted(starts, t, side="right") - 1  # last interval starting by t
        last = np.maximum(k, 0)
        part = cum[last] + np.minimum(t, ends[last]) - starts[last]
        return np.where(k >= 0, part, 0.0)

    return upto(np.asarray(b, np.float64)) - upto(np.asarray(a, np.float64))


def dispatch_idle_s(tr):
    """Idle seconds of the card under a dispatch range; None without one."""
    starts, ends = union(tr, DISPATCH)
    if not starts.size:
        return None
    gaps = np.array(trace.idle_gaps(tr), np.float64).reshape(-1, 2)
    return float(covered(starts, ends, gaps[:, 0], gaps[:, 1]).sum())


def read(ctx):
    if ctx.trace is None or not ctx.trace.names:
        return None
    idle = dispatch_idle_s(ctx.trace)
    return None if idle is None else 100.0 * idle / ctx.trace.window_s
