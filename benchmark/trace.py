"""The traced window: torch.profiler over the window, reduced to the
card's own activity intervals and the host ranges open around them.

Device busy time is the union of the intervals of the card's kernels,
copies and fills inside the window (overlapping streams counted once);
its idle share is the rest of the window.  An idle gap is labelled by the
innermost host range open at its midpoint: the benchmark's own span
around each call and the program's `record_function` ranges."""

from __future__ import annotations

import functools
import re
from typing import List, Tuple

import numpy as np

Interval = Tuple[str, float, float]  # (name, start s, end s)

K1 = re.compile(r"\brank_mi_kernel\b")
K2 = re.compile(r"\bfused_tile_kernel\b")
WINDOW = "bench.window"


class Trace:
    """The card's activities and the host ranges, clipped to the window
    [start, end] (seconds)."""

    def __init__(self, device: List[Interval], ranges: List[Interval], start: float,
                 end: float):
        self.start, self.end = start, end
        self.ranges = [(n, max(a, start), min(b, end)) for n, a, b in ranges
                       if n != WINDOW and b > start and a < end]
        t0 = np.array([a for _, a, _ in device], np.float64)
        t1 = np.array([b for _, _, b in device], np.float64)
        keep = (t1 > start) & (t0 < end)
        self.names = [d[0] for d, k in zip(device, keep) if k]
        self.t0 = np.maximum(t0[keep], start)
        self.t1 = np.minimum(t1[keep], end)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @functools.cached_property
    def union(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of the device intervals: sorted disjoint (starts, ends)."""
        if not self.names:
            return np.zeros(0), np.zeros(0)
        o = np.argsort(self.t0, kind="stable")
        a, b = self.t0[o], np.maximum.accumulate(self.t1[o])
        new = np.concatenate([[True], a[1:] > b[:-1]])
        first = np.flatnonzero(new)
        return a[first], b[np.concatenate([first[1:] - 1, [a.size - 1]])]

    @functools.cached_property
    def by_name(self) -> dict:
        """Device seconds of each activity name."""
        out: dict = {}
        for n, d in zip(self.names, (self.t1 - self.t0).tolist()):
            out[n] = out.get(n, 0.0) + d
        return out


def from_profiler(prof) -> Trace:
    """The window's device intervals and host ranges from a finished
    torch.profiler.profile whose window ran inside a range named
    `WINDOW`.  Reads the profiler's raw events and skips the host's
    operator events (a window holds millions; building the profiler's
    function-event tree takes minutes)."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        cuda, note = e.device_type() == DeviceType.CUDA, e.is_user_annotation()
        if cuda == note:  # a host operator, or a host range mirrored on the card
            continue
        t0 = e.start_ns() / 1e9
        (device if cuda else ranges).append((e.name(), t0, t0 + e.duration_ns() / 1e9))
    windows = [r for r in ranges if r[0] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"trace: {len(windows)} ranges named {WINDOW}")
    return Trace(device, ranges, windows[0][1], windows[0][2])


def make(device, ranges, start: float, end: float) -> Trace:
    return Trace(device, ranges, start, end)


def busy_s(trace: Trace) -> float:
    a, b = trace.union
    return float((b - a).sum())


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The stretches of the window in which nothing ran on the card."""
    a, b = trace.union
    starts = np.concatenate([[trace.start], b])
    ends = np.concatenate([a, [trace.end]])
    return [(float(s), float(e)) for s, e in zip(starts, ends) if e > s]


def label(trace: Trace, at: float) -> str:
    """The innermost host range open at time `at`."""
    open_ = [(b - a, n) for n, a, b in trace.ranges if a <= at <= b]
    return min(open_)[1] if open_ else "outside any range"


def idle_pct(trace: Trace) -> float:
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)


def kernel_s(trace: Trace, *patterns) -> float:
    """Device seconds of the activities whose name matches a pattern."""
    return sum(s for n, s in trace.by_name.items() if any(p.search(n) for p in patterns))


def device_s(trace: Trace) -> float:
    """Device seconds of all activities (overlaps counted twice)."""
    return float((trace.t1 - trace.t0).sum())


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps with what the host was doing."""
    by_key: dict = {}
    for n, s in trace.by_name.items():
        key = re.sub(r"[^A-Za-z0-9_.:<>,-]+", "_", n)[:64]
        by_key[key] = by_key.get(key, 0.0) + s
    ops = sorted(by_key.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return dict(device_ops=[[n, s] for n, s in ops],
                idle_gaps=[[label(trace, (a + b) / 2), b - a] for a, b in gaps])
