"""The program's spans and optional profiler traces (the JAX package's
utils/profiling.py, on torch.profiler).

`span(name)` times one step of the program.  Every span adds one to its
name's count and its host duration to its name's total, kept in memory
for the process (`totals()`, `reset()`).  Only while a torch profiler is
recording does it also open a `record_function` range of the same name,
which the profiler stamps on the clock of the card's kernels and copies;
otherwise it makes no dispatcher call.  A span's parent is the span open
around it on the thread.  The program's spans are named `ldw.*`: one
screen call is `ldw.lr_topk` (PERF.md lists them all).

Set LDW_PROFILE=/path/to/tracedir to write a Chrome trace of the BLK5
sweep (`maybe_trace("blk5_sweep")` in core/sweep.py) to
<tracedir>/<region>/trace.json; the fast backend's dispatch and finish
show in it as the spans "ldw.blk5.dispatch" and "ldw.blk5.finish".
Without the variable nothing is traced or written.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Tuple

import torch

_lock = threading.Lock()
# name -> [count, host nanoseconds]
_totals: Dict[str, List[int]] = {}


@contextlib.contextmanager
def maybe_trace(region: str):
    """Trace the region when LDW_PROFILE is set; no-op otherwise."""
    base = os.environ.get("LDW_PROFILE")
    if not base:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(base, region)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


class span:
    """`with span(name):` counts and times the block on the host clock,
    and is a profiler range of that name while a profiler records."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                _totals[self.name] = [1, dt]
            else:
                tot[0] += 1
                tot[1] += dt
        return False


def totals() -> Dict[str, Tuple[int, float]]:
    """{span name: (count, host seconds)} since the process started or
    the last `reset()`."""
    with _lock:
        return {n: (c, ns / 1e9) for n, (c, ns) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
