"""Optional profiler traces (the JAX package's utils/profiling.py, on
torch.profiler).

Set LDW_PROFILE=/path/to/tracedir to write a Chrome trace of the BLK5
sweep (`maybe_trace("blk5_sweep")` in core/sweep.py) to
<tracedir>/<region>/trace.json; the fast backend's dispatch and finish
show in it as the ranges "fast_dispatch" and "fast_finish" (`annotate`).
Without the variable nothing is traced or written.
"""

from __future__ import annotations

import contextlib
import os

import torch


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


def annotate(name: str):
    """Named sub-region inside a trace (a torch.profiler range); costs a
    few microseconds without an active profiler."""
    return torch.profiler.record_function(name)
