"""The host seconds of the program's spans "ldw.kernel.build" (nvcc, when
a kernel library is stale) and "ldw.kernel.load" (ctypes) in the
process, from `ldweaver_tpu_torch.utils.profiling.totals()`; read after a
traced run on the card."""

import os

from benchmark import harness

SPANS = ("ldw.kernel.build", "ldw.kernel.load")


def read(ctx):
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t = harness.load_module("metrics", "setup_prepare_s", bench).totals(ctx) or {}
    if not any(n in t for n in SPANS):
        return None
    return sum(t[n][1] for n in SPANS if n in t)
