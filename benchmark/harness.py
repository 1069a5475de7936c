"""One run of one cell of `BENCHMARK.json`, found by name.

A cell `<config>.<traffic>` names a configuration (`configs/<config>.json`
through its entry in BENCHMARK.json) and a traffic mix
(`traffic/<traffic>.json`); the mix names the entry that drives the
program (`entries/<entry>.py`).  Every metric is a reader of its own,
`metrics/<metric>.py`, and a cell's correctness limits are
`limits/<cell>.json`.  Adding a cell, a configuration, a mix, an entry
or a metric adds files and BENCHMARK.json entries; no file here changes.

A run: check the cards, draw the inputs from the seed, set up (the
entry's preparation and warm-up of the cell's own shapes), then call the
entry back to back while the window is open (a call starts only while it
is open; the last one runs to its end), read the peak memory, free the
program's state, compare with the reference, and print the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
PROGRAM = "ldweaver_tpu_torch"
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "ldweaver_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


class NoCards(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: dict
    config: dict
    traffic: dict
    inputs: Any
    records: List[dict]
    setup_s: float
    window_s: float
    peak_bytes: int
    trace: Any = None  # trace.Trace of a traced run


def load_spec(bench: str = BENCH) -> dict:
    with open(os.path.join(os.path.dirname(bench), "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, bench: str = BENCH):
    """`<bench>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str, bench: str = BENCH):
    """(cell, config, traffic, limits) of workload `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(os.path.dirname(bench), configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(bench, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(bench, "limits", f"{name}.json"))
    return cell, config, traffic, limits


def metric_names(spec: dict, cell_name: str, traced: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones untraced,
    the per-layer ones traced; each where its `workloads` list names the
    cell, or everywhere without one (a per-layer metric without one:
    wherever its `moves` metric is reported)."""
    def listed(m):
        return cell_name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in spec["end_to_end"] if listed(m) is not False]
    if not traced:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if listed(m) or (listed(m) is None and m["moves"] in e2e_names)]


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCards("no CUDA device is available")
    if torch.cuda.device_count() < n:
        raise NoCards(f"the cell needs {n} card(s); {torch.cuda.device_count()} found")


def check_program(root: str = ROOT) -> None:
    """The program is the checkout's own package."""
    import importlib

    mod = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.abspath(mod.__file__))
    if os.path.dirname(where) != os.path.abspath(root):
        raise RuntimeError(f"{PROGRAM} loaded from {where}, not from {root}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(cache: str = CACHE) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program might use (the port's kernels build into its own `_build/`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(entry, state, seconds: float, device, span: str) -> tuple:
    """Call the entry back to back while the window is open -> (records,
    window seconds).  Each record gets its start in the window and its
    wall time."""
    import torch

    records = []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        if records and a - t0 >= seconds:
            break
        with torch.profiler.record_function(span):
            rec = entry.run(state)
            sync(device)
        b = time.perf_counter()
        rec.update(start_s=a - t0, wall_s=b - a)
        records.append(rec)
    return records, time.perf_counter() - t0


def judge(checks) -> tuple:
    """(correct, {name: {value, limit}}) of (name, value, limit) triples:
    each value has to be a number no larger than its limit."""
    table = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in checks}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in table.values())
    return ok and bool(table), table


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: Optional[float] = None, bench: str = BENCH,
             traffic_override: Optional[dict] = None) -> dict:
    """One run of cell `name` -> the result line's object (printed by
    `main`).  `device="cpu"` runs the same path without a card, for the
    tests; such a run reports no device numbers."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(bench)
    cell, config, traffic, limits = find_cell(spec, name, bench)
    traffic = dict(traffic, **(traffic_override or {}), seed=seed, limits={
        k: v["limit"] for k, v in limits.items() if isinstance(v, dict)})
    cuda = torch.device(device).type == "cuda"
    if cuda:
        require_cards(int(cell["chips"]))
    check_program()
    set_cache_dirs()
    entry = load_module("entries", traffic["entry"], bench)
    gen = load_module("gen", traffic.get("generator", "synth"), bench)
    inputs = gen.make_inputs(config, seed, device)
    if cuda:
        torch.cuda.empty_cache()
    state = entry.setup(inputs, config, traffic, device)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with (profile(activities=acts) if traced else contextlib.nullcontext()) as prof:
        with torch.profiler.record_function(tr.WINDOW):
            records, window_s = run_window(entry, state, seconds, device,
                                           f"bench.{traffic['entry']}")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    trace = tr.from_profiler(prof) if traced else None
    del prof
    entry.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, readings, failed = entry.check(state, records, device)
    correct, table = judge(checks)
    ctx = Context(cell=cell, config=config, traffic=traffic, inputs=inputs,
                  records=records, setup_s=setup_s, window_s=window_s,
                  peak_bytes=peak, trace=trace)
    metrics = {}
    for m in metric_names(spec, name, traced):
        value = load_module("metrics", m["name"], bench).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(records), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev.update(busy_s=tr.busy_s(trace), window_s=trace.window_s)
        out["breakdown"] = tr.breakdown(trace)
    out["readings"] = readings
    out["checks"] = table
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except NoCards as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that a run may not load: {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
