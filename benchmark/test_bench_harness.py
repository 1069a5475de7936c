"""CPU tests of the benchmark's harness, readers, counts and reference.

    python -m pytest benchmark/test_bench_harness.py -q

They run the harness's whole path on the CPU at tiny sizes (a copy of
the benchmark's files with tiny configurations), never through the
command, which needs a card.  The test marked `cuda` runs a cell on the
card and skips without one.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import counts, harness, trace
from benchmark.reference.mi import Sites, mi_pairs, mi_tile

ROOT = harness.ROOT
TINY = {  # cell -> (config, config overrides, traffic, limits of the cell at full size)
    "tiny.screen": ("spn616", dict(n_genomes=256, n_snps=8192, block=2048), "screen",
                    "spn616.screen"),
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A copy of the benchmark's files with the tiny cells of TINY (the
    same entries, generator, traffic and readers; limits as committed for
    the real cell of the same traffic)."""
    root = tmp_path_factory.mktemp("bench")
    b = root / "benchmark"
    b.mkdir()
    for d in ("entries", "metrics", "gen", "traffic"):
        shutil.copytree(os.path.join(harness.BENCH, d), b / d)
    (b / "configs").mkdir()
    (b / "limits").mkdir()
    spec = harness.load_spec()
    configs, cells = [], []
    for cell, (base, over, traffic, full) in TINY.items():
        name = cell.split(".")[0]
        with open(os.path.join(harness.BENCH, "configs", f"{base}.json")) as fh:
            cfg = dict(json.load(fh), name=name, **over)
        (b / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append(dict(name=name, source="test", file=f"benchmark/configs/{name}.json",
                            reduced=[], why="test"))
        cells.append(dict(name=cell, config=name, traffic=traffic, chips=1, why="test"))
        with open(os.path.join(harness.BENCH, "limits", f"{full}.json")) as fh:
            limits = json.load(fh)
        (b / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.screen"]
    spec.update(configs=configs, workloads=cells)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(b)


def run(bench, cell, seed=20261018, seconds=1.0, traced=False, **kw):
    return harness.run_cell(cell, seed, seconds, traced, device="cpu", bench=bench, **kw)


# --------------------------------------------------------------------------
# found by name
# --------------------------------------------------------------------------
def test_every_cell_metric_and_file_is_found_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell, config, traffic, limits = harness.find_cell(spec, w["name"])
        assert set(config["reduced"]) == set(
            next(c["reduced"] for c in spec["configs"] if c["name"] == w["config"]))
        harness.load_module("entries", traffic["entry"])
        entry = harness.load_module("entries", traffic["entry"])
        numbers = {k for k, v in limits.items() if isinstance(v, dict)}
        assert numbers == set(entry.NUMBERS)
        assert all(v["limit"] is not None for k, v in limits.items() if k in numbers)
        for m in harness.metric_names(spec, w["name"], False) + harness.metric_names(
                spec, w["name"], True):
            assert callable(harness.load_module("metrics", m["name"]).read)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))
    # every limits file, also of a cell not in BENCHMARK.json yet, names
    # exactly its entry's numbers
    for f in os.listdir(os.path.join(harness.BENCH, "limits")):
        config, traffic = f[: -len(".json")].split(".")
        entry = harness.load_module("entries", harness.load_json(
            os.path.join(harness.BENCH, "traffic", f"{traffic}.json"))["entry"])
        limits = harness.load_json(os.path.join(harness.BENCH, "limits", f))
        assert {k for k, v in limits.items() if isinstance(v, dict)} == set(entry.NUMBERS)
        assert os.path.exists(os.path.join(harness.BENCH, "configs", f"{config}.json"))


def test_new_files_are_taken_up_without_editing_any(bench, tmp_path):
    """A new configuration, traffic mix, entry and metric, as new files and
    BENCHMARK.json entries only, run through the harness."""
    root = tmp_path / "root"
    shutil.copytree(os.path.dirname(bench), root)
    b = root / "benchmark"
    before = {p: p.read_bytes() for p in b.rglob("*") if p.is_file()}
    cfg = json.loads((b / "configs" / "tiny.json").read_text())
    (b / "configs" / "mini.json").write_text(json.dumps(dict(cfg, name="mini", n_snps=4096)))
    (b / "traffic" / "count.json").write_text(json.dumps({"entry": "count", "limit": 1}))
    (b / "entries" / "count.py").write_text(
        "def setup(inputs, config, traffic, device):\n"
        "    return {'n': inputs.nsnp}\n"
        "def run(state):\n"
        "    return {'sites': state['n']}\n"
        "def release(state):\n"
        "    pass\n"
        "def check(state, records, device):\n"
        "    return [('wrong_sites', sum(r['sites'] != 4096 for r in records), 0)], {}, 0\n")
    (b / "metrics" / "sites_per_s.py").write_text(
        "def read(ctx):\n    return sum(r['sites'] for r in ctx.records) / ctx.window_s\n")
    (b / "limits" / "mini.count.json").write_text(json.dumps({"wrong_sites": {"limit": 0}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="mini", source="test", file="benchmark/configs/mini.json",
                                reduced=[], why="test"))
    spec["workloads"].append(dict(name="mini.count", config="mini", traffic="count", chips=1,
                                  why="test"))
    spec["end_to_end"].append(dict(name="sites_per_s", unit="sites/s", better="higher",
                                   bound=0.1, source="host_clock", workloads=["mini.count"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run(str(b), "mini.count", seconds=0.2)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"sites_per_s", "setup_s"}
    assert all(p.read_bytes() == data for p, data in before.items())


# --------------------------------------------------------------------------
# the window, the readers, the trace
# --------------------------------------------------------------------------
class Sleeper:
    def __init__(self, s):
        self.s = s

    def run(self, state):
        import time

        time.sleep(self.s)
        return {"pairs": 10, "needed": "all"}


def test_window_runs_calls_back_to_back_and_the_last_to_its_end():
    records, window = harness.run_window(Sleeper(0.12), None, 0.5, "cpu", "bench.x")
    assert len(records) == 5  # starts at 0, .12, .24, .36, .48 < .5
    assert window >= records[-1]["start_s"] + records[-1]["wall_s"] >= 0.5
    assert all(b["start_s"] >= a["start_s"] + a["wall_s"] for a, b in zip(records, records[1:]))


def test_rate_arithmetic():
    recs = [{"pairs": 100, "wall_s": 2.0}, {"pairs": 100, "wall_s": 4.0}]
    ctx = harness.Context(cell={}, config={}, traffic={}, inputs=None, records=recs,
                          setup_s=7.0, window_s=8.0, peak_bytes=3 * 2**30)
    read = {n: harness.load_module("metrics", n).read(ctx) for n in
            ("pairs_per_s", "peak_mem_gib", "setup_s", "device_idle.screen",
             "screen_other_ops_pct", "k1_k2_roofline")}
    assert read == {"pairs_per_s": 25.0, "peak_mem_gib": 3.0, "setup_s": 7.0,
                    "device_idle.screen": None, "screen_other_ops_pct": None,
                    "k1_k2_roofline": None}


def test_idle_share_is_the_union_of_device_intervals():
    dev = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("copy", 6.0, 7.0), ("k1", 9.5, 12.0)]
    ranges = [("bench.call", 0.0, 10.0), ("fast_finish", 4.0, 5.5), ("bench.call", 10.0, 12.0)]
    t = trace.make(dev, ranges, 0.0, 10.0)
    assert trace.busy_s(t) == pytest.approx(4.5)  # [1,4] + [6,7] + [9.5,10]
    assert trace.idle_pct(t) == pytest.approx(55.0)
    assert trace.idle_gaps(t) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.5)]
    b = trace.breakdown(t)
    assert b["idle_gaps"][0] == ["bench.call", 2.5]
    assert b["idle_gaps"][1] == ["fast_finish", 2.0]  # the innermost range at its midpoint
    assert b["device_ops"][0] == ["k1", 2.5]
    assert trace.kernel_s(t, trace.K1) == 0.0  # no name of the port's kernels here


# --------------------------------------------------------------------------
# the roofline count
# --------------------------------------------------------------------------
def test_counts_against_a_hand_count():
    rng = np.random.default_rng(3)
    n, nseq, g, d = 40, 7, 1000, 120
    r = rng.integers(1, 4, n)
    pos = np.sort(rng.choice(np.arange(1, g + 1), n, replace=False))
    ops_all = ops_lr = pairs_lr = 0
    for i in range(n):
        for j in range(i + 1, n):
            fwd = (pos[j] - pos[i]) % g
            lr = min(fwd, g - fwd) > d
            o = 2 * nseq * (r[i] - 1) * (r[j] - 1)
            ops_all += o
            ops_lr += o * lr
            pairs_lr += lr
    assert counts.needed_work(r, nseq, "all") == (ops_all, nseq * n + 4 * n * (n - 1) // 2)
    assert counts.needed_work(r, nseq, "long_range", pos, g, d) == (ops_lr, nseq * n + 4 * pairs_lr)
    assert counts.bound_s(989e12, 0) == 1.0 and counts.bound_s(0, 3.35e12) == 1.0


# --------------------------------------------------------------------------
# the reference
# --------------------------------------------------------------------------
def test_reference_mi_is_the_statistic():
    """The reference's float64 MI against the port's host oracle (the
    statistic as LDWeaver's R defines it, with the intended RXY)."""
    from ldweaver_tpu_torch.core.mi import mi_tile_numpy

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, (50, 30)).astype(np.uint8)
    codes[:, :10] = np.where(rng.random((50, 10)) < 0.3, 1, 3)
    w = rng.uniform(0.05, 0.5, 50)
    uqe = np.stack([(codes == k).any(axis=0) for k in range(5)], axis=1).astype(np.uint8)
    r = uqe.sum(axis=1)
    want = mi_tile_numpy(codes.T, codes.T, w, r, r, uqe, uqe, w.sum(), rxy_compat=False)
    sites = Sites(codes, w, "cpu")
    got = mi_tile(sites, torch.arange(30), torch.arange(30)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    i, j = np.triu_indices(30, 1)
    np.testing.assert_allclose(mi_pairs(sites, i, j), want[i, j], rtol=1e-12, atol=1e-14)


# --------------------------------------------------------------------------
# whole runs on the CPU: the result line, the controls, the faults
# --------------------------------------------------------------------------
def test_result_line_shape(bench):
    out = run(bench, "tiny.screen")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}  # no card: no peak
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    traced = run(bench, "tiny.screen", traced=True)
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in traced["breakdown"].values())
    json.dumps(traced)


def test_screen_control_and_faults_come_out_not_correct(bench, monkeypatch):
    from ldweaver_tpu_torch.parallel import fast_sweep

    assert not run(bench, "tiny.screen", traffic_override={"precision_terms": 1})["correct"]
    real_call = fast_sweep.fast_lr_topk

    def altered(*a, **k):  # one answer altered where it is produced
        p1, p2, mi = real_call(*a, **k)
        mi = mi.copy()
        mi[7] *= 1.01
        return p1, p2, mi

    monkeypatch.setattr(fast_sweep, "fast_lr_topk", altered)
    assert not run(bench, "tiny.screen")["correct"]
    monkeypatch.setattr(fast_sweep, "fast_lr_topk", real_call)
    real_tile = fast_sweep._tile_candidates
    seen = []

    def half(state, bi, bj, *a, **k):  # every other tile left out
        vals, idx = real_tile(state, bi, bj, *a, **k)
        seen.append(1)
        return (vals if len(seen) % 2 else torch.full_like(vals, float("-inf"))), idx

    monkeypatch.setattr(fast_sweep, "_tile_candidates", half)
    assert not run(bench, "tiny.screen")["correct"]


# --------------------------------------------------------------------------
# the command: no card, no JAX
# --------------------------------------------------------------------------
def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        harness.load_spec()["workloads"][0]["name"],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program_the_harness_refuses(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is missing and no run can start."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness;"
            " harness.check_program()" % str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        harness.load_spec()["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from benchmark import harness
for kind, names in {mods!r}.items():
    for n in names:
        harness.load_module(kind, n)
import benchmark.readings, benchmark.counts, benchmark.trace
import benchmark.reference.mi, benchmark.reference.screen
import ldweaver_tpu_torch.parallel.fast_sweep, ldweaver_tpu_torch.core.sweep
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.mi, benchmark.reference.screen, benchmark.counts, benchmark.trace
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    mods = {kind: sorted(f[:-3] for f in os.listdir(os.path.join(harness.BENCH, kind))
                         if f.endswith(".py") and f != "__init__.py")
            for kind in ("entries", "metrics", "gen")}
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    for code, banned in ((IMPORTS, {"jax", "jaxlib", "flax", "ldweaver_tpu"}),
                         (REFERENCE_ONLY, {"jax", "jaxlib", "flax", "ldweaver_tpu",
                                           "ldweaver_tpu_torch"})):
        p = subprocess.run([sys.executable, "-c", code.format(root=ROOT, mods=mods)],
                           capture_output=True, text=True, timeout=300, env=env, cwd="/")
        assert p.returncode == 0, p.stderr
        loaded = set(eval(p.stdout.strip().splitlines()[-1]))
        assert not loaded & banned
    assert "ldweaver_tpu_torch" in set(eval(subprocess.run(
        [sys.executable, "-c", IMPORTS.format(root=ROOT, mods=mods)], capture_output=True,
        text=True, timeout=300, env=env, cwd="/").stdout.strip().splitlines()[-1]))


@pytest.mark.cuda
def test_screen_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    spec = harness.load_spec()
    name = spec["workloads"][0]["name"]
    out = harness.run_cell(name, 99, 2.0, False)
    assert out["correct"], out["checks"]
