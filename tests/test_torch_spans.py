"""The port's spans (`utils/profiling.span`) and the benchmark's readers of
them.

A span counts and times itself always, and is a profiler range only
while a profiler records.  A CPU `fast_lr_topk` opens its spans in the
order the screen's per-layer metrics assume, all inside one
"ldw.lr_topk"; `prepare_fast_sweep` opens "ldw.prepare" and its three
children.  The readers split the card's idle time between the dispatch
ranges and the rest by exact interval arithmetic (hand-built traces)."""

import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench import synth
from benchmark import harness, trace
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.parallel import fast_sweep as tfs
from ldweaver_tpu_torch.parallel import multihost
from ldweaver_tpu_torch.utils import profiling
from ldweaver_tpu_torch.utils.profiling import span

G = 2_200_000
# 9 blocks of 1,152 sites (> 1,024 and a multiple of 128: K2's route):
# 45 tiles, more than one fold of MERGE_CHUNK on one lane
NSNP, NSEQ, BLOCK = 10_000, 48, 1152
PREPARE = ("ldw.prepare", "ldw.prepare.stratify", "ldw.prepare.upload",
           "ldw.prepare.marginals")


@pytest.fixture(autouse=True)
def fresh_totals():
    profiling.reset()
    yield
    profiling.reset()


def ranges_of(prof, prefix="ldw."):
    """(name, start ns, end ns) of the profiler's host ranges named
    `prefix`..., in start order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith(prefix)]
    return sorted(out, key=lambda r: r[1])


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def snp():
    codes, pos, uqe, r, w = synth(NSNP, NSEQ, seed=3)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    sd = SnpData(codes=codes, pos=pos, g=G, seq_names=[str(i) for i in range(NSEQ)],
                 acgtn_table=acgtn, uqe=uqe, r=r)
    return sd, w


# --------------------------------------------------------------------------
# the facility
# --------------------------------------------------------------------------
def test_span_counts_and_times_and_nests_under_a_profiler():
    for _ in range(3):
        with span("outer"):
            with span("inner"):
                time.sleep(0.002)
    t = profiling.totals()
    assert set(t) == {"outer", "inner"}
    assert t["outer"][0] == t["inner"][0] == 3
    assert t["outer"][1] >= t["inner"][1] >= 3 * 0.002
    t["outer"] = (0, 0.0)  # a copy
    assert profiling.totals()["outer"][0] == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                pass
    got = ranges_of(prof, "")
    outer = [r for r in got if r[0] == "outer"]
    inner = [r for r in got if r[0] == "inner"]
    assert len(outer) == len(inner) == 1 and inside(inner[0], outer[0])
    assert profiling.totals()["inner"][0] == 4
    profiling.reset()
    assert profiling.totals() == {}


def test_span_opens_no_range_without_a_profiler(monkeypatch, snp):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("x"):
        pass
    sd, w = snp
    state = tfs.prepare_fast_sweep(sd, w, block=BLOCK, device="cpu")
    tfs.fast_lr_topk(sr_dist=20000, topk=64, state=state)
    assert profiling.totals()["ldw.lr_topk"][0] == 1


def test_span_closes_on_an_exception():
    with pytest.raises(ValueError):
        with span("raises"):
            raise ValueError("x")
    assert profiling.totals()["raises"][0] == 1


# --------------------------------------------------------------------------
# the program's spans
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_devices", [1, 2])
def test_fast_lr_topk_spans_under_a_profiler(snp, n_devices):
    sd, w = snp
    state = tfs.prepare_fast_sweep(sd, w, block=BLOCK, n_devices=n_devices, device="cpu")
    plain = tfs.fast_lr_topk(sr_dist=20000, topk=256, state=state)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = tfs.fast_lr_topk(sr_dist=20000, topk=256, state=state)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a, b)

    nb = state.ranked.rank_codes.shape[1] // BLOCK
    canonical = [(i, j) for i in range(nb) for j in range(i, nb)]
    per_lane = [hi - lo for lo, hi in multihost.shard_ranges(len(canonical), n_devices)]
    k2 = sum(tfs.uses_fused_tile(key, BLOCK) * len(tiles)
             for key, tiles in state.buckets.items())
    assert 0 < k2 < len(canonical)  # both kernels' routes run
    want = {"ldw.lr_topk": 1, "ldw.lr.plan": 1, "ldw.lr.pull": 1, "ldw.lr.merge": 1,
            "ldw.lr.tile.k1": len(canonical) - k2, "ldw.lr.tile.k2": k2,
            "ldw.lr.flush": sum(math.ceil(n / tfs.MERGE_CHUNK) for n in per_lane)}
    if n_devices == 1:  # a fold inside the tile loop and one after it
        assert want["ldw.lr.flush"] == 2
    ranges = ranges_of(prof)
    assert {n: sum(r[0] == n for r in ranges) for n in want} == want
    assert len(ranges) == sum(want.values())
    call = next(r for r in ranges if r[0] == "ldw.lr_topk")
    assert all(inside(r, call) for r in ranges)
    # the steps in order, none overlapping another but the call
    steps = [r for r in ranges if r is not call]
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))
    assert [steps[0][0], steps[-2][0], steps[-1][0]] == ["ldw.lr.plan", "ldw.lr.pull",
                                                          "ldw.lr.merge"]
    # the same counts in the totals, traced or not
    assert {n: c for n, (c, _) in profiling.totals().items() if n in want} == want


def test_prepare_records_its_three_steps(snp):
    sd, w = snp
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfs.prepare_fast_sweep(sd, w, block=BLOCK, n_devices=2, device="cpu")
    t = profiling.totals()
    assert {n: t[n][0] for n in PREPARE} == {
        "ldw.prepare": 1, "ldw.prepare.stratify": 1, "ldw.prepare.upload": 2,
        "ldw.prepare.marginals": 2}
    assert t["ldw.prepare"][1] >= sum(t[n][1] for n in PREPARE[1:])
    ranges = ranges_of(prof, "ldw.prepare")
    outer = [r for r in ranges if r[0] == "ldw.prepare"]
    assert len(outer) == 1 and all(inside(r, outer[0]) for r in ranges)


def test_streamed_prepare_and_slab_uploads(snp):
    """The streamed sweep: "ldw.slab.upload" once for each slab the cache
    uploads."""
    sd, w = snp
    state = tfs.prepare_fast_sweep(sd, w, block=BLOCK, hbm_budget_bytes=4 * NSEQ * BLOCK,
                                   device="cpu")
    assert state.streaming
    tfs.fast_lr_topk(sr_dist=20000, topk=64, state=state)
    t = profiling.totals()
    assert t["ldw.slab.upload"][0] == state.slab_cache.uploads > 0
    assert {n: t[n][0] for n in PREPARE[2:]} == {"ldw.prepare.upload": 1,
                                                   "ldw.prepare.marginals": 1}


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------
READERS = ("idle_dispatch.screen", "idle_serial.screen", "dispatch_ms.screen",
           "setup_prepare_s", "setup_kernels_s")


def context(tr, calls=2):
    return harness.Context(cell={}, config={}, traffic={}, inputs=None,
                           records=[{"pairs": 1}] * calls, setup_s=1.0,
                           window_s=10.0, peak_bytes=1, trace=tr)


def read(name, ctx):
    return harness.load_module("metrics", name).read(ctx)


def hand_trace():
    """Two calls in a 10-s window; the card busy [0, 1] and [5, 6].  The
    gap [1, 5]: plan 1.5 s, tile 1.5 s (a second tile range nested in
    it), flush 0.5 s, the call alone 0.5 s.  The gap [6, 10]: a K2 tile
    1 s, the pull 2 s, between the calls 1 s."""
    dev = [("rank_mi_kernel", 0.0, 1.0), ("fused_tile_kernel", 5.0, 6.0)]
    ranges = [("bench.screen", 0.0, 9.0), ("ldw.lr_topk", 0.0, 9.0),
              ("ldw.lr.plan", 1.0, 2.5), ("ldw.lr.tile.k1", 2.5, 4.0),
              ("ldw.lr.tile.k1", 3.0, 3.5), ("ldw.lr.flush", 4.0, 4.5),
              ("ldw.lr.tile.k2", 6.0, 7.0), ("ldw.lr.pull", 7.0, 9.0),
              ("bench.screen", 9.0, 12.0)]
    return trace.make(dev, ranges, 0.0, 10.0)


def test_a_gap_is_split_exactly_between_dispatch_and_serial_steps():
    ctx = context(hand_trace())
    assert read("device_idle.screen", ctx) == pytest.approx(80.0)
    assert read("idle_dispatch.screen", ctx) == pytest.approx(30.0)  # 1.5 + 0.5 + 1
    assert read("idle_serial.screen", ctx) == pytest.approx(50.0)  # 1.5 + 0.5 + 2 + 1
    assert read("dispatch_ms.screen", ctx) == pytest.approx(1500.0)  # 3 s over 2 calls
    assert (read("idle_dispatch.screen", ctx) + read("idle_serial.screen", ctx)
            == pytest.approx(read("device_idle.screen", ctx), abs=1e-9))
    # the breakdown labels each gap by the program's innermost span at
    # its midpoint (3 s and 8 s)
    assert [g[0] for g in trace.breakdown(ctx.trace)["idle_gaps"]] == ["ldw.lr.tile.k1",
                                                                       "ldw.lr.pull"]


def test_intersection_against_a_pairwise_sum():
    """`covered` against the sum over every pair of gap and interval, on
    random disjoint intervals."""
    mod = harness.load_module("metrics", "idle_dispatch.screen")
    rng = np.random.default_rng(7)
    edges = np.sort(rng.uniform(0, 100, 400))
    starts, ends = edges[0::2], edges[1::2]
    a = rng.uniform(-5, 105, 300)
    b = a + rng.exponential(3.0, 300)
    want = [sum(max(0.0, min(e, y) - max(s, x)) for s, e in zip(starts, ends))
            for x, y in zip(a, b)]
    np.testing.assert_allclose(mod.covered(starts, ends, a, b), want, atol=1e-9)
    tr = trace.make([], [("ldw.lr.flush", 2.0, 4.0), ("ldw.lr.tile.k1", 1.0, 3.0),
                         ("ldw.lr.tile.k2", 6.0, 7.0), ("ldw.lr.plan", 0.0, 9.0)], 0.0, 9.0)
    s, e = mod.union(tr, mod.DISPATCH)
    assert s.tolist() == [1.0, 6.0] and e.tolist() == [4.0, 7.0]


def test_readers_of_the_totals():
    with span("ldw.prepare"):
        time.sleep(0.001)
    with span("ldw.kernel.load"):
        pass
    with span("ldw.kernel.load"):
        pass
    ctx = context(hand_trace())
    t = profiling.totals()
    assert read("setup_prepare_s", ctx) == t["ldw.prepare"][1] >= 0.001
    assert read("setup_kernels_s", ctx) == t["ldw.kernel.load"][1]
    with span("ldw.kernel.build"):
        pass
    t = profiling.totals()
    assert read("setup_kernels_s", ctx) == pytest.approx(
        t["ldw.kernel.load"][1] + t["ldw.kernel.build"][1], rel=1e-12)


def test_readers_return_none_without_their_input():
    for name in READERS:
        assert read(name, context(None)) is None  # untraced
    with span("ldw.prepare"):
        pass
    no_card = trace.make([], [("ldw.lr.tile.k1", 1.0, 2.0)], 0.0, 10.0)
    for name in READERS:
        assert read(name, context(no_card)) is None  # a CPU run: no device activity
    profiling.reset()
    no_spans = trace.make([("rank_mi_kernel", 0.0, 1.0)], [("bench.screen", 0.0, 10.0)],
                          0.0, 10.0)
    for name in READERS:
        assert read(name, context(no_spans)) is None  # a program without the spans
