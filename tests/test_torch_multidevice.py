"""Several shards in one process (`n_devices` on device="cpu": the
kernels' plain versions): the port against the JAX package on its 8-device
virtual CPU mesh, and against its own one-shard runs.

Equal to the JAX package's: the partition plan (bounds and caps) on the
same per-shard tile lists and the host window counts; bit-equal: the
part-mode group stats (ns, xlo, xhi), candidates, fits and candidate
tables of the grid-partitioned SR reduction, 8 shards, from the same SR
segments.  Byte-identical to
n_devices=1: sr and lr TSVs and fit files for n_devices 2 and 3, backends
spmd and fast, sr_reduce auto, part and host.  Equal to one shard:
`fast_lr_topk` over 2 shards, streamed.  `sharded_lr_topk` (K3's plain
version) against the JAX package's on 2 shards: MI within rtol 2e-4 and
atol 2e-5 (the tile tolerance of tests/test_fast_sweep.py:260), pairs
equal apart from near-ties, the histogram equal; one, two and three
shards of the port give the same result.  "auto" takes "part" by the
partitioned pass's footprint model.  n_devices=2 on "cuda" without two
cards raises."""

import os

import numpy as np
import pytest
import torch

import ldweaver_tpu.parallel.sr_reduce as jsr
import ldweaver_tpu.parallel.spmd_sweep as jspmd
import ldweaver_tpu_torch.core.sweep as tsweep
import ldweaver_tpu_torch.parallel.sr_reduce as tsr
import ldweaver_tpu_torch.parallel.spmd_sweep as tspmd
from ldweaver_tpu_torch.parallel import multihost
from ldweaver_tpu_torch.parallel.slabs import panel_pair_order
from tests.test_torch_sr_reduce import SR_DIST, port_case

NSH = 8  # the JAX tests' virtual devices
# the part mode's range budget in the pipeline tests: 16 k2 ranges of the
# test input over 2 or 3 shards (the floor of 64 MiB would hold it in 2)
RANGE_BUDGET = 1 << 16


def pin_range_budget(monkeypatch, nbytes=RANGE_BUDGET):
    monkeypatch.setattr(tsr, "PART_RANGE_MIN", nbytes)
    monkeypatch.setattr(tsr, "PART_RANGE_MAX", nbytes)


def planned_partitions(sd, st, nsh, sr_dist=SR_DIST):
    """The k2 ranges `partition_plan` gives BLK5's `nsh` shards of sd at
    the range budget of the run whose BLK5 stats are `st`."""
    from ldweaver_tpu_torch.parallel.fast_sweep import stratify

    B = st["block"]
    ranked = stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, B)
    nb = ranked.rank_codes.shape[1] // B
    valid = np.arange(ranked.pos.size) < sd.nsnp
    blocks = [ranked.pos[i * B : (i + 1) * B][valid[i * B : (i + 1) * B]]
              for i in range(nb)]
    bounds, _ = tsr.partition_plan(shard_tiles(nb, nsh)[1], blocks, sd.g,
                                   sr_dist, st["range_budget"])
    return len(bounds) - 1


def run_pmc(sd, w, cds, out, backend="spmd", **kw):
    """One perform_mi_computation into out/Temp/{sr,lr}_links.tsv and
    out/Fit (tests/test_torch_sr_reduce.py:run_mode with a backend and
    20,000 LR links kept); returns (phases, {file: bytes})."""
    temp, fit = os.path.join(out, "Temp"), os.path.join(out, "Fit")
    os.makedirs(temp)
    phases = {}
    tsweep.perform_mi_computation(
        sd, w, cds, lr_save_path=os.path.join(temp, "lr_links.tsv"),
        sr_save_path=os.path.join(temp, "sr_links.tsv"), plt_folder=fit,
        sr_dist=SR_DIST, lr_retain_links=20_000, max_blk_sz=1000,
        srp_cutoff=3.0, backend=backend, verbose=False, phase_timings=phases,
        **kw,
    )
    files = {}
    for d in (temp, fit):
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fh:
                files[name] = fh.read()
    return phases, files


def shard_tiles(nb, nsh):
    canonical = list(panel_pair_order(nb, nb))
    return canonical, [canonical[lo:hi]
                       for lo, hi in multihost.shard_ranges(len(canonical), nsh)]


def sr_segments(seed, B=64, nb=5, g=40_001, sr_dist=4000, nclust=4):
    """The kept SR outputs (bi, bj, sr_idx, sr_vals) of every tile, as a
    sweep keeps them: every pair within circular distance sr_dist (strict
    lower triangle on the diagonal), MI on a 0.01 grid (ties) with some
    -0.0, positions in no order, and a paint that leaves cluster `nclust`
    without a site."""
    from ldweaver_tpu_torch.core.mi import circular_len

    rng = np.random.default_rng(seed)
    n = B * nb
    pos = rng.choice(np.arange(1, g + 1), n, replace=False).astype(np.int32)
    paint = rng.integers(1, nclust, size=n).astype(np.int32)
    segs = []
    ii, jj = np.divmod(np.arange(B * B), B)
    for bi, bj in panel_pair_order(nb, nb):
        near = circular_len(pos[bj * B + jj], pos[bi * B + ii], g) <= sr_dist
        ok = near & (ii > jj) if bi == bj else near
        idx = np.flatnonzero(ok).astype(np.int32)
        vals = (rng.integers(-5, 60, idx.size) / 100).astype(np.float32)
        vals[rng.random(idx.size) < 0.02] = -0.0
        segs.append((bi, bj, idx, vals))
    return dict(B=B, nb=nb, g=g, sr_dist=sr_dist, nclust=nclust, pos=pos,
                paint=paint, segs=segs)


def pos_blocks(case):
    B, pos = case["B"], case["pos"]
    return [pos[i * B : (i + 1) * B] for i in range(case["nb"])]


def test_partition_plan_and_window_counts_match_jax():
    rng = np.random.default_rng(3)
    g, sr_dist = 400_001, 5000
    for _ in range(20):
        p = rng.integers(1, g + 1, int(rng.integers(0, 300)))
        q = rng.integers(1, g + 1, int(rng.integers(0, 300)))
        assert np.array_equal(tspmd._circular_window_counts(p, q, g, sr_dist),
                              jspmd._circular_window_counts(p, q, g, sr_dist))
        for same in (True, False):
            assert (tspmd.tile_sr_count(p, q, g, sr_dist, same)
                    == jspmd.tile_sr_count(p, q, g, sr_dist, same))
    case = sr_segments(seed=5)
    canonical, tiles = shard_tiles(case["nb"], NSH)
    per = len(tiles[0])
    for budget in (1 << 30, 20_000, 2_000):
        got = tsr.partition_plan(tiles, pos_blocks(case), case["g"],
                                 case["sr_dist"], budget)
        want = jsr.partition_plan([(canonical, NSH * per)], NSH, pos_blocks(case),
                                  case["g"], case["sr_dist"], budget)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert len(got[0]) > 3  # the small budgets split the grid


def jax_part(case, budget):
    """The JAX package's part-mode passes on the 8-device mesh: one
    segment whose rows are the canonical tiles, device d holding the
    tiles of shard d (the rows padded to 8 * per)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ldweaver_tpu.parallel.fast_sweep import _MESH_STORE

    mesh = Mesh(np.array(jax.devices()[:NSH]), ("b",))
    key = id(mesh)
    _MESH_STORE[key] = mesh
    canonical, tiles = shard_tiles(case["nb"], NSH)
    per = len(tiles[0])
    rows = NSH * per
    by_tile = {(bi, bj): (i, v) for bi, bj, i, v in case["segs"]}
    width = max(i.size for i, _ in by_tile.values())
    idx = np.zeros((rows, width), np.int32)
    vals = np.zeros((rows, width), np.float32)
    n_sr = np.zeros(rows, np.int32)
    pairs = np.zeros((rows, 2), np.int32)
    for r, t in enumerate(canonical):
        i, v = by_tile[t]
        idx[r, : i.size], vals[r, : v.size], n_sr[r] = i, v, i.size
        pairs[r] = t
    shard = NamedSharding(mesh, P("b"))
    segs = (tuple(jax.device_put(a, shard) for a in (idx, vals, n_sr, pairs)),)
    pos, paint = jnp.asarray(case["pos"]), jnp.asarray(case["paint"])
    B, g, sr_dist, nclust = case["B"], case["g"], case["sr_dist"], case["nclust"]
    bounds, caps = jsr.partition_plan([(canonical, rows)], NSH, pos_blocks(case),
                                      g, sr_dist, budget)
    ns = np.zeros((nclust, 2 * sr_dist - 1), np.int32)
    xlo = np.zeros(ns.shape, np.float32)
    xhi = np.zeros(ns.shape, np.float32)
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if i == len(bounds) - 2:
            hi = 2 * sr_dist
        cap = int(caps[i].max())
        if cap == 0:
            continue
        buf = jsr._build_part_compact(key, B, g, sr_dist, lo, hi, cap)(
            segs, pos, paint)
        sbuf = np.asarray(jsr._build_part_stats(key, lo, hi, nclust)(buf))
        ns[:, lo - 1 : hi - 1] = sbuf[0].view(np.int32)
        xlo[:, lo - 1 : hi - 1] = sbuf[1].view(np.float32)
        xhi[:, lo - 1 : hi - 1] = sbuf[2].view(np.float32)
    fits = jsr.fits_from_group_stats(ns, xlo, xhi, sr_dist)
    T = jsr.threshold_tables(fits, nclust, sr_dist)
    gi, gj, mi, count, _ = jsr._candidates_sharded(
        key, segs, pos, paint, T, B, g, sr_dist, nclust, NSH, {}, 0.0)
    red = jsr.run_device_reduction(
        mesh, segs, pos, paint, ranked_pos=case["pos"].astype(np.int64),
        paint_sorted=case["paint"].astype(np.int64), B=B, nb=case["nb"], g=g,
        sr_dist=sr_dist, nclust=nclust,
        total_sr=sum(s[2].size for s in case["segs"]), mode="part",
        seg_chunks=[(canonical, rows)], pos_blocks=pos_blocks(case),
        part_budget_bytes=budget,
    )
    return (bounds, caps), (ns, xlo, xhi), T, (gi, gj, mi), red


def port_part(case, budget):
    """The port's part-mode passes over 8 CPU shards of the same tiles."""
    canonical, tiles = shard_tiles(case["nb"], NSH)
    by_tile = {(bi, bj): (i, v) for bi, bj, i, v in case["segs"]}
    lane_segs = [[(bi, bj, torch.from_numpy(by_tile[bi, bj][0]),
                   torch.from_numpy(by_tile[bi, bj][1])) for bi, bj in t]
                 for t in tiles]
    pos, paint = torch.from_numpy(case["pos"]), torch.from_numpy(case["paint"])
    B, g, sr_dist, nclust = case["B"], case["g"], case["sr_dist"], case["nclust"]
    flats = [tsr.flat_segments(s, pos, paint, B, g, sr_dist) for s in lane_segs]
    bounds, caps = tsr.partition_plan(tiles, pos_blocks(case), g, sr_dist, budget)
    ns, xlo, xhi, _ = tsr.part_group_stats(flats, bounds, caps, 0, sr_dist, nclust)
    fits = tsr.fits_from_group_stats(ns, xlo, xhi, sr_dist)
    T = tsr.threshold_tables(fits, nclust, sr_dist)
    cand = [tsr.candidates(f, T, sr_dist, nclust) for f in flats]
    cand = tuple(np.concatenate([c[k] for c in cand]) for k in range(3))
    red = tsr.run_part_reduction(
        lane_segs, [pos] * NSH, [paint] * NSH, shard_tiles=tiles, first_shard=0,
        pos_blocks=pos_blocks(case), ranked_pos=case["pos"].astype(np.int64),
        paint_sorted=case["paint"].astype(np.int64), B=B, nb=case["nb"], g=g,
        sr_dist=sr_dist, nclust=nclust,
        total_sr=sum(s[2].size for s in case["segs"]), part_budget_bytes=budget,
    )
    return (bounds, caps), (ns, xlo, xhi), T, cand, red


def test_part_stats_and_candidates_match_jax():
    case = sr_segments(seed=13)
    budget = 60_000  # several ranges
    plan_j, stats_j, T_j, cand_j, red_j = jax_part(case, budget)
    plan_t, stats_t, T_t, cand_t, red_t = port_part(case, budget)
    assert len(plan_t[0]) > 3
    for a, b in zip(plan_t, plan_j):
        assert np.array_equal(a, b)
    ns, xlo, xhi = stats_t
    assert (ns == 0).any() and (ns == 1).any() and (ns >= 3).any()
    assert np.array_equal(ns, stats_j[0])
    assert np.array_equal(xlo.view(np.uint32), stats_j[1].view(np.uint32))
    assert np.array_equal(xhi.view(np.uint32), stats_j[2].view(np.uint32))
    assert np.array_equal(T_t.view(np.uint32), T_j.view(np.uint32))
    assert cand_t[0].size > 10
    assert np.array_equal(cand_t[0], cand_j[0]) and np.array_equal(cand_t[1], cand_j[1])
    assert np.array_equal(cand_t[2].view(np.uint32), cand_j[2].view(np.uint32))
    assert red_t.stats["sr_partitions"] == red_j.stats["sr_partitions"] > 2
    assert red_t.stats["cand_count"] == red_j.stats["cand_count"]
    assert red_t.fits.keys() == red_j.fits.keys()
    for c in red_j.fits:
        assert np.array_equal(red_t.fits[c].fitted, red_j.fits[c].fitted)
    for a, b in zip(red_t.tables, red_j.tables):
        for f in ("pos1", "pos2", "clust1", "clust2", "len", "MI"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def one_shard(tmp_path_factory):
    sd, w, cds, _, _ = port_case()
    out = str(tmp_path_factory.mktemp("md") / "one")
    phases, files = run_pmc(sd, w, cds, out, device="cpu")
    assert phases["spmd"]["shards"] == 1
    return (sd, w, cds), files


@pytest.mark.parametrize("backend", ["spmd", "fast"])
@pytest.mark.parametrize("sr_reduce", ["auto", "part", "host"])
def test_shards_byte_identical(one_shard, tmp_path, backend, sr_reduce,
                               monkeypatch):
    (sd, w, cds), ref = one_shard
    assert ref["sr_links.tsv"].count(b"\n") > 100
    assert ref["lr_links.tsv"].count(b"\n") > 1000
    if sr_reduce == "part":
        pin_range_budget(monkeypatch)
    for n in (2, 3):
        ph, files = run_pmc(sd, w, cds, str(tmp_path / f"n{n}"), backend,
                            sr_reduce=sr_reduce, n_devices=n, device="cpu")
        st = ph[backend]
        assert st["shards"] == n and st["tiles"] == 6 and st["gather_bytes"] == 0
        assert st["sr_reduce"] == {"auto": "device", "part": "device-part",
                                   "host": "host"}[sr_reduce]
        if sr_reduce == "part":
            assert st["range_budget"] == RANGE_BUDGET
            assert st["sr_partitions"] == planned_partitions(sd, st, n) > 2
        assert files.keys() == ref.keys()
        for name in ref:
            assert files[name] == ref[name], (n, name)


def test_fast_lr_topk_two_shards_streamed():
    from ldweaver_tpu_torch.parallel import fast_sweep as tfs
    from tests.test_torch_lr_sweep import snp_data
    from ldweaver_tpu_torch.core.snp_tensor import SnpData

    sd, w = snp_data(SnpData, 4096, 48, seed=3)
    budget = int(48 * 512 * 4 / 0.6)  # 4 of the 8 slabs: streamed
    kw = dict(block=512, topk=400, sr_dist=20000, device="cpu",
              hbm_budget_bytes=budget)
    one = tfs.fast_lr_topk(sd, w, **kw)
    state = tfs.prepare_fast_sweep(sd, w, 512, 2, budget, "cpu")
    assert state.streaming and len(state.lanes) == 2
    two = tfs.fast_lr_topk(sr_dist=20000, topk=400, state=state)
    assert one[2].size == 400
    for a, b in zip(one, two):
        assert np.array_equal(a, b)
    assert sum(lane.slab_cache.uploads for lane in state.lanes) > 8


def test_sharded_lr_topk_matches_jax():
    from ldweaver_tpu.core.snp_tensor import SnpData as JaxSnpData
    from ldweaver_tpu.parallel import sweep as jsw
    from ldweaver_tpu_torch.core.snp_tensor import SnpData
    from ldweaver_tpu_torch.parallel import sweep as tsw
    from tests.test_torch_lr_sweep import RTOL, ATOL, NEAR_TIE, snp_data

    sd_j, w = snp_data(JaxSnpData, 1024, 48, seed=4)
    sd_t, _ = snp_data(SnpData, 1024, 48, seed=4)
    kw = dict(block=256, sr_dist=20000, topk=300)
    p1j, p2j, mj, hj = jsw.sharded_lr_topk(sd_j, w, n_devices=2, **kw)
    got = tsw.sharded_lr_topk(sd_t, w, n_devices=2, device="cpu", **kw)
    p1t, p2t, mt, ht = got
    assert mt.size == mj.size == 300 and np.all(np.diff(mt) <= 0)
    assert np.array_equal(ht, hj) and ht.sum() > 1000
    np.testing.assert_allclose(mt, mj, rtol=RTOL, atol=ATOL)
    kj = list(zip(p1j.tolist(), p2j.tolist()))
    kt = list(zip(p1t.tolist(), p2t.tolist()))
    vj = dict(zip(kj, mj))
    for k, v in zip(kt, mt):
        if k not in vj:  # a pair on one side only sits at the k-th value
            assert v - mt[-1] <= NEAR_TIE
        else:
            np.testing.assert_allclose(v, vj[k], rtol=RTOL, atol=ATOL)
    for n in (1, 3):
        other = tsw.sharded_lr_topk(sd_t, w, n_devices=n, device="cpu", **kw)
        for a, b in zip(got, other):
            assert np.array_equal(a, b)


def test_select_mode_part_model(monkeypatch):
    """"auto" over several shards takes "part" exactly when the flat table
    is over the SR budget and `part_peak_bytes` of the largest shard, at
    the range budget `part_range_budget` leaves beside its flat arrays,
    fits; on one shard it never does.  The range budget stays within its
    bounds."""
    n = 100_000_000
    lo, hi = tsr.PART_RANGE_MIN, tsr.PART_RANGE_MAX
    assert tsr.part_range_budget(1 << 30, n) == lo
    assert tsr.part_range_budget(80 << 30, n) == hi
    mid = tsr.PART_PAIR_BYTES * n + tsr.PART_RANGE_FACTOR * ((lo + hi) // 2)
    assert tsr.part_range_budget(mid, n) == (lo + hi) // 2
    shards = [n] + [n // 2] * 10
    total = sum(shards)
    least = max(tsr.PART_PASS_BYTES * n,
                tsr.PART_PAIR_BYTES * n + tsr.PART_RANGE_FACTOR * lo)
    assert least < tsr.flat_peak_bytes(total)
    assert tsr.part_peak_bytes(n, tsr.part_range_budget(least, n)) <= least
    for budget, want, one in ((tsr.flat_peak_bytes(total), "device", "device"),
                              (least, "part", "host"),
                              (least - 1, "host", "host")):
        monkeypatch.setenv("LDW_SR_BUDGET", str(budget))
        got = tsr.select_mode("auto", total, 2_200_000, "cpu", verbose=False,
                              shard_sr=shards)
        assert got == want, budget
        assert tsr.select_mode("auto", total, 2_200_000, "cpu",
                               verbose=False) == one
        assert tsr.select_mode("part", total, 2_200_000, "cpu", verbose=False,
                               shard_sr=shards) == "part"


def test_auto_takes_part_over_two_shards_where_the_jax_rule_took_device(monkeypatch):
    """A table between the JAX package's 8 bytes a pair and the port's
    flat model: "auto" sends it to the host on one shard and to "part" on
    two, at a budget where `part_peak_bytes` of the larger shard fits."""
    shards = [110_000_000, 90_000_000]
    total = sum(shards)
    budget = 8 << 30
    assert 8 * total < budget < tsr.flat_peak_bytes(total)
    n = max(shards)
    assert tsr.part_peak_bytes(n, tsr.part_range_budget(budget, n)) <= budget
    monkeypatch.setenv("LDW_SR_BUDGET", str(budget))
    assert tsr.select_mode("auto", total, 2_200_000, "cpu", verbose=False) == "host"
    assert tsr.select_mode("auto", total, 2_200_000, "cpu", verbose=False,
                           shard_sr=shards) == "part"
    assert tsr.select_mode("part", total, 2_200_000, "cpu", verbose=False) == "host"


def test_two_cuda_devices_on_one_card_raise(monkeypatch):
    """n_devices above the machine's cards raises before anything touches
    a card: one card is never shared quietly."""
    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.support import resolve_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_devices("cuda") == [torch.device("cuda", 0)]
    for dev, n in (("cuda", 2), ("cuda:0", 2), ("cuda:1", None)):
        with pytest.raises(ValueError, match="this machine has 1"):
            resolve_devices(dev, n)
    with pytest.raises(ValueError, match="this machine has 1"):
        ldweaver_tpu_torch.ldweaver(dset="unused", aln_path="unused.fa",
                                    gbk_path="unused.gbk", device="cuda",
                                    n_devices=2)
    assert resolve_devices("cpu", 3) == [torch.device("cpu")] * 3
