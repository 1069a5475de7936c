"""On-device SR background reduction: the port of the JAX package's
single-device ("flat") path and its grid-partitioned path over several
shards ("part"; parallel/sr_reduce.py there).

The SR background model (`core/background.py`, reference
`mergeNsort_sr_links`, R/computePairwiseMI.R:400-495) needs two things
from the full per-link SR table, and both reduce to little data:

  * the per-cluster log-log q95-decay fit needs, per (cluster, distance)
    group, only the group COUNT and the two order statistics around rank
    floor((n-1)*0.95);
  * the beta MLE, srp, dedup and cutoff consume only links with POSITIVE
    residual against the fitted curve (~5% of links), because
    `merge_and_sort_sr_links` drops `diff <= 0` rows before every f64
    reduction (R which() semantics, R/computePairwiseMI.R:449).

So `blk5_sweep` keeps every tile's SR pairs (row-major flat index and MI)
on the card, and two passes replace the copy of the table to the host:

  pass 1, `group_stats`: circular distances are exact half-integers, so
    the integer key k2 = 2*len = g - |2d - g| groups links exactly like
    the host's `_len_sort`.  Per cluster, one sort of the int64 key
    (k2 << 32) | mono(MI) orders every live link (`mono_u32` maps f32 to
    its order-preserving unsigned bits); group boundaries come from
    searchsorted over the key grid, and the two order statistics are
    gathers at rank lo = m - ceil(m/20) (`rank_lo`, integer-exact).  Only
    the [nclust, 2*sr_dist - 1] counts and order statistics cross to the
    host.
  pass 2, `candidates`: the host rebuilds the f64 fits from the stats
    (`fits_from_group_stats`, bit-equal to the host oracle), turns them
    into per-(cluster, k2) f32 thresholds rounded DOWN
    (`threshold_tables`: every link with f64 diff > 0 passes), and one
    pass compacts the candidate links (gi, gj, MI) with `torch.nonzero`;
    only those cross to the host.

`candidates_to_tables` puts the candidates into the canonical emission
order (panel tile order, row-major within a tile), so the downstream f64
reductions (`core/background.merge_and_sort_sr_links_from_candidates`)
see the same value sequence as on the host path and the TSVs come out
byte-identical.  The host helpers are copies of the JAX package's.

Over several shards (local devices and processes) `run_part_reduction`
leaves every shard's pairs where they are and splits pass 1 by ranges of
the k2 grid (section "part" below), so no device holds the whole table.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_TOP = 1 << 31
_U32 = (1 << 32) - 1
_DEAD = (1 << 31) - 1  # sorts after every valid k2


# --------------------------------------------------------------------------
# f32 <-> order-preserving unsigned 32-bit values (held in int64: CUDA
# has little uint32 support)
# --------------------------------------------------------------------------
def mono_u32(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> [0, 2^32) (sign-magnitude to biased): the
    order matches IEEE numeric order, with -0.0 just below +0.0."""
    b = v.contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where(b >= _TOP, _U32 - b, b | _TOP)


def unmono_f32(u: torch.Tensor) -> torch.Tensor:
    """The inverse of `mono_u32`, bit-exact."""
    b = torch.where(u >= _TOP, u & (_TOP - 1), _U32 - u)
    b = torch.where(b >= _TOP, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def rank_lo(n):
    """floor((n-1) * 0.95) via exact integer arithmetic:
    floor(19m/20) = m - ceil(m/20) with m = n-1.  Equal to the host's
    int((n-1)*0.95) for all realistic n."""
    m = n - 1
    return m - (m + 19) // 20


# --------------------------------------------------------------------------
# Device passes
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FlatLinks:
    """Every kept SR link of the sweep as flat device arrays."""

    k2: torch.Tensor  # i32 distance key 2 * circular length
    mi: torch.Tensor  # f32
    c1: torch.Tensor  # i32 cluster of the row site
    c2: torch.Tensor  # i32 cluster of the column site
    gi: torch.Tensor  # i32 row site (stratified order)
    gj: torch.Tensor  # i32 column site
    live: torch.Tensor  # bool: 0 < len < sr_dist


def flat_segments(segs: Sequence[Tuple[int, int, torch.Tensor, torch.Tensor]],
                  pos: torch.Tensor, paint: torch.Tensor, B: int, g: int,
                  sr_dist: int) -> FlatLinks:
    """Concatenate the kept SR outputs `(bi, bj, sr_idx, sr_vals)` of
    one or more tiles into flat per-link arrays.  Live applies the
    background model's STRICT 0 < len < sr_dist filter
    (R/computePairwiseMI.R:417-419): k2 in [1, 2*sr_dist - 1].  The int32
    key needs g < 2^30."""
    dev = pos.device
    counts = [int(s[2].numel()) for s in segs]
    total = sum(counts)
    i32 = torch.int32
    idx = torch.cat([s[2].to(i32) for s in segs])
    mi = torch.cat([s[3] for s in segs])
    reps = torch.tensor(counts, dtype=torch.int64, device=dev)

    def per_link(col):
        return torch.repeat_interleave(
            torch.tensor([s[col] for s in segs], dtype=i32, device=dev), reps,
            output_size=total)

    gi = per_link(0) * B + torch.div(idx, B, rounding_mode="floor")
    gj = per_link(1) * B + idx % B
    del idx
    diff = pos.index_select(0, gj) - pos.index_select(0, gi)
    d = torch.where(diff < 0, diff + g, diff)
    del diff
    k2 = g - torch.abs(2 * d - g)  # == 2 * circular_len, exact integer
    del d
    live = (k2 >= 1) & (k2 <= 2 * sr_dist - 1)
    return FlatLinks(k2=k2, mi=mi, c1=paint.index_select(0, gi),
                     c2=paint.index_select(0, gj), gi=gi, gj=gj, live=live)


def order_stats(base: torch.Tensor, mono: torch.Tensor, c1: torch.Tensor,
                c2: torch.Tensor, lo: int, hi: int, nclust: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-(cluster, k2) group count and the two order statistics around
    rank floor((n-1)*0.95) for the keys k2 in [lo, hi), as numpy
    [nclust, hi - lo] arrays (i32 counts, f32 values).  `base` is each
    link's i64 key (_DEAD for dead links), `mono` its `mono_u32` MI.  Every
    link is sorted, non-members under the _DEAD key, so empty groups
    gather the same elements as the JAX package's two-key sort."""
    dev = mono.device
    grid = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    lo_keys, hi_keys = grid << 32, (grid + 1) << 32
    F = base.numel()
    ns, xlo, xhi = [], [], []
    for c in range(1, nclust + 1):
        member = (c1 == c) | (c2 == c)
        ks = torch.sort((torch.where(member, base, _DEAD) << 32) | mono).values
        starts = torch.searchsorted(ks, lo_keys)
        n = torch.searchsorted(ks, hi_keys) - starts
        lo = rank_lo(n).clamp(min=0)
        hi = torch.minimum(lo + 1, (n - 1).clamp(min=0))
        i_lo = (starts + lo).clamp(0, F - 1)
        i_hi = (starts + hi).clamp(0, F - 1)
        ns.append(n)
        xlo.append(unmono_f32(ks[i_lo] & _U32))
        xhi.append(unmono_f32(ks[i_hi] & _U32))
        del ks
    return (torch.stack(ns).to(torch.int32).cpu().numpy(),
            torch.stack(xlo).cpu().numpy(), torch.stack(xhi).cpu().numpy())


def group_stats(flat: FlatLinks, sr_dist: int,
                nclust: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pass 1: `order_stats` of every link over the whole grid
    [1, 2*sr_dist), as numpy [nclust, 2*sr_dist - 1] arrays."""
    base = torch.where(flat.live, flat.k2, _DEAD).to(torch.int64)
    return order_stats(base, mono_u32(flat.mi), flat.c1, flat.c2, 1,
                       2 * sr_dist, nclust)


def candidates(flat: FlatLinks, T: np.ndarray, sr_dist: int,
               nclust: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pass 2: every live link whose MI clears ANY member cluster's
    f32-rounded-down threshold at its distance key, as host (gi, gj, mi)
    in ascending flat order (`jnp.nonzero`'s)."""
    Td = torch.from_numpy(np.ascontiguousarray(T, np.float32)).to(flat.mi.device)
    k2c = flat.k2.clamp(0, 2 * sr_dist)
    keep = torch.zeros_like(flat.live)
    for c in range(1, nclust + 1):
        thr = Td[c - 1].index_select(0, k2c)
        keep |= ((flat.c1 == c) | (flat.c2 == c)) & (flat.mi >= thr)
        del thr
    idx = torch.nonzero(keep & flat.live).reshape(-1)
    return (flat.gi[idx].cpu().numpy(), flat.gj[idx].cpu().numpy(),
            flat.mi[idx].cpu().numpy())


# --------------------------------------------------------------------------
# Host side: exact f64 fits from the stats, thresholds, tables
# --------------------------------------------------------------------------
def fits_from_group_stats(ns: np.ndarray, xlo: np.ndarray, xhi: np.ndarray,
                          sr_dist: int) -> Dict[int, object]:
    """Per-cluster ClusterFit from the device group stats, bit-equal to
    `fit_cluster_background` over the full link multiset: the type-7 q95
    needs only (n, x_lo, x_hi) per group and f64 interpolation, and the
    log-log OLS sees the identical (uniq, q95) rows."""
    from ldweaver_tpu_torch.core.background import _fit_from_q95

    nclust = ns.shape[0]
    grid = np.arange(1, 2 * sr_dist, dtype=np.int64)
    fits: Dict[int, object] = {}
    for ci in range(1, nclust + 1):
        n = ns[ci - 1].astype(np.int64)
        sel = n > 0
        if not sel.any():
            continue
        nn = n[sel]
        h = (nn - 1) * 0.95
        lo = np.floor(h).astype(np.int64)
        # the device gathered ranks with the integer identity; it must
        # agree with the f64 host rank for the stats to be the right
        # order statistics
        if not np.array_equal(lo, rank_lo(nn)):
            raise RuntimeError("rank identity violated")
        v_lo = xlo[ci - 1][sel].astype(np.float64)
        v_hi = xhi[ci - 1][sel].astype(np.float64)
        # n == 1 assigns v[0] directly (preserves -0.0 bit-exactly, like
        # the host oracle's special case); otherwise the oracle's interp
        q95 = np.where(nn == 1, v_lo, v_lo + (h - lo) * (v_hi - v_lo))
        uniq = grid[sel] / 2.0
        fits[ci] = _fit_from_q95(uniq, q95)
    return fits


def threshold_tables(fits: Dict[int, object], nclust: int,
                     sr_dist: int) -> np.ndarray:
    """[nclust, 2*sr_dist + 1] f32 thresholds T[c-1][k2]: the fitted
    curve at each distance key under the reference's `mean_dist[len]`
    index-by-value quirk (background.fit_lookup), rounded DOWN to f32 so
    MI >= T catches every link with f64 MI - fitted > 0.  Out-of-range
    keys (incl. the strict len == sr_dist and len <= 0 exclusions) and
    clusters without a fit get +inf (never candidates; the oracle drops
    them identically: NaN lookup -> NaN diff -> which() drops)."""
    T = np.full((nclust, 2 * sr_dist + 1), np.inf, dtype=np.float32)
    k2 = np.arange(1, 2 * sr_dist, dtype=np.int64)
    for ci, fit in fits.items():
        idx = (k2 >> 1) - 1  # trunc(len) - 1, the 1-based index quirk
        ok = (idx >= 0) & (idx < fit.fitted.size)
        v64 = fit.fitted[idx[ok]]
        v32 = v64.astype(np.float32)
        over = v32.astype(np.float64) > v64
        v32[over] = np.nextafter(v32[over], np.float32(-np.inf))
        row = np.full(2 * sr_dist + 1, np.inf, dtype=np.float32)
        row[k2[ok]] = v32
        T[ci - 1] = row
    return T


def candidates_to_tables(
    gi: np.ndarray, gj: np.ndarray, mi: np.ndarray, count: int,
    ranked_pos: np.ndarray, paint_sorted: np.ndarray,
    g: int, B: int, nb: int, nclust: int,
) -> List[object]:
    """Candidates -> per-cluster LinkTables in the CANONICAL emission
    order: tiles in panel_pair_order(nb, nb), row-major within a tile,
    with the same orientation normalisation as `_emit_pairs` (pos2 from
    the row site, pos1 from the column site, swapped to pos1 < pos2).
    This makes each cluster's candidate table an ordered superset of the
    host path's per-cluster concatenation, so the positive-residual
    restriction downstream is value-for-value identical."""
    from ldweaver_tpu_torch.core.mi import LinkTable, circular_len
    from ldweaver_tpu_torch.parallel.slabs import panel_pair_order

    gi = np.asarray(gi[:count], np.int64)
    gj = np.asarray(gj[:count], np.int64)
    mi = np.asarray(mi[:count], np.float64)
    rank = np.empty((nb, nb), np.int64)
    for t, (bi, bj) in enumerate(panel_pair_order(nb, nb)):
        rank[bi, bj] = t
    key = rank[gi // B, gj // B] * (B * B) + (gi % B) * B + (gj % B)
    o = np.argsort(key, kind="stable")
    gi, gj, mi = gi[o], gj[o], mi[o]
    pos2 = ranked_pos[gi]
    pos1 = ranked_pos[gj]
    c2 = paint_sorted[gi]
    c1 = paint_sorted[gj]
    swap = pos1 > pos2
    pos1_n = np.where(swap, pos2, pos1)
    pos2_n = np.where(swap, pos1, pos2)
    c1_n = np.where(swap, c2, c1)
    c2_n = np.where(swap, c1, c2)
    lens = circular_len(pos1_n, pos2_n, g)
    tables = []
    for c in range(1, nclust + 1):
        m = (c1_n == c) | (c2_n == c)
        tables.append(
            LinkTable(
                pos1=pos1_n[m], pos2=pos2_n[m], clust1=c1_n[m],
                clust2=c2_n[m], len=lens[m], MI=mi[m],
            )
        )
    return tables


# --------------------------------------------------------------------------
# Mode selection
# --------------------------------------------------------------------------
# Device bytes of the partitioned pass ("part") on a shard of n kept SR
# pairs whose gathered range buffer (every shard's records of one k2
# range) holds at most R bytes:
#     max(PART_PASS_BYTES * n, PART_PAIR_BYTES * n + PART_RANGE_FACTOR * R)
# The first term is the passes over the whole shard: flattening (the kept
# (i32 index, f32 MI) pairs beside the flat arrays and their temporaries)
# and the candidates.  The second is a range pass: the flat arrays (k2,
# MI, c1, c2, gi, gj i32 and the live flag) beside the shard's records,
# the range buffer, its i64 keys and the sort's temporaries.  Measured on
# an H100 80GB HBM3 (700 W) by chip_smoke.part_footprint at 8 M and 32 M
# pairs: 37.2-37.7 bytes a pair for the passes (flattening 33.0), 25.1-
# 25.5 for the flat arrays, 6.09-6.13 x R; the constants bound these, and
# chip_smoke.part_footprint_phase fails when a measurement exceeds one.
PART_PASS_BYTES = 40
PART_PAIR_BYTES = 26
PART_RANGE_FACTOR = 7
# The range budget R is what the SR budget leaves beside the flat arrays,
# within these bounds; the upper one is the largest R measured.
PART_RANGE_MIN = 64 << 20
PART_RANGE_MAX = 512 << 20


# Device bytes a kept SR pair of the single-device reduction ("device"):
#     FLAT_PASS_BYTES * n
# counted from before the sweep's kept (i32 index, f32 MI) pairs, which
# stay on the card through both passes: the flat arrays (k2, MI, c1, c2,
# gi, gj i32 and the live flag), pass 1's i64 key and mono MI, each
# cluster's i64 sort key with the sort's values, its unread i64 indices
# and its scratch space, and pass 2's candidates.  Measured on an H100
# 80GB HBM3 (700 W) by chip_smoke.flat_footprint at 32 M and 8 M pairs
# over 8 clusters and at 8 M over 2: 98.46-99.09 bytes a pair (pass 1;
# flattening 33.0, candidates 45.0-45.2).  Each cluster's group stats
# (16 bytes a distance key) add 0.46 bytes a pair from 2 clusters to 8 at
# 8 M pairs, a size that does not grow with the pairs.  The constant is
# the largest measurement rounded up; chip_smoke.flat_footprint_phase
# fails when a measurement exceeds it.
FLAT_PASS_BYTES = 100


def flat_peak_bytes(n: int) -> int:
    """The single-device reduction's device bytes for n kept pairs."""
    return FLAT_PASS_BYTES * int(n)


def part_range_budget(budget: int, n: int) -> int:
    """The range budget R of the partitioned pass under an SR budget of
    `budget` bytes, the largest shard holding n kept pairs."""
    left = (int(budget) - PART_PAIR_BYTES * int(n)) // PART_RANGE_FACTOR
    return int(min(PART_RANGE_MAX, max(PART_RANGE_MIN, left)))


def part_peak_bytes(n: int, range_budget: int) -> int:
    """The partitioned pass's device bytes on a shard of n kept pairs."""
    return max(PART_PASS_BYTES * int(n),
               PART_PAIR_BYTES * int(n) + PART_RANGE_FACTOR * int(range_budget))


def sr_budget(device) -> int:
    """The SR reduction's device byte budget: LDW_SR_BUDGET, else 0.35 of
    the card's memory (4 GiB without one), as in the JAX package."""
    from ldweaver_tpu_torch.parallel.slabs import auto_budget

    env_budget = os.environ.get("LDW_SR_BUDGET")
    if env_budget:
        return int(env_budget)
    cap = auto_budget(device)
    return int(cap * 0.35) if cap else (4 << 30)


def select_mode(sr_reduce: str, total_sr: int, g: int, device,
                verbose: bool = True,
                shard_sr: Optional[Sequence[int]] = None) -> str:
    """"device", "part" or "host": where `blk5_sweep` reduces the SR table
    (the JAX package's rules, spmd_sweep.py:1106-1165).  `shard_sr` holds
    each shard's kept pairs (one shard by default).

    The JAX package counts 8 bytes a kept pair (the resident i32 index and
    f32 MI, ldweaver_tpu/parallel/spmd_sweep.py:1107-1120) against the
    budget.  The port's torch passes hold the flat per-link arrays, the
    i64 sort keys and the sort's outputs beside those pairs, so the
    single-device reduction ("device") counts `flat_peak_bytes`, measured
    on the card, against `sr_budget`; the partitioned one ("part", more
    than one shard) counts `part_peak_bytes` of the largest shard at the
    range budget `part_range_budget` gives.  g >= 2^30 would overflow the
    int32 distance key: always the host.  "device" ignores the budget;
    "part" is the partitioned pass whenever there is more than one shard,
    and on one shard "device" when it fits, else the host; "auto" takes
    "device", else "part", else warns and takes the host."""
    budget = sr_budget(device)
    sr_bytes = flat_peak_bytes(total_sr)
    fits = sr_bytes <= budget
    nsh = len(shard_sr) if shard_sr is not None else 1
    if g >= 1 << 30:
        if sr_reduce in ("device", "part") and verbose:
            print(f"sr_reduce={sr_reduce!r} ignored: g >= 2^30 overflows the"
                  " int32 distance key; using the host path", flush=True)
        return "host"
    if sr_reduce in ("host", "device"):
        return sr_reduce
    if nsh > 1:
        if sr_reduce == "part":
            return "part"
        n = max(shard_sr)
        part_fits = part_peak_bytes(n, part_range_budget(budget, n)) <= budget
        mode = "device" if fits else ("part" if part_fits else "host")
    else:
        mode = "device" if fits else "host"
        if sr_reduce == "part":
            if verbose or mode == "host":
                print(f"sr_reduce='part' on one device: using the"
                      f" {'device' if fits else 'HOST'} path instead"
                      " (partitioning cannot reduce per-device residency"
                      f" without more devices; the device path needs"
                      f" {sr_bytes / 1e9:.1f} GB against a {budget / 1e9:.1f} GB"
                      " budget).", flush=True)
            return mode
    if mode == "host":
        print(f"WARNING: the SR reduction on one device ({sr_bytes / 1e9:.1f} GB,"
              f" {FLAT_PASS_BYTES} bytes a kept pair) exceeds the device"
              f" budget ({budget / 1e9:.1f} GB) over {nsh} shard(s):"
              " falling back to the HOST SR reduction, which copies the full"
              " SR table to the host.  Add shards or raise LDW_SR_BUDGET to"
              " keep the reduction on the device.", flush=True)
    return mode


@dataclasses.dataclass
class DeviceSrReduction:
    """Everything `merge_and_sort_sr_links_from_candidates` needs."""

    fits: Dict[int, object]
    tables: List[object]
    stats: Dict[str, float]


def run_device_reduction(
    segs: Sequence[Tuple[int, int, torch.Tensor, torch.Tensor]],
    pos_dev: torch.Tensor, paint_dev: torch.Tensor, *,
    ranked_pos: np.ndarray, paint_sorted: np.ndarray,
    B: int, nb: int, g: int, sr_dist: int, nclust: int, total_sr: int,
) -> DeviceSrReduction:
    """Run both device passes and the host fit over the kept per-tile SR
    outputs `segs` = [(bi, bj, sr_idx, sr_vals)] of the sweep, returning
    the fits and the candidate tables in canonical order.  Stats (wall
    seconds): bg_stats_s (flatten + pass 1 + its copy), bg_fit_s (host
    fits and thresholds), bg_cand_s (pass 2 + its copies), bg_order_s
    (canonical order); cand_count, cand_mb (bytes of the copied
    candidates)."""
    from ldweaver_tpu_torch.core.mi import LinkTable

    stats: Dict[str, float] = {}
    if total_sr == 0 or not segs:
        empty = [
            LinkTable(*(np.zeros(0, np.int64),) * 4, np.zeros(0), np.zeros(0))
            for _ in range(nclust)
        ]
        return DeviceSrReduction(fits={}, tables=empty, stats=stats)

    t0 = time.perf_counter()
    flat = flat_segments(segs, pos_dev, paint_dev, B, int(g), int(sr_dist))
    ns, xlo, xhi = group_stats(flat, sr_dist, nclust)
    stats["bg_stats_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    fits = fits_from_group_stats(ns, xlo, xhi, sr_dist)
    T = threshold_tables(fits, nclust, sr_dist)
    stats["bg_fit_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    gi, gj, mi = candidates(flat, T, sr_dist, nclust)
    count = int(gi.size)
    stats["bg_cand_s"] = round(time.perf_counter() - t0, 3)
    stats["cand_count"] = count
    stats["cand_mb"] = round(12 * count / 1e6, 1)

    t0 = time.perf_counter()
    tables = candidates_to_tables(
        gi, gj, mi, count, ranked_pos, paint_sorted, g, B, nb, nclust
    )
    stats["bg_order_s"] = round(time.perf_counter() - t0, 3)
    return DeviceSrReduction(fits=fits, tables=tables, stats=stats)


# --------------------------------------------------------------------------
# The grid-partitioned reduction over several shards ("part")
# --------------------------------------------------------------------------
# Each shard keeps the SR pairs of its own tiles.  The k2 grid
# [1, 2*sr_dist) is cut into ranges sized from exact host-side counts
# (every link's distance key follows from the positions), and for each
# range every shard compacts its live links in the range into a record
# buffer of the range's cap; the buffers of all shards, gathered in shard
# order, give every process the range's group multisets, and the same sort
# and gathers as pass 1 give their order statistics.  The ranges are
# disjoint and cover the grid, so the fits equal the single-device ones.
# The candidates need no ranges: each shard compacts its own, and
# `candidates_to_tables` puts the gathered union into canonical order.
def _tile_count_le(pos_f: np.ndarray, pos_t: np.ndarray, g: int,
                   max_len: int, same_block: bool) -> int:
    """Exact #pairs of one tile with integer circular len <= max_len."""
    from ldweaver_tpu_torch.parallel.spmd_sweep import tile_sr_count

    if max_len <= 0:
        return 0
    return tile_sr_count(pos_f, pos_t, g, max_len, same_block)


def partition_plan(
    dev_tiles: Sequence[Sequence[Tuple[int, int]]], pos_blocks, g: int,
    sr_dist: int, part_budget_bytes: int, bytes_per_link: int = 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """(bounds, caps): k2-range boundaries [P+1] (ranges [b_i, b_{i+1}),
    b_0 = 1, b_P = 2*sr_dist) and each (range, shard)'s exact live count
    [P, nsh], the ranges doubled until every range's gathered buffer
    (nsh * the largest shard's count * bytes_per_link) fits the budget.
    `dev_tiles` are the shards' tile lists, `pos_blocks` each block's
    valid positions.  The JAX package's plan (sr_reduce.py:320-375), with
    each bound's counts computed once."""
    nsh = len(dev_tiles)
    memo: Dict[int, np.ndarray] = {}

    def counts_at(bound_k2: int) -> np.ndarray:
        """[nsh] counts of live links with k2 < bound_k2 per shard."""
        if bound_k2 not in memo:
            max_len = (bound_k2 - 1) // 2  # k2 <= bound-1  <=>  len <= this
            memo[bound_k2] = np.array([
                sum(_tile_count_le(pos_blocks[bi], pos_blocks[bj], g, max_len,
                                   bi == bj) for bi, bj in tiles)
                for tiles in dev_tiles
            ], np.int64)
        return memo[bound_k2]

    P = 2
    while True:
        bounds = np.unique(np.linspace(1, 2 * sr_dist, P + 1).astype(np.int64))
        cum = np.stack([counts_at(int(b)) for b in bounds])  # [P+1, nsh]
        caps = cum[1:] - cum[:-1]  # [P, nsh]
        worst = int(caps.max(axis=1).max()) if caps.size else 0
        if worst * nsh * bytes_per_link <= part_budget_bytes:
            return bounds, caps
        if P >= 256 or len(bounds) - 1 >= 2 * sr_dist - 1:
            print(f"WARNING: SR reduction partition"
                  f" {worst * nsh * bytes_per_link / 1e9:.1f} GB exceeds the"
                  f" {part_budget_bytes / 1e9:.1f} GB range budget even at"
                  " one-distance-key granularity; the partitioned pass may"
                  " exhaust device memory: add shards or use"
                  " sr_reduce='host'.", flush=True)
            return bounds, caps
        P *= 2


def empty_flat(device) -> FlatLinks:
    z = torch.zeros(0, dtype=torch.int32, device=device)
    return FlatLinks(k2=z, mi=torch.zeros(0, device=device), c1=z, c2=z,
                     gi=z, gj=z, live=torch.zeros(0, dtype=torch.bool,
                                                  device=device))


def _as_i32_bits(u: torch.Tensor) -> torch.Tensor:
    """[0, 2^32) held in i64 -> the same 32 bits as i32."""
    return torch.where(u >= _TOP, u - (1 << 32), u).to(torch.int32)


def part_records(flat: FlatLinks, lo: int, hi: int, count: int,
                 cap: int) -> torch.Tensor:
    """[cap, 4] i32 records (k2, mono MI bits, c1, c2) of the shard's
    `count` live links with k2 in [lo, hi), then pad records under the
    _DEAD key with the shard's first link's MI (the JAX package's
    `_build_part_compact` fill, so the range buffer holds the same
    elements)."""
    dev = flat.mi.device
    idx = torch.nonzero(flat.live & (flat.k2 >= lo) & (flat.k2 < hi)).reshape(-1)
    if idx.numel() != count:
        raise RuntimeError(f"range [{lo}, {hi}): {idx.numel()} links on the"
                           f" device, {count} counted on the host")
    out = torch.zeros((cap, 4), dtype=torch.int32, device=dev)
    out[:, 0] = _DEAD
    if flat.mi.numel():
        out[:, 1] = _as_i32_bits(mono_u32(flat.mi[:1]))
    out[:count, 0] = flat.k2.index_select(0, idx)
    out[:count, 1] = _as_i32_bits(mono_u32(flat.mi.index_select(0, idx)))
    out[:count, 2] = flat.c1.index_select(0, idx)
    out[:count, 3] = flat.c2.index_select(0, idx)
    return out


def range_stats(buf: torch.Tensor, lo: int, hi: int, nclust: int):
    """`order_stats` of a gathered range buffer over the keys [lo, hi)."""
    key = buf[:, 0].to(torch.int64)
    mono = buf[:, 1].to(torch.int64) & _U32
    return order_stats(key, mono, buf[:, 2], buf[:, 3], lo, hi, nclust)


def part_group_stats(flats: Sequence[FlatLinks], bounds: np.ndarray,
                     caps: np.ndarray, first_shard: int, sr_dist: int,
                     nclust: int, gather: Optional[Callable] = None):
    """Pass 1 by k2 range: (ns, xlo, xhi) [nclust, 2*sr_dist - 1] as
    `group_stats` gives them, and the largest gathered range buffer in
    bytes.  `flats` are this process's local shards (global shards
    first_shard, first_shard + 1, ...); `bounds` and `caps` come from
    `partition_plan`."""
    dev0 = flats[0].mi.device
    grid_n = 2 * sr_dist - 1
    ns = np.zeros((nclust, grid_n), np.int32)
    xlo = np.zeros((nclust, grid_n), np.float32)
    xhi = np.zeros((nclust, grid_n), np.float32)
    top = 0
    for i in range(len(bounds) - 1):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        if i == len(bounds) - 2:
            hi = 2 * sr_dist  # the last range reaches the grid's end
        cap = int(caps[i].max())
        if cap == 0:
            continue  # empty on every shard (host-proven)
        bufs = [part_records(f, lo, hi, int(caps[i, first_shard + l]), cap)
                for l, f in enumerate(flats)]
        if gather is None:
            buf = torch.cat([b.to(dev0) for b in bufs])
        else:
            host = [b for part in gather([b.cpu().numpy() for b in bufs])
                    for b in part]
            buf = torch.from_numpy(np.concatenate(host)).to(dev0)
        top = max(top, buf.numel() * 4)
        sl = slice(lo - 1, hi - 1)  # grid index = k2 - 1
        ns[:, sl], xlo[:, sl], xhi[:, sl] = range_stats(buf, lo, hi, nclust)
        del buf, bufs
    return ns, xlo, xhi, top


def run_part_reduction(
    lane_segs: List[list], pos_devs: Sequence[torch.Tensor],
    paint_devs: Sequence[torch.Tensor], *,
    shard_tiles: Sequence[Sequence[Tuple[int, int]]], first_shard: int,
    pos_blocks: Sequence[np.ndarray], ranked_pos: np.ndarray,
    paint_sorted: np.ndarray, B: int, nb: int, g: int, sr_dist: int,
    nclust: int, total_sr: int, part_budget_bytes: int,
    gather: Optional[Callable] = None,
) -> DeviceSrReduction:
    """The grid-partitioned reduction.  `lane_segs[l]` are the kept SR
    outputs (bi, bj, sr_idx, sr_vals) of this process's local shard
    first_shard + l, in canonical order, on that shard's device (the
    lists are emptied: the flat arrays replace them); `shard_tiles` are
    every shard's tiles; `gather(obj)` returns every process's obj in rank
    order (`multihost.allgather_object`; None in one process).  Every
    process issues the same gathers in the same order and returns the same
    fits and tables.  Stats as `run_device_reduction`, with sr_partitions,
    range_budget (`part_budget_bytes`, the bound on a gathered range
    buffer) and range_mb (the largest one)."""
    from ldweaver_tpu_torch.core.mi import LinkTable

    stats: Dict[str, float] = {}
    if total_sr == 0:
        empty = [
            LinkTable(*(np.zeros(0, np.int64),) * 4, np.zeros(0), np.zeros(0))
            for _ in range(nclust)
        ]
        return DeviceSrReduction(fits={}, tables=empty, stats=stats)

    t0 = time.perf_counter()
    flats = []
    for l, segs in enumerate(lane_segs):
        flats.append(flat_segments(segs, pos_devs[l], paint_devs[l], B, int(g),
                                   int(sr_dist))
                     if segs else empty_flat(pos_devs[l].device))
        segs.clear()
    bounds, caps = partition_plan(shard_tiles, pos_blocks, int(g),
                                  int(sr_dist), part_budget_bytes)
    ns, xlo, xhi, top = part_group_stats(flats, bounds, caps, first_shard,
                                         sr_dist, nclust, gather)
    stats["sr_partitions"] = len(bounds) - 1
    stats["range_budget"] = int(part_budget_bytes)
    stats["range_mb"] = round(top / 1e6, 1)
    stats["bg_stats_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    fits = fits_from_group_stats(ns, xlo, xhi, sr_dist)
    T = threshold_tables(fits, nclust, sr_dist)
    stats["bg_fit_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    cand = [candidates(f, T, sr_dist, nclust) for f in flats]
    del flats
    if gather is not None:
        cand = [c for part in gather(cand) for c in part]
    gi, gj, mi = (np.concatenate([c[k] for c in cand]) for k in range(3))
    count = int(gi.size)
    stats["bg_cand_s"] = round(time.perf_counter() - t0, 3)
    stats["cand_count"] = count
    stats["cand_mb"] = round(12 * count / 1e6, 1)

    t0 = time.perf_counter()
    tables = candidates_to_tables(
        gi, gj, mi, count, ranked_pos, paint_sorted, g, B, nb, nclust
    )
    stats["bg_order_s"] = round(time.perf_counter() - t0, 3)
    return DeviceSrReduction(fits=fits, tables=tables, stats=stats)
