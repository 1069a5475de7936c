"""Short-range background model + p-values.

Reference: `mergeNsort_sr_links` (R/computePairwiseMI.R:400-495).  Per CDS
diversity cluster:

  1. keep links with 0 < len < sr_dist (strict, lines 416-419)
  2. per unique distance, the 95th-percentile MI (type-7 quantile,
     line 422; dplyr group_by sorts distances ascending)
  3. log-log OLS fit  log(q95) ~ log(len)  (fastLm, line 428)
  4. `mean_dist[sr_links_t$len]` (line 448) indexes the fitted vector BY
     RAW DISTANCE VALUE, i.e. the len-th element of the per-unique-distance
     fitted vector, NOT the fitted value at that distance.  Out-of-range
     indexing yields NA and the link is silently dropped (lines 457-458).
     This reference quirk is replicated exactly (fit_lookup()).
  5. positive residuals fitted to a Beta distribution with fitdistrplus
     defaults (MME start + Nelder-Mead MLE, line 452)
  6. srp = -pbeta(resid, a, b, lower.tail=F, log.p=T)  (natural log
     survival, line 453)
  7. cross-cluster duplicates (clust1 != clust2) keep the max srp
     (lines 460-486); sr_links_red = srp_max > srp_cutoff (line 489);
     the ARACNE check pool is every link with MI >= min(sr_links_red$MI)
     (line 490).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ldweaver_tpu_torch.core.mi import LinkTable
from ldweaver_tpu_torch.utils.r_compat import fit_beta_mle, log_beta_sf, quantile_type7


@dataclasses.dataclass
class ClusterFit:
    """Per-cluster background fit artifacts (saved like cX_fit_data.rds)."""

    lens: np.ndarray  # unique distances, ascending
    q95: np.ndarray  # 95th-percentile MI per distance
    fitted: np.ndarray  # exp(OLS fit) per distance
    coef: Tuple[float, float]  # (slope, intercept) of log-log fit
    beta_shape: Tuple[float, float]


@dataclasses.dataclass
class SrLinks:
    """sr link table with cluster-of-record + srp (data.frame stand-in)."""

    clust_c: np.ndarray
    pos1: np.ndarray
    pos2: np.ndarray
    clust1: np.ndarray
    clust2: np.ndarray
    len: np.ndarray
    MI: np.ndarray
    srp_max: np.ndarray
    ARACNE: Optional[np.ndarray] = None

    def __len__(self):
        return self.pos1.size

    def take(self, idx) -> "SrLinks":
        return SrLinks(
            self.clust_c[idx],
            self.pos1[idx],
            self.pos2[idx],
            self.clust1[idx],
            self.clust2[idx],
            self.len[idx],
            self.MI[idx],
            self.srp_max[idx],
            None if self.ARACNE is None else self.ARACNE[idx],
        )


def _len_sort(lens: np.ndarray):
    """(order, uniq, group_bounds, int_key) for the
    per-distance grouping.  Circular distances are exact (half-)integers
    (integral for even g, .5 steps for odd g — positions are ints), so a
    stable argsort on the int32 key 2*len (radix, O(n)) replaces the f64
    comparison sort, and group boundaries come from one bincount instead
    of a second sort inside np.unique.  Identical order/grouping to the
    f64 path (the key map is strictly monotonic and exact); non-dyadic or
    out-of-range lens (never produced by circular_len, defensive) fall
    back to the general path with int_key=None."""
    key2 = lens * 2.0
    k = key2.astype(np.int64)
    if (
        k.size
        and (k >= 0).all()
        and int(k.max()) < (1 << 31)
        # bincount allocates max_key+1 slots: bound it by the input size
        # (sr-merge lens are < sr_dist so this always holds there) so a
        # sparse huge key through the PUBLIC fit_cluster_background entry
        # cannot trigger a multi-GB allocation — the sort path is O(n)
        # memory and identical in output
        and int(k.max()) <= max(8 * k.size, 1 << 20)
        and np.array_equal(k, key2)
    ):
        k32 = k.astype(np.int32)
        order = np.argsort(k32, kind="stable")
        counts = np.bincount(k32)  # pre-sort: bincount is order-free
        nz = np.flatnonzero(counts)
        starts = np.zeros(nz.size, dtype=np.int64)
        np.cumsum(counts[nz][:-1], out=starts[1:])
        uniq = nz / 2.0  # exact: uniq values are dyadic by construction
    else:
        k = None
        order = np.argsort(lens, kind="stable")
        uniq, starts = np.unique(lens[order], return_index=True)
    return order, uniq, np.append(starts, lens.size), k


def _fit_from_sorted(lens: np.ndarray, mi: np.ndarray):
    """(ClusterFit, int_key) — the shared fit core; the int key is reused
    by _fit_lookup_key so the merge never re-truncates 1e8 f64 lens."""
    order, uniq, bounds, k = _len_sort(lens)
    mi_sorted = mi[order]
    q95 = np.empty(uniq.size, dtype=np.float64)
    for gi in range(uniq.size):
        # inlined quantile_type7(v, 0.95) on the group slice (bit-equal:
        # same f64 ops, minus per-call asarray/astype overhead that
        # dominated the 1e8-row production profile)
        v = np.sort(mi_sorted[bounds[gi] : bounds[gi + 1]])
        n = v.size
        if n == 1:
            q95[gi] = v[0]
        else:
            h = (n - 1) * 0.95
            lo = int(h)
            hi = lo + 1 if lo + 1 < n else n - 1
            q95[gi] = v[lo] + (h - lo) * (v[hi] - v[lo])
    return _fit_from_q95(uniq, q95), k


def fit_cluster_background(lens: np.ndarray, mi: np.ndarray) -> ClusterFit:
    """Steps 2-5 for one cluster's links (already len-filtered)."""
    return _fit_from_sorted(lens, mi)[0]


def _fit_from_q95(uniq: np.ndarray, q95: np.ndarray) -> ClusterFit:
    # log-log OLS: log(q95) = slope*log(len) + intercept.
    # Divergence: q95 can be non-positive (the MI statistic dips below 0
    # for anti-associated pairs); the reference feeds the resulting NaN
    # into fastLm and errors out (R/computePairwiseMI.R:428).  We fit on
    # the positive rows and predict for all rows, which keeps the
    # mean_dist[len] index semantics intact.
    X = np.column_stack([np.log(uniq), np.ones(uniq.size)])
    ok = q95 > 0
    if not ok.any():
        raise ValueError("no positive q95 values to fit the decay model")
    coef, *_ = np.linalg.lstsq(X[ok], np.log(q95[ok]), rcond=None)
    fitted = np.exp(X @ coef)
    return ClusterFit(
        lens=uniq, q95=q95, fitted=fitted, coef=(float(coef[0]), float(coef[1])),
        beta_shape=(np.nan, np.nan),
    )


def fit_lookup(fit: ClusterFit, lens: np.ndarray) -> np.ndarray:
    """`mean_dist[len]` - R 1-based vector indexing by raw distance value,
    NA (here NaN) when len exceeds the fitted-vector length
    (R/computePairwiseMI.R:448; see module docstring).  R truncates
    fractional numeric subscripts toward zero (circular distances can be
    half-integral when g is odd), so we truncate too."""
    idx = np.asarray(np.trunc(lens), dtype=np.int64) - 1  # 1-based -> 0-based
    out = np.full(lens.shape, np.nan, dtype=np.float64)
    ok = (idx >= 0) & (idx < fit.fitted.size)
    out[ok] = fit.fitted[idx[ok]]
    return out


def _fit_lookup_key(fit: ClusterFit, k: np.ndarray) -> np.ndarray:
    """fit_lookup via the exact integer key 2*len from _len_sort
    (k >> 1 == trunc(len) for non-negative dyadic lens): one padded-table
    gather instead of trunc/astype/mask passes over 1e8 f64 values.
    Index -1 (len in (0,1)) and indices past the fitted vector land on
    NaN pad slots — identical to fit_lookup."""
    idx = (k >> 1) - 1  # 1-based -> 0-based; >= -1
    hi = int(idx.max(initial=0))
    tab = np.full(max(hi + 2, fit.fitted.size + 1), np.nan)
    tab[1 : fit.fitted.size + 1] = fit.fitted
    return tab[np.minimum(idx, fit.fitted.size) + 1]


def _score_cluster(ci: int, t: LinkTable, fit: ClusterFit,
                   mean_dist: np.ndarray):
    """Steps 5-6 of mergeNsort_sr_links for one cluster: positive
    residuals against the fitted decay (strict diff > 0, R which()
    semantics R/computePairwiseMI.R:449), beta MLE over them, srp, and
    the SrLinks rows.  The SINGLE implementation consumed by both the
    host oracle (_one_cluster) and the device-reduce candidates path
    (merge_and_sort_sr_links_from_candidates) so the byte-identity
    contract between sr_reduce modes cannot drift."""
    diff = t.MI - mean_dist  # NaN propagates
    with np.errstate(invalid="ignore"):
        pos_mask = diff > 0  # NaN -> False (R which() drops NA)
    pos_idx = np.flatnonzero(pos_mask)
    if pos_idx.size == 0:
        return None
    a, b = fit_beta_mle(diff[pos_idx])
    fit.beta_shape = (a, b)
    srp = -log_beta_sf(diff[pos_idx], a, b)  # :453
    kept = t.take(pos_idx)
    rows = SrLinks(
        clust_c=np.full(pos_idx.size, ci, dtype=np.int64),
        pos1=kept.pos1,
        pos2=kept.pos2,
        clust1=kept.clust1,
        clust2=kept.clust2,
        len=kept.len,
        MI=kept.MI,
        srp_max=np.asarray(srp, dtype=np.float64),
    )
    return fit, rows


def merge_and_sort_sr_links(
    nclust: int,
    sr_links_per_clust: List[LinkTable],
    sr_dist: int,
    srp_cutoff: float,
) -> Tuple[SrLinks, SrLinks, Dict[int, ClusterFit]]:
    """Full mergeNsort_sr_links equivalent.

    Returns (sr_links_red, sr_links_ARACNE_check, fits).
    """
    if nclust != len(sr_links_per_clust):
        raise ValueError("Cluster mismatch detected, stopping!")  # :405

    def _one_cluster(ci: int):
        """Steps 1-6 for one cluster (independent of the others, so the
        clusters run on a small thread pool — the heavy numpy/scipy calls
        release the GIL and the per-cluster link lists are ~1e8 rows at
        production scale).  Returns (fit, rows) or None."""
        t = sr_links_per_clust[ci - 1]
        if len(t) == 0:
            return None
        keep = (
            ~np.isnan(t.len) & (t.len < sr_dist) & (t.len > 0)
        )  # strict, :417-419
        if not keep.all():  # skip the 6-column copy when nothing drops
            t = t.take(np.flatnonzero(keep))
        if len(t) == 0:
            return None
        fit, lkey = _fit_from_sorted(t.len, t.MI)
        mean_dist = (
            _fit_lookup_key(fit, lkey) if lkey is not None
            else fit_lookup(fit, t.len)
        )
        return _score_cluster(ci, t, fit, mean_dist)

    if nclust > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(nclust, 4)) as ex:
            cluster_results = list(ex.map(_one_cluster, range(1, nclust + 1)))
    else:
        cluster_results = [_one_cluster(1)]

    return _merge_rows(cluster_results, srp_cutoff)


def merge_and_sort_sr_links_from_candidates(
    nclust: int,
    cand_tables: List[LinkTable],
    fits_prelim: Dict[int, ClusterFit],
    sr_dist: int,
    srp_cutoff: float,
) -> Tuple[SrLinks, SrLinks, Dict[int, ClusterFit]]:
    """mergeNsort_sr_links when steps 1-4 already ran ON DEVICE
    (parallel/sr_reduce.py): `fits_prelim` holds the per-cluster decay
    fits re-derived on host from the device group statistics (bit-equal
    to fit_cluster_background over the full link set — same two order
    statistics, same f64 interpolation/OLS), and `cand_tables[c-1]` holds
    a SUPERSET of cluster c's positive-residual links in the canonical
    emission order (panel tile order, row-major within tile).  Steps 5-7
    (beta MLE, srp, cross-cluster dedup, cutoff, ARACNE check pool) run
    on the candidates exactly as the host oracle runs them on the full
    table: every f64 reduction sees the identical value sequence, so
    outputs are byte-identical to `merge_and_sort_sr_links` (the
    conservative f32 threshold band only adds rows with diff <= 0, which
    the strict `diff > 0` filter drops before any reduction)."""
    if nclust != len(cand_tables):
        raise ValueError("Cluster mismatch detected, stopping!")
    cluster_results = []
    for ci in range(1, nclust + 1):
        t = cand_tables[ci - 1]
        fit = fits_prelim.get(ci)
        if fit is None or len(t) == 0:
            cluster_results.append(None)
            continue
        keep = (
            ~np.isnan(t.len) & (t.len < sr_dist) & (t.len > 0)
        )  # no-op by construction (device filters the same range); parity
        if not keep.all():
            t = t.take(np.flatnonzero(keep))
        if len(t) == 0:
            cluster_results.append(None)
            continue
        cluster_results.append(
            _score_cluster(ci, t, fit, fit_lookup(fit, t.len))
        )
    return _merge_rows(cluster_results, srp_cutoff)


def _merge_rows(cluster_results, srp_cutoff: float):
    """Steps 6-7 shared by the host oracle and the device-reduce path:
    cross-cluster dedup keeping the first row achieving the group-max
    srp, the srp cutoff, and the ARACNE check pool."""
    per_cluster_rows: List[SrLinks] = []
    dup_rows: List[SrLinks] = []
    fits: Dict[int, ClusterFit] = {}

    for ci, result in enumerate(cluster_results, start=1):
        if result is None:
            continue
        fit, rows = result
        fits[ci] = fit
        dup_mask = rows.clust1 != rows.clust2  # :460
        if dup_mask.any():
            per_cluster_rows.append(rows.take(np.flatnonzero(~dup_mask)))
            dup_rows.append(rows.take(np.flatnonzero(dup_mask)))
        else:
            per_cluster_rows.append(rows)

    def _concat(parts: List[SrLinks]) -> SrLinks:
        if not parts:
            e = np.zeros(0, dtype=np.int64)
            f = np.zeros(0, dtype=np.float64)
            return SrLinks(e, e.copy(), e.copy(), e.copy(), e.copy(), f, f.copy(), f.copy())
        return SrLinks(
            *[
                np.concatenate([getattr(p, name) for p in parts])
                for name in (
                    "clust_c",
                    "pos1",
                    "pos2",
                    "clust1",
                    "clust2",
                    "len",
                    "MI",
                    "srp_max",
                )
            ]
        )

    sr_df = _concat(per_cluster_rows)
    dups = _concat(dup_rows)

    if len(dups) > 0:
        # data.table: group by all columns except srp_max and clust_c, keep
        # the FIRST row achieving the group max srp (groups in first-seen
        # order) - R/computePairwiseMI.R:478-486.  Grouping key: (pos1,
        # pos2) DETERMINES the remaining key columns — clust1/clust2 are
        # the painted clusters of those positions and len/MI are computed
        # once for the (unique) pair — so a packed int64 (pos1, pos2) key
        # groups identically to the reference's 6-column key, in the same
        # (pos1, pos2)-lexicographic group order, at ~3x the throughput of
        # a structured-array np.unique (which dominated the merge at the
        # 1e8-row production scale).  Positions beyond 2^31 (no bacterial
        # genome) fall back to the structured key.
        n = len(dups)
        # both positions must fit 31 bits (pos1 is NOT bounded by pos2 —
        # SR emission keeps the reference orientation) and be
        # non-negative, else pos1 << 31 would overflow and corrupt the
        # group order vs the structured-key path
        if dups.pos2.size and int(dups.pos2.max()) < (1 << 31) and int(
            dups.pos1.max()
        ) < (1 << 31) and int(dups.pos1.min()) >= 0 and int(
            dups.pos2.min()
        ) >= 0:
            key = (np.asarray(dups.pos1, np.int64) << 31) | np.asarray(
                dups.pos2, np.int64
            )
        else:
            key = np.empty(
                n,
                dtype=[("p1", "<i8"), ("p2", "<i8"), ("c1", "<i8"),
                       ("c2", "<i8"), ("ln", "<f8"), ("mi", "<f8")],
            )
            key["p1"] = dups.pos1
            key["p2"] = dups.pos2
            key["c1"] = dups.clust1
            key["c2"] = dups.clust2
            key["ln"] = dups.len + 0.0
            key["mi"] = dups.MI + 0.0
        _, first_seen, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        gmax = np.full(first_seen.size, -np.inf)
        np.maximum.at(gmax, inv, dups.srp_max)
        cand = dups.srp_max == gmax[inv]  # rows achieving their group max
        first_hit = np.full(first_seen.size, n, dtype=np.int64)
        np.minimum.at(first_hit, inv[cand], np.flatnonzero(cand))
        sel = first_hit[np.argsort(first_seen, kind="stable")]
        merged = _concat([sr_df, dups.take(sel)])
    else:
        merged = sr_df

    red_mask = merged.srp_max > srp_cutoff  # strict, :489
    sr_links_red = merged.take(np.flatnonzero(red_mask))
    if len(sr_links_red) > 0:
        min_mi = sr_links_red.MI.min()
        check = merged.take(np.flatnonzero(merged.MI >= min_mi))  # :490
    else:
        check = sr_links_red
    return sr_links_red, check, fits
