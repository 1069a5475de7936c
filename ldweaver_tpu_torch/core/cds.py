"""CDS diversity estimation, k-means genome clustering and SNP painting.

Reference: `estimate_variation_in_CDS`, `perform_clustering`, `painter`
(R/estimateCDSDiversity.R:27-221) and the reference-allele masking kernel
`.ACGTN2num` (src/ACGTN2num_parallel.cpp:10-43).

Clustering note: the reference runs stats::kmeans(var, centers=k,
nstart=10) and relabels clusters in descending-size order
(R/estimateCDSDiversity.R:127-148).  For 1-D data the best-of-10
Hartigan-Wong restart almost surely finds the globally optimal partition;
we compute that global optimum deterministically with an exact
dynamic-programming 1-D k-means, then apply the same descending-size
relabelling (stable tie-break), which reproduces the reference labels
without RNG dependence.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Tuple

import numpy as np

from ldweaver_tpu_torch.core.snp_tensor import SnpData

ALPHA = ("A", "C", "G", "T", "*")  # R/estimateCDSDiversity.R:90


# --------------------------------------------------------------------------
# Reference-allele masking (.ACGTN2num)
# --------------------------------------------------------------------------
def reference_mask(ref_chars: np.ndarray) -> np.ndarray:
    """[5, nsnp] 0/1 mask zeroing each SNP's reference-allele row.

    Matches src/ACGTN2num_parallel.cpp:18-40 exactly: only the uppercase
    characters 'A','C','G','T','N','-' mask a row ('-' masks the N row);
    any other character (including lowercase) leaves the column unmasked.
    """
    nsnp = len(ref_chars)
    mask = np.ones((5, nsnp), dtype=np.int64)
    lut = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4, "-": 4}
    for c, (ch) in enumerate(ref_chars):
        row = lut.get(ch)
        if row is not None:
            mask[row, c] = 0
    return mask


# --------------------------------------------------------------------------
# Exact 1-D k-means (DP) + reference relabelling
# --------------------------------------------------------------------------
def _kmeans_1d_optimal(x: np.ndarray, k: int) -> np.ndarray:
    """Globally optimal 1-D k-means assignment (labels 0..k-1 in
    value-ascending cluster order) via O(k n^2) dynamic programming."""
    n = x.size
    order = np.argsort(x, kind="stable")
    xs = x[order]
    ps = np.concatenate([[0.0], np.cumsum(xs)])
    ps2 = np.concatenate([[0.0], np.cumsum(xs * xs)])

    def cost(i, j):  # within-SS of xs[i..j-1]
        m = j - i
        s = ps[j] - ps[i]
        return (ps2[j] - ps2[i]) - s * s / m

    D = np.full((k + 1, n + 1), np.inf)
    B = np.zeros((k + 1, n + 1), dtype=np.int64)
    D[0, 0] = 0.0
    for kk in range(1, k + 1):
        for j in range(kk, n + 1):
            best, arg = np.inf, kk - 1
            for i in range(kk - 1, j):
                c = D[kk - 1, i] + cost(i, j)
                if c < best:
                    best, arg = c, i
            D[kk, j] = best
            B[kk, j] = arg
    # backtrack boundaries
    labels_sorted = np.empty(n, dtype=np.int64)
    j = n
    for kk in range(k, 0, -1):
        i = B[kk, j]
        labels_sorted[i:j] = kk - 1
        j = i
    labels = np.empty(n, dtype=np.int64)
    labels[order] = labels_sorted
    return labels


@dataclasses.dataclass
class Clusters:
    km_clst_ord: np.ndarray  # 1-based labels, descending-size order
    cutoff: float


def perform_clustering(var_estimate: np.ndarray, nclust: int = 3) -> Clusters:
    """k-means + descending-size relabel (R/estimateCDSDiversity.R:127-148).

    Relabel: cluster with the i-th largest member count becomes label i
    (stable tie-break by original id, matching R's order())."""
    k = min(nclust, np.unique(var_estimate).size)
    labels0 = _kmeans_1d_optimal(np.asarray(var_estimate, dtype=np.float64), k)
    counts = np.bincount(labels0, minlength=k)
    km_ord = np.argsort(-counts, kind="stable")  # original id of i-th largest
    new_label = np.empty(k, dtype=np.int64)
    for i, orig in enumerate(km_ord):
        new_label[orig] = i + 1
    relabelled = new_label[labels0]
    cutoff = float(var_estimate[relabelled == 1].max())
    return Clusters(km_clst_ord=relabelled, cutoff=cutoff)


# --------------------------------------------------------------------------
# SNP painting (with the reference's exact edge-case handling)
# --------------------------------------------------------------------------
def painter(
    pos: np.ndarray,
    clusters: Clusters,
    cds_start: np.ndarray,
    cds_end: np.ndarray,
) -> np.ndarray:
    """Paint every SNP with its CDS cluster; fill unpainted (intergenic /
    boundary) runs from neighbouring regions.

    Faithful translation of `painter` (R/estimateCDSDiversity.R:151-210)
    including its quirks:
      * CDS interval test is STRICT (start < POS < end, line 156), so SNPs
        exactly on a CDS boundary start unpainted;
      * the run-length scan drops the final run when the last SNP starts a
        new run (lines 166-180);
      * half-open zero runs are split at round((end-begin)/2) with R's
        half-to-even rounding (lines 199-207).
    Divergence: when NO SNP is painted at all the reference crashes on an
    out-of-bounds index; we return all-ones with a warning instead.
    """
    n = pos.size
    paint = np.zeros(n, dtype=np.int64)
    labels = clusters.km_clst_ord
    for i in range(1, int(labels.max()) + 1):
        sel = labels == i
        for s, e in zip(cds_start[sel], cds_end[sel]):
            paint[(pos > s) & (pos < e)] = i  # strict, :156

    # run-length regions (value, begin, end) 1-based inclusive - :161-180
    regions: List[List[int]] = []
    begin = 1
    prev_val = paint[0]
    update = False
    for i in range(2, n + 1):  # R loop 2..length(paint)
        if paint[i - 1] != prev_val:
            regions.append([int(prev_val), begin, i - 1])
            begin = i
            prev_val = paint[i - 1]
            update = True
        if i == n:
            if update:
                break  # reference quirk: final run dropped
            regions.append([int(prev_val), begin, i])
        update = False
    if not regions:  # single run - loop never appended (n==1 edge)
        regions.append([int(prev_val), 1, n])

    rm = np.array(regions, dtype=np.int64).T  # rows: value, begin, end

    if not (rm[0] != 0).any():
        warnings.warn(
            "painter: no SNP fell strictly inside any CDS; painting all "
            "SNPs as cluster 1 (the reference errors here)"
        )
        return np.ones(n, dtype=np.int64)

    # leading zero run: take the value of region 2 - :184-188
    if rm[0, 0] == 0 and rm.shape[1] > 1:
        paint[rm[1, 0] - 1 : rm[2, 0]] = rm[0, 1]
        rm[0, 0] = rm[0, 1]
    # trailing zero run: take the value of the region before it - :191-195
    if rm[0, -1] == 0 and rm.shape[1] > 1:
        paint[rm[1, -1] - 1 : rm[2, -1]] = rm[0, -2]
        rm[0, -1] = rm[0, -2]

    # interior zero runs: split between the neighbours - :198-208
    zero_cols = np.flatnonzero(rm[0] == 0)
    for c in zero_cols:
        b, e = int(rm[1, c]), int(rm[2, c])
        if b == e:
            paint[b - 1] = rm[0, c - 1]
        else:
            ss = int(np.round((e - b) / 2.0))  # R round(), half-to-even
            paint[b - 1 : b + ss] = rm[0, c - 1]
            paint[b + ss : e] = rm[0, c + 1]
    return paint


# --------------------------------------------------------------------------
# CDS variation driver
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CdsVar:
    """Equivalent of the reference `cds_var` list
    (R/estimateCDSDiversity.R:114-116)."""

    var_estimate: np.ndarray
    cds_start: np.ndarray
    cds_end: np.ndarray
    clusts: Clusters
    paint: np.ndarray
    ref: np.ndarray  # reference allele char per SNP
    alt: np.ndarray  # ALT string per SNP (VCF prep)
    allele_table: np.ndarray  # [5, nsnp]
    nclust: int

    def save_npz(self, path: str) -> None:
        """Persist as the `cds_var.rds` resume artifact
        (R/BacGWES.R:358-360)."""
        np.savez_compressed(
            path,
            var_estimate=self.var_estimate,
            cds_start=self.cds_start,
            cds_end=self.cds_end,
            km_clst_ord=self.clusts.km_clst_ord,
            cutoff=np.float64(self.clusts.cutoff),
            paint=self.paint,
            ref=self.ref,
            alt=self.alt,
            allele_table=self.allele_table,
            nclust=np.int64(self.nclust),
        )

    @classmethod
    def load_npz(cls, path: str) -> "CdsVar":
        """Reload a saved cds_var artifact (R/BacGWES.R:361-364)."""
        with np.load(path, allow_pickle=False) as z:
            return cls(
                var_estimate=z["var_estimate"],
                cds_start=z["cds_start"],
                cds_end=z["cds_end"],
                clusts=Clusters(
                    km_clst_ord=z["km_clst_ord"], cutoff=float(z["cutoff"])
                ),
                paint=z["paint"],
                ref=z["ref"],
                alt=z["alt"],
                allele_table=z["allele_table"],
                nclust=int(z["nclust"]),
            )


def estimate_variation_in_cds(
    snp_data: SnpData,
    cds_starts: np.ndarray,
    cds_ends: np.ndarray,
    ref_seq: str,
    num_clusts_cds: int = 3,
) -> CdsVar:
    """CDS diversity + clustering + painting
    (R/estimateCDSDiversity.R:27-124).

    cds_starts/cds_ends: 1-based inclusive CDS ranges from GBK/GFF.
    ref_seq: full reference genome sequence.
    """
    pos = snp_data.pos
    variation = snp_data.acgtn_table.astype(np.int64)  # rowSums == counts
    ref_chars = np.array([ref_seq[p - 1] for p in pos])
    mask = reference_mask(ref_chars)
    var_wo_ref = variation * mask

    alt = np.array(
        [
            ",".join(ALPHA[k] for k in np.flatnonzero(var_wo_ref[:, c] > 0))
            for c in range(pos.size)
        ]
    )
    snp_var = var_wo_ref.sum(axis=0)

    widths = cds_ends - cds_starts + 1
    ncds = cds_starts.size
    var_estimate = np.full(ncds, np.nan)
    # POS is sorted ascending; %between% is inclusive (:99)
    lo = np.searchsorted(pos, cds_starts, side="left")
    hi = np.searchsorted(pos, cds_ends, side="right")
    for c in range(ncds):
        if hi[c] > lo[c]:
            var_estimate[c] = snp_var[lo[c] : hi[c]].sum() / widths[c]

    keep = ~np.isnan(var_estimate)
    var_estimate = var_estimate[keep]
    cds_start = cds_starts[keep]
    cds_end = cds_ends[keep]

    clusts = perform_clustering(var_estimate, nclust=num_clusts_cds)
    paint = painter(pos, clusts, cds_start, cds_end)

    return CdsVar(
        var_estimate=var_estimate,
        cds_start=cds_start,
        cds_end=cds_end,
        clusts=clusts,
        paint=paint,
        ref=ref_chars,
        alt=alt,
        allele_table=variation,
        nclust=num_clusts_cds,
    )
