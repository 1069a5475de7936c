"""Rank-compacted, r-stratified MI tile (the engine of the spmd sweep).

Two structural observations cut the reference's 25-product / 25-log cost
per block pair (R/computePairwiseMI.R:270-298):

  1. **Allele-rank compaction.** The MI statistic is permutation-invariant
     over allele identity, so re-encoding each site's alleles by frequency
     rank (0 = major allele) compresses the 5-allele axis to the site's
     actual r <= 5 alleles with no loss.
  2. **Marginal closure.** sum_y n_XY = n_X exactly, so the last rank row
     and column of each contingency tile derive from the marginals: only
     (r_f - 1) * (r_t - 1) contingency products are needed.

Stratifying SNPs by r (a stable sort) makes blocks r-homogeneous, so each
block pair has a static (Rf, Rt): a biallelic x biallelic tile needs ONE
count plane and 4 log terms.  `RankedSnps`, `rank_encode` and `stratify`
are NumPy copies of the JAX package's; `wparts` and `rank_tile_mi` are the
PyTorch counterparts of its `_wparts` and `_rank_tile_mi`, the tile itself
coming from kernel K1 (ops/rank_mi.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldweaver_tpu_torch.ops.rank_mi import N_TERMS, rank_mi_tile


# --------------------------------------------------------------------------
# Host-side rank compaction + stratification
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RankedSnps:
    rank_codes: np.ndarray  # [nseq, nsnp] uint8 (0..r-1, sorted by r)
    pos: np.ndarray  # [nsnp] permuted genome positions
    r: np.ndarray  # [nsnp] permuted distinct-allele counts (ascending)
    perm: np.ndarray  # sorted-order -> original-site index
    block: int
    block_rmax: np.ndarray  # [nb] max r within each block
    # True where every VALID (non-pad) site of the block has r == rmax;
    # such blocks qualify for the telescoped pure-r epilogue (pad rows
    # then hold garbage-but-finite values, masked out downstream)
    block_pure: np.ndarray = None


def rank_encode(codes: np.ndarray, acgtn_table: np.ndarray) -> np.ndarray:
    """Map each site's alleles to frequency ranks (0 = most frequent;
    count ties broken by allele index, deterministic)."""
    nseq, nsnp = codes.shape
    # order alleles per site by (-count, allele); rank_of[site, allele]
    order = np.argsort(
        -(acgtn_table.T * 8 - np.arange(5)[None, :]), axis=1, kind="stable"
    )  # [nsnp, 5] allele ids in rank order
    rank_of = np.empty((nsnp, 5), dtype=np.uint8)
    np.put_along_axis(
        rank_of, order, np.arange(5, dtype=np.uint8)[None, :].repeat(nsnp, 0), axis=1
    )
    return rank_of[np.arange(nsnp)[None, :], codes]


def stratify(
    codes: np.ndarray,
    acgtn_table: np.ndarray,
    pos: np.ndarray,
    r: np.ndarray,
    block: int,
) -> RankedSnps:
    """Rank-encode + stable-sort sites by r + pad to a block multiple.

    Padded sites get r=1 (single-allele: every contingency count lands in
    rank 0 and the uq gate x<r kills all but the (0,0) term, whose
    pxy/denom ratio contributes log(~1) ~ 0 ... they are additionally
    masked out by `valid` downstream)."""
    rank_codes = rank_encode(codes, acgtn_table)
    perm = np.argsort(r, kind="stable")
    rank_codes = np.ascontiguousarray(rank_codes[:, perm])
    pos_s = pos[perm]
    r_s = r[perm].astype(np.int32)

    nsnp = pos_s.size
    npad = (-nsnp) % block
    if npad:
        nseq = codes.shape[0]
        rank_codes = np.concatenate(
            [rank_codes, np.zeros((nseq, npad), np.uint8)], axis=1
        )
        pos_s = np.concatenate([pos_s, np.zeros(npad, pos_s.dtype)])
        r_s = np.concatenate([r_s, np.ones(npad, np.int32)])
    nb = rank_codes.shape[1] // block
    block_rmax = np.array(
        [int(r_s[i * block : (i + 1) * block].max()) for i in range(nb)],
        dtype=np.int32,
    )
    block_pure = np.array(
        [
            bool(
                (r_s[i * block : min((i + 1) * block, nsnp)] == block_rmax[i]).all()
            )
            for i in range(nb)
        ],
        dtype=bool,
    )
    return RankedSnps(
        rank_codes=rank_codes,
        pos=pos_s,
        r=r_s,
        perm=perm,
        block=block,
        block_rmax=block_rmax,
        block_pure=block_pure,
    )


def wparts(w, terms: int = N_TERMS):
    """(w_f32, stacked bf16 split terms [terms, S]) for the contingency
    counts: term k is the round-to-nearest-even bf16 of what the earlier
    terms left of the f32 weight, so the terms sum to it within ~2^-24
    relative.  Both are CPU tensors."""
    w32 = torch.from_numpy(np.asarray(w, np.float32).copy())
    parts = []
    resid = w32.clone()
    for _ in range(terms):
        p = resid.to(torch.bfloat16)
        parts.append(p)
        resid = resid - p.to(torch.float32)
    return w32, torch.stack(parts)


# --------------------------------------------------------------------------
# Rank-compacted MI tile (static Rf, Rt)
# --------------------------------------------------------------------------
def rank_marginals(codes, start: int, n: int, w32, R: int) -> torch.Tensor:
    """[R, n] f32 weighted allele-rank counts of SNP columns
    start..start+n of the sequence-major code tensor."""
    sl = codes[:, start : start + n]
    return torch.stack(
        [((sl == x).to(torch.float32) * w32[:, None]).sum(dim=0)
         for x in range(R)]
    )


def rank_tile_mi(codes, fs: int, ts: int, nf: int, nt: int, w32, parts,
                 r_f, r_t, neff: float, Rf: int, Rt: int,
                 pure: bool = False) -> torch.Tensor:
    """[nf, nt] MI tile over rank codes with (Rf-1)(Rt-1) count planes.

    `codes` is the sequence-major [nseq, nsnp_pad] u8 tensor; the rows are
    SNP columns fs..fs+nf, the columns ts..ts+nt.  uq gating is implicit:
    rank x occurs iff x < r(site), so the gate is (x < r_f) outer (y < r_t).

    pure=True (every VALID site has r == Rf / Rt; RankedSnps.block_pure)
    switches to the telescoped epilogue: with constant r the denominator
    factorizes and the closure identity collapses the sum to

        MI*den = sum_xy pxy*log(pxy)
               - sum_x Lx[x]*(pX[x] + 0.5*Rt) - sum_y Ly[y]*(pY[y] + 0.5*Rf)
               + den*log(den),  den = neff + 0.5*Rf*Rt

    Pad rows/cols (r=1 < rmax) get garbage-but-finite values; every
    consumer masks pads via `valid` before use."""
    px = rank_marginals(codes, fs, nf, w32, Rf)
    py = rank_marginals(codes, ts, nt, w32, Rt)
    return rank_mi_tile(
        codes, fs, ts, nf, nt, parts, px, py, r_f, r_t, neff, Rf, Rt, pure,
    )
