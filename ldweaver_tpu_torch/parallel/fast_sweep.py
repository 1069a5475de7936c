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
coming from kernel K1 (ops/rank_mi.py), and `mi_tile_rank` of its
host-facing tile.  The counts sum the first t (`precision_terms`, 1 to 3)
bf16 terms of the weights; the marginals and neff stay exact f32 sums.

The LR-only sweep (`prepare_fast_sweep`, `fast_lr_topk`; the sweep leg of
the JAX package's bench.py) keeps the rank codes resident on each local
device, or, when they exceed 60% of the device budget, streams them
through a slab cache's pool (parallel/slabs.py).  Each shard (local
device and process, parallel/multihost.py) folds its tiles' two-stage LR
top-k into a running top-k on its device 32 tiles at a time, and the
host merges the shards'.  Tiles wider than 1024 columns, in whole
128-column chunks, take the chunked stage 1 inside a kernel (tile, LR
mask and 128-column chunk max in one pass): the (2, 2, pure) ones K2
(ops/fused_tile.py), every other one K1's stage-1 form
(ops/rank_mi.rank_mi_stage1).  Narrower tiles go through K1's stored
tile, the mask in torch ops and `tile_lr_topk`.  Top-k keeps the lowest
index among equal values, as `lax.top_k` does (stable sorts), and the
merge breaks ties in the JAX sweep's visiting order, as its carries do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldweaver_tpu_torch.ops.fused_tile import fused_tile_stage1
from ldweaver_tpu_torch.ops.rank_mi import (
    CHUNK,
    N_TERMS,
    chunk_max,
    pair_codes,
    rank_mi_stage1,
    rank_mi_tile,
)
from ldweaver_tpu_torch.support import resolve_device
from ldweaver_tpu_torch.utils.profiling import span


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
    # np.take gathers whole columns ~20x faster than fancy indexing on a
    # [nseq, nsnp] u8 array (the same bytes)
    rank_codes = np.take(rank_codes, perm, axis=1)
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
    terms left of the f32 weight, so the first t terms are the t-term
    split, and three sum to the weight within ~2^-24 relative.  Both are
    CPU tensors."""
    w32 = torch.from_numpy(np.asarray(w, np.float32).copy())
    parts = []
    resid = w32.clone()
    for _ in range(terms):
        p = resid.to(torch.bfloat16)
        parts.append(p)
        resid = resid - p.to(torch.float32)
    return w32, torch.stack(parts)


def split_terms(w, terms: int) -> torch.Tensor:
    """The bf16 weight terms [t, S] (a CPU tensor) that a kernel sums for
    the JAX package's `terms`-term split of the weights w
    (`precision_terms`, `n_terms`): the split itself for 1 to 3 terms.
    Three bf16 terms hold an f32 weight, so the terms past the third are
    zero: that is checked, and the first three are returned.  A count
    below one raises ValueError."""
    if terms < 1:
        raise ValueError(f"the weight-term count must be at least 1, got {terms}")
    _, parts = wparts(w, terms)
    if bool((parts[N_TERMS:] != 0).any()):
        raise ValueError("weight terms past the third are not zero")
    return parts[:N_TERMS].contiguous()


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


def mi_tile_rank(rank_codes_f: np.ndarray, rank_codes_t: np.ndarray,
                 w: np.ndarray, r_f: np.ndarray, r_t: np.ndarray, neff: float,
                 precision_terms: int = 3, device="cuda") -> np.ndarray:
    """Host-facing rank-compacted tile, the JAX package's `mi_tile_rank`
    (fast_sweep.py:375-410): site-major rank codes [F, S] / [T, S], the
    general epilogue of the bucket (max r_f, max r_t), exact f32 marginals
    and the `precision_terms`-term split -> [F, T] float64 through
    `rank_tile_mi` (kernel K1; its plain version on device="cpu")."""
    dev = resolve_device(device)
    parts = split_terms(w, precision_terms).to(dev)
    codes, ts = pair_codes(rank_codes_f, rank_codes_t, dev)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    out = rank_tile_mi(
        codes, 0, ts, rank_codes_f.shape[0], rank_codes_t.shape[0], f32(w),
        parts, f32(r_f), f32(r_t), float(np.float32(neff)),
        int(np.asarray(r_f).max()), int(np.asarray(r_t).max()),
    )
    return out.cpu().numpy().astype(np.float64)


# --------------------------------------------------------------------------
# The LR-only sweep
# --------------------------------------------------------------------------
def top_k(values: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a 1-D tensor in
    descending order, the lowest index first among equal values (the tie
    rule of `lax.top_k`; torch.topk promises no order)."""
    srt, order = torch.sort(-values, stable=True)
    return -srt[:k], order[:k]


def chunk_topk(c_vals, cols, block_t: int, topk: int):
    """Stage 2 of the chunked top-k: the flat top-k over the [Bf, nch]
    chunk maxima -> (vals, flat in-tile indices i * block_t + j).  Pad-only
    chunks are all -inf; their column is clamped so the flat index stays in
    range (fast_sweep.py:298-300)."""
    block_f, nch = c_vals.shape
    rows = torch.arange(block_f, device=c_vals.device)[:, None]
    flat = rows * block_t + torch.clamp(cols, max=block_t - 1)
    vals, sel = top_k(c_vals.reshape(-1), min(topk, block_f * nch))
    return vals, flat.reshape(-1)[sel].to(torch.int32)


def tile_masks(pos_f, pos_t, val_f, val_t, same_block: bool, g: int,
               sr_dist: int):
    """(sr_ok, lr_ok), bool [nf, nt], of one tile: both sites valid, the
    triangle i > j on a diagonal block pair, and the f32 circular length
    0.5g - |d - 0.5g| (branchless d = diff + (diff < 0) * g) at most /
    above sr_dist.  Computed exactly as the JAX package does
    (fast_sweep.py:451-463, spmd_sweep.py:239-248), so the SR/LR split
    agrees with it bit for bit; every sweep of the port masks through
    here."""
    dev = pos_f.device
    f32 = torch.float32
    ok = val_f[:, None] & val_t[None, :]
    if same_block:
        ar_f = torch.arange(pos_f.numel(), device=dev)
        ar_t = torch.arange(pos_t.numel(), device=dev)
        ok = ok & (ar_f[:, None] > ar_t[None, :])
    diff = pos_t[None, :] - pos_f[:, None]
    d = torch.where(diff < 0, diff + g, diff)
    # a fill, not a copy from the host: no wait for the queued work
    half_g = torch.full((), 0.5 * g, dtype=f32, device=dev)
    lens = half_g - torch.abs(d.to(f32) - half_g)
    return ok & (lens <= sr_dist), ok & (lens > sr_dist)


def two_stage_topk(masked, k_row: int, k: int):
    """Exact top-k of a masked [nf, nt] tile when no row holds more than
    k_row of it: each row's k_row largest by a stable sort, then a stable
    sort of the survivors -> (vals, flat idx i * nt + j), at most k of
    them, the lowest flat index first among equal values (`lax.top_k`)."""
    nf, nt = masked.shape
    srt, order = torch.sort(-masked, dim=1, stable=True)
    row_vals = -srt[:, :k_row]
    flat = torch.arange(nf, device=masked.device)[:, None] * nt + order[:, :k_row]
    vals, sel = top_k(row_vals.reshape(-1), min(k, row_vals.numel()))
    return vals, flat.reshape(-1)[sel]


def tile_lr_topk(masked, block_f: int, block_t: int, topk: int):
    """Two-stage top-k of a masked [Bf, Bt] tile -> (vals, flat idx), the
    counterpart of `_tile_lr_topk` (fast_sweep.py:259-302): per-row top-k
    first for tiles up to 1024 columns, else the max and first argmax of
    every 128-wide chunk (-inf padding for a non-multiple of 128), then
    the flat top-k over the survivors."""
    if block_t <= 1024:
        vals, idx = two_stage_topk(masked, min(64, block_t, topk), topk)
        return vals, idx.to(torch.int32)
    pad = (-block_t) % CHUNK
    if pad:
        masked = torch.nn.functional.pad(masked, (0, pad), value=float("-inf"))
    c_vals, cols = chunk_max(masked)
    return chunk_topk(c_vals, cols, block_t, topk)


@dataclasses.dataclass
class SweepLane:
    """One local device of the LR-only sweep: the stratified rank codes
    and per-site arrays there (spmd_sweep.DeviceInputs; when streaming,
    its codes are the pool of `slab_cache`) and the allele-rank marginals
    of every block."""

    dev: object  # spmd_sweep.DeviceInputs
    marg: torch.Tensor  # [nb, 5, block] f32 weighted rank counts
    slab_cache: object = None  # slabs.SlabCache when streaming


@dataclasses.dataclass
class FastSweepState:
    """One-time preparation of the LR-only sweep: one `SweepLane` a local
    device (global shards first_shard, first_shard + 1, ... of n_shards,
    `multihost.shard_layout`) and the block pairs bucketed by (Rf, Rt,
    both-blocks-pure).  Prepare once, sweep many."""

    ranked: RankedSnps
    buckets: Dict[Tuple[int, int, bool], List[Tuple[int, int]]]
    lanes: List[SweepLane]
    block: int
    g: int
    streaming: bool = False
    panel: int = 0
    first_shard: int = 0
    n_shards: int = 1

    @property
    def dev(self):
        return self.lanes[0].dev

    @property
    def marg(self) -> torch.Tensor:
        return self.lanes[0].marg

    @property
    def slab_cache(self):
        return self.lanes[0].slab_cache


def _prepare_lane(ranked: RankedSnps, valid: np.ndarray, hdw: np.ndarray,
                  neff: float, device, max_slabs: Optional[int],
                  streaming: bool) -> SweepLane:
    from ldweaver_tpu_torch.parallel.slabs import SlabCache
    from ldweaver_tpu_torch.parallel.spmd_sweep import device_inputs

    block = ranked.block
    nseq = ranked.rank_codes.shape[0]
    nb = ranked.rank_codes.shape[1] // block
    if not streaming:
        with span("ldw.prepare.upload"):
            dev = device_inputs(ranked, valid, hdw, neff, device)
        with span("ldw.prepare.marginals"):
            return SweepLane(dev=dev, marg=torch.stack([
                rank_marginals(dev.codes, i * block, block, dev.w32, 5)
                for i in range(nb)
            ]))
    with span("ldw.prepare.upload"):
        cache = SlabCache(ranked.rank_codes, block, max_slabs, device)
        dev = device_inputs(ranked, valid, hdw, neff, device, codes=cache.pool)
    # each block's marginals from a [nseq, block] copy of its slab: the
    # same values as from the resident tensor
    with span("ldw.prepare.marginals"):
        tmp = torch.empty((nseq, block), dtype=torch.uint8, device=device)
        margs = []
        for i in range(nb):
            cache.write_slab(i, tmp)
            margs.append(rank_marginals(tmp, 0, block, dev.w32, 5))
        return SweepLane(dev=dev, marg=torch.stack(margs), slab_cache=cache)


def prepare_fast_sweep(
    snp_data,
    hdw: np.ndarray,
    block: int = 4096,
    n_devices: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    device="cuda",
) -> FastSweepState:
    """Rank-encode + stratify + move the SNP tensor to each local device
    (`multihost.shard_layout(device, n_devices)`).

    If the rank codes exceed 60% of `hbm_budget_bytes` (by default the
    card's memory), the sweep streams them through a slab cache in panel
    order (slabs.plan_budget): the device holds only the pool, and the
    marginals are computed slab by slab here."""
    from ldweaver_tpu_torch.parallel.multihost import shard_layout
    from ldweaver_tpu_torch.parallel.slabs import auto_budget, plan_budget

    with span("ldw.prepare"):
        devices, first_shard, n_shards = shard_layout(device, n_devices)
        if hbm_budget_bytes is None:
            hbm_budget_bytes = auto_budget(devices[0])
        with span("ldw.prepare.stratify"):
            ranked = stratify(
                snp_data.codes, snp_data.acgtn_table, snp_data.pos, snp_data.r, block
            )
        nb = ranked.rank_codes.shape[1] // block
        valid = np.arange(ranked.rank_codes.shape[1]) < snp_data.nsnp

        # bucket key = (Rf, Rt, both-blocks-pure), as fast_sweep.py:569-577
        buckets: Dict[Tuple[int, int, bool], List[Tuple[int, int]]] = {}
        for i in range(nb):
            for j in range(i, nb):
                key = (
                    int(ranked.block_rmax[i]),
                    int(ranked.block_rmax[j]),
                    bool(ranked.block_pure[i]) and bool(ranked.block_pure[j]),
                )
                buckets.setdefault(key, []).append((i, j))

        neff = np.asarray(hdw, np.float64).sum()
        streaming, max_slabs, panel = plan_budget(snp_data.nseq, block, nb,
                                                  hbm_budget_bytes)
        lanes = [_prepare_lane(ranked, valid, hdw, neff, d, max_slabs, streaming)
                 for d in devices]
        return FastSweepState(
            ranked=ranked, buckets=buckets, lanes=lanes, block=block,
            g=snp_data.g, streaming=streaming, panel=panel,
            first_shard=first_shard, n_shards=n_shards,
        )


def kernel_stage1(block: int) -> bool:
    """True where a tile's LR top-k takes the chunked stage 1 inside a
    kernel: more than 1024 columns (`tile_lr_topk`'s chunked branch, the
    JAX scan's) in whole 128-column chunks."""
    return block > 1024 and block % CHUNK == 0


def uses_fused_tile(key: Tuple[int, int, bool], block: int) -> bool:
    """True for the tiles K2 computes: (2, 2, pure) tiles that take the
    chunked stage 1 inside a kernel (`kernel_stage1`); K1's stage-1 form
    takes the other buckets' such tiles."""
    return key == (2, 2, True) and kernel_stage1(block)


def _tile_candidates(state: FastSweepState, bi: int, bj: int,
                     key: Tuple[int, int, bool], sr_dist: int, topk: int,
                     cols: Optional[Tuple[int, int]] = None, lane: int = 0,
                     terms: int = N_TERMS):
    """One tile's LR top-k (vals, flat in-tile idx) on one lane, the scan
    body of `_build_bucket_sweep` (fast_sweep.py:432-464), over the first
    `terms` weight terms.  `cols` are the code columns of the two blocks
    in a slab pool (by default their own)."""
    dev, marg = state.lanes[lane].dev, state.lanes[lane].marg
    parts = dev.wparts[:terms]
    B, g = state.block, int(state.g)
    Rf, Rt, pure = key
    fs, ts = bi * B, bj * B
    cf, ct = cols if cols is not None else (fs, ts)
    pos_f, pos_t = dev.pos[fs : fs + B], dev.pos[ts : ts + B]
    val_f, val_t = dev.valid[fs : fs + B], dev.valid[ts : ts + B]
    if uses_fused_tile(key, B):
        c_vals, c_cols = fused_tile_stage1(
            dev.codes, cf, ct, B, B, parts, marg[bi, :2],
            marg[bj, :2], pos_f, pos_t, val_f, val_t, dev.neff,
            bi == bj, g=g, sr_dist=sr_dist,
        )
        return chunk_topk(c_vals, c_cols, B, topk)
    tile = (dev.codes, cf, ct, B, B, parts, marg[bi, :Rf], marg[bj, :Rt],
            dev.r[fs : fs + B], dev.r[ts : ts + B], dev.neff, Rf, Rt, pure)
    if kernel_stage1(B):
        c_vals, c_cols = rank_mi_stage1(*tile, pos_f, pos_t, val_f, val_t,
                                        bi == bj, g=g, sr_dist=sr_dist)
        return chunk_topk(c_vals, c_cols, B, topk)
    mi = rank_mi_tile(*tile)
    _, lr_ok = tile_masks(pos_f, pos_t, val_f, val_t, bi == bj, g, sr_dist)
    return tile_lr_topk(torch.where(lr_ok, mi, float("-inf")), B, B, topk)


# tiles whose top-k a lane of `fast_lr_topk` folds into its running top-k
# at a time
MERGE_CHUNK = 32
# the span of one tile's launches, by `uses_fused_tile`
TILE_SPANS = ("ldw.lr.tile.k1", "ldw.lr.tile.k2")


def fast_lr_topk(
    snp_data=None,
    hdw: np.ndarray = None,
    block: int = 4096,
    sr_dist: int = 20000,
    topk: int = 4096,
    n_devices: Optional[int] = None,
    precision_terms: int = 3,
    state: Optional[FastSweepState] = None,
    hbm_budget_bytes: Optional[int] = None,
    device="cuda",
):
    """Full LR-only sweep -> global long-range top-k (pos1, pos2, MI),
    MI descending.  The kernels count over the first `precision_terms`
    bf16 terms of the weights (1: the bf16-only sweep, a third of the
    contraction; 3, the default, holds the f32 weights; the state keeps
    three, whose first t are the t-term split).  Pass
    `state` from prepare_fast_sweep to skip the one-time host prep and
    transfer (e.g. when sweeping repeatedly or timing the sweep).

    Each shard (a local lane of the state, times the processes of
    `torch.distributed`) sweeps a contiguous range of the canonical tile
    list (`multihost.shard_ranges`), the lanes taking tiles in turn; a
    streaming lane computes each tile on its slab pool, the panel's rows
    pinned.  Every tile's top-k ((2, 2, pure) tiles through K2, the rest
    through K1) is folded into the lane's running top-k on its device
    every MERGE_CHUNK tiles; the processes gather their lanes' top-k
    and the host merges them by (MI descending, tie key ascending).  The
    tie key is the tile's place in the JAX sweep's visiting order (its
    bucket order when resident, fast_sweep.py:660-662; the panel order
    when streaming) and the candidate's place in its tile's top-k: the
    order in which the JAX sweep's carries break ties, so the top-k does
    not depend on the shards.

    The call is the span "ldw.lr_topk" (utils/profiling.py); inside it
    the spans "ldw.lr.plan", "ldw.lr.tile.k1" or "ldw.lr.tile.k2" for
    each tile's launches, "ldw.lr.flush" for each fold, "ldw.lr.pull" and
    "ldw.lr.merge"."""
    from ldweaver_tpu_torch.parallel import multihost
    from ldweaver_tpu_torch.parallel.slabs import panel_pair_order

    with span("ldw.lr_topk"):
        terms = precision_terms
        if not 1 <= terms <= N_TERMS:  # raises below one; past three: three
            terms = len(split_terms(hdw if state is None else state.dev.w32.cpu(),
                                    terms))
        if state is None:
            state = prepare_fast_sweep(
                snp_data, hdw, block, n_devices, hbm_budget_bytes, device
            )
        sr_dist = int(sr_dist)
        ranked, B, panel = state.ranked, state.block, state.panel
        nb = ranked.rank_codes.shape[1] // B
        L = len(state.lanes)
        k_each = min(topk, B * B)
        with span("ldw.lr.plan"):
            if state.streaming:
                order = list(panel_pair_order(nb, panel))
            else:
                order = [t for _, plist in sorted(state.buckets.items(),
                                                  key=lambda kv: -len(kv[1]))
                         for t in plist]
            ordinal = {t: i for i, t in enumerate(order)}
            canonical = list(panel_pair_order(nb, nb))
            ranges = multihost.shard_ranges(len(canonical), state.n_shards)
            lane_tiles = [sorted(canonical[slice(*ranges[state.first_shard + l])],
                                 key=ordinal.__getitem__) for l in range(L)]
            best = []
            for lane in state.lanes:
                d = lane.dev.codes.device
                best.append([torch.full((topk,), float("-inf"), device=d),
                             torch.zeros((topk,), dtype=torch.int64, device=d),
                             torch.zeros((topk,), dtype=torch.int32, device=d)])
        pend: List[list] = [[] for _ in range(L)]

        def flush(l: int) -> None:
            if not pend[l]:
                return
            with span("ldw.lr.flush"):
                cat = [torch.cat([best[l][k]] + [p[k] for p in pend[l]])
                       for k in range(3)]
                v, sel = top_k(cat[0], topk)
                best[l] = [v, cat[1][sel], cat[2][sel]]
                pend[l].clear()

        cur_panel = [-1] * L
        for k in range(max(map(len, lane_tiles))):
            for l in range(L):
                if k >= len(lane_tiles[l]):
                    continue
                bi, bj = lane_tiles[l][k]
                cache = state.lanes[l].slab_cache
                cols = None
                if cache is not None:
                    if bi // panel != cur_panel[l]:
                        cur_panel[l] = bi // panel
                        cache.unpin()
                        cache.pin(range(cur_panel[l] * panel,
                                        min((cur_panel[l] + 1) * panel, nb)))
                    cols = (cache.get(bi), cache.get(bj))
                key = (int(ranked.block_rmax[bi]), int(ranked.block_rmax[bj]),
                       bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj]))
                with span(TILE_SPANS[uses_fused_tile(key, B)]):
                    vals, idx = _tile_candidates(state, bi, bj, key, sr_dist,
                                                 k_each, cols, lane=l, terms=terms)
                    tie = (torch.arange(vals.numel(), device=vals.device)
                           + ordinal[bi, bj] * k_each)
                    pend[l].append([vals, tie, idx.to(torch.int32)])
                if len(pend[l]) >= MERGE_CHUNK:
                    flush(l)
        for l in range(L):
            flush(l)
            if state.lanes[l].slab_cache is not None:
                state.lanes[l].slab_cache.unpin()
        # waits for each lane's queue to drain
        with span("ldw.lr.pull"):
            local = [tuple(t.cpu().numpy() for t in b) for b in best]
        with span("ldw.lr.merge"):
            parts = [p for r in multihost.allgather_object(local) for p in r]
            v, tie, x = (np.concatenate([p[k] for p in parts]) for k in range(3))
            o = np.lexsort((tie, -v.astype(np.float64)))[:topk]
            v, tie, x = v[o], tie[o], x[o].astype(np.int64)
            keep = np.isfinite(v)
            v, tie, x = v[keep], tie[keep], x[keep]
            tiles = np.asarray(order, np.int64).reshape(-1, 2)[tie // k_each]
            pos2 = ranked.pos[tiles[:, 0] * B + x // B]
            pos1 = ranked.pos[tiles[:, 1] * B + x % B]
        return pos1, pos2, v
