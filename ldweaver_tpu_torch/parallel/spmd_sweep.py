"""BLK5 link extraction on one GPU: the port of the JAX package's SPMD
sweep (parallel/spmd_sweep.py there).

Per tile of the r-stratified block-pair grid, `extract_tile` computes the
MI tile with kernel K1 and extracts on the device
  * **SR links**: every short-range pair, compacted row-major
    (`torch.nonzero` of the row-major SR mask gives the ascending flat
    indices that the reference's cumsum + scatter produces).  The count is
    checked against the exact host count from the positions;
  * **LR links**: an exact two-stage top-K (per-row stable sort, then a
    stable sort of the survivors, lowest flat index first on ties, as
    `lax.top_k`) plus an exactness certificate.  The host interpolates the
    type-7 retention threshold in f64 from the two order statistics around
    the quantile (`lr_threshold_from_topk`) and keeps candidates >= q.

`blk5_sweep` uploads the rank codes once, visits the tiles in
`panel_pair_order(nb, nb)` (the reference's emission order), and recovers
tiles whose certificate fails with a boosted-capacity retry and, past
that, an exact full-tile extraction.  With the on-device SR reduction
(`sr_reduce` "auto" when the table fits, or "device") every tile's SR
pairs stay on the card and `parallel/sr_reduce.run_device_reduction`
reduces them after the loop; otherwise they are copied to the host and
emitted there.  The host helpers (SR counts, top-K sizing, emission) are
copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ldweaver_tpu_torch.parallel.fast_sweep import (
    RankedSnps,
    rank_tile_mi,
    stratify,
    tile_masks,
    two_stage_topk,
    wparts,
)
from ldweaver_tpu_torch.parallel.sr_reduce import (
    DeviceSrReduction,
    run_device_reduction,
    select_mode,
)


# --------------------------------------------------------------------------
# Host-side exact SR pair counts (positions are static)
# --------------------------------------------------------------------------
def _circular_window_counts(p: np.ndarray, q: np.ndarray, g: int,
                            sr_dist: int) -> np.ndarray:
    """#targets q within circular distance <= sr_dist of each p."""
    qs = np.sort(q)
    D = np.concatenate([qs, qs + g])
    a = ((p - sr_dist - 1) % g) + 1
    lo = np.searchsorted(D, a, side="left")
    hi = np.searchsorted(D, a + 2 * sr_dist, side="right")
    return hi - lo


def tile_sr_count(pos_f: np.ndarray, pos_t: np.ndarray, g: int,
                  sr_dist: int, same_block: bool) -> int:
    """Exact SR pair count of one tile under the fast-path emission rule
    (same-block: strict i > j; off-diagonal: all cross pairs)."""
    if pos_f.size == 0 or pos_t.size == 0:
        return 0
    if same_block:
        c = _circular_window_counts(pos_f, pos_f, g, sr_dist)
        return (int(c.sum()) - pos_f.size) // 2
    return int(_circular_window_counts(pos_f, pos_t, g, sr_dist).sum())


def sr_pair_counts(ranked, valid: np.ndarray, g: int,
                   sr_dist: int) -> np.ndarray:
    """[nb, nb] exact SR pair counts for every upper-triangular tile."""
    B = ranked.block
    nb = ranked.rank_codes.shape[1] // B
    pos_blocks = [
        ranked.pos[i * B : (i + 1) * B][valid[i * B : (i + 1) * B]]
        for i in range(nb)
    ]
    counts = np.zeros((nb, nb), np.int64)
    for i in range(nb):
        for j in range(i, nb):
            counts[i, j] = tile_sr_count(
                pos_blocks[i], pos_blocks[j], g, sr_dist, i == j
            )
    return counts


def _next_pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def extract_dims(block: int, lr_prob: Optional[float],
                 k_max: int = 1 << 18) -> Tuple[int, int]:
    """(K, k_row) for the extraction top-K, sized from the retention
    probability: a tile keeps ~m = (1-prob)*B^2 candidates, so K must
    comfortably exceed m and the stage-1 row capacity must cover the
    per-row Poisson load lambda = m/B plus a 6-sigma tail.  Clamped at
    k_max; denser retention saturates into the exact full-tile fallback
    by design."""
    if lr_prob is None:
        return 1, 1
    m = (1.0 - lr_prob) * block * block
    lam = m / block
    k_row = int(min(block, max(16, math.ceil(lam + 6.0 * math.sqrt(lam + 1.0) + 8.0))))
    K = int(max(4096, 2.0 * m + 1024.0))
    K = min(K, block * k_row, block * block, k_max)
    return K, k_row


def fast_block_size(nsnp: int, max_blk_sz: int) -> int:
    """The sweep's tile size: max_blk_sz capped at the next power of two
    of nsnp (BLK4 and BLK5 share this rule)."""
    return min(max_blk_sz, 1 << int(math.ceil(math.log2(max(nsnp, 2)))))


# --------------------------------------------------------------------------
# Host-side emission from extraction results
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TileExtract:
    n_lr: int
    exact: bool
    vals: np.ndarray  # [K] f32 desc
    idx: np.ndarray  # [K] i32 flat
    n_sr: int
    # [n_sr] i32 row-major and f32; device tensors when the sweep keeps
    # the SR pairs on the card (extract_tile's keep_sr)
    sr_idx: Union[np.ndarray, torch.Tensor]
    sr_vals: Union[np.ndarray, torch.Tensor]
    row_max: int = 0  # max LR candidates in any row (retry sizing)


def lr_threshold_from_topk(n_lr: int, vals: np.ndarray, lr_prob: float,
                           K: int) -> Optional[float]:
    """The f64 type-7 retention threshold from the two order statistics
    around the quantile, or None when they fall outside the top-K
    (saturated tile -> caller falls back).  Bit-identical to
    quantile_type7 over the full per-tile LR value set."""
    n = int(n_lr)
    h = (n - 1) * lr_prob
    lo = int(math.floor(h))
    i_lo = n - 1 - lo  # rank from top of x_asc[lo]
    ncand = min(n, K, vals.shape[0])
    if i_lo > ncand - 1:
        return None
    vals64 = vals.astype(np.float64)
    x_lo = vals64[i_lo]
    hi_asc = min(lo + 1, n - 1)
    x_hi = vals64[n - 1 - hi_asc]
    return float(x_lo + (h - lo) * (x_hi - x_lo))


def retry_dims(res: TileExtract, block: int, lr_prob: float,
               K: int, k_row: int) -> Tuple[int, int]:
    """(K', k_row') for the boosted-capacity retry of a failed tile.

    k_row' >= the tile's measured max per-row candidate count, so the
    stage-1 certificate holds BY CONSTRUCTION; K' covers the exact
    retention rank i_lo (known from n_lr) with the same 2x + 1024 tie
    margin the primary sizing uses."""
    n = int(res.n_lr)
    h = (n - 1) * lr_prob
    i_lo = n - 1 - int(math.floor(h))
    K2 = min(block * block, _next_pow2(2 * (i_lo + 1) + 1024))
    k2 = min(block, _next_pow2(max(int(res.row_max), 2 * k_row)))
    return max(K2, K), max(k2, k_row)


def emit_tile_extract(
    res: TileExtract,
    *,
    B: int,
    pos_f: np.ndarray,
    pos_t: np.ndarray,
    pnt_f: np.ndarray,
    pnt_t: np.ndarray,
    g: int,
    sr_dist: int,
    lr_prob: Optional[float],
    K: int,
    expected_sr: int,
    sr_links: List[list],
    lr_rows_sink: Callable,
    parts: str = "both",
) -> bool:
    """Emit one tile's links from its extraction result; returns False if
    the tile needs the LR retry/fallback (failed certificate or retention
    kept more than the top-K).

    SR is single-sourced from the primary extraction: its compaction is
    exact regardless of the LR certificate, so when the LR side fails the
    caller emits `parts="sr"` from the ORIGINAL result and reruns only
    `parts="lr"` on the retry/fallback."""
    from ldweaver_tpu_torch.core.sweep import _emit_pairs

    if res.n_sr != expected_sr:
        raise RuntimeError(
            f"device SR count {res.n_sr} != host count {expected_sr}"
        )
    q = None
    kept_sel = None
    if parts != "sr" and lr_prob is not None and res.n_lr > 0:
        if not res.exact:
            return False
        q = lr_threshold_from_topk(res.n_lr, res.vals, lr_prob, K)
        if q is None:
            return False
        cand = res.vals[: min(res.n_lr, K, res.vals.shape[0])].astype(
            np.float64
        )
        if res.n_lr > cand.size and cand.size and cand[-1] >= q:
            # candidates beyond the top-K could also pass the threshold
            # (tie block crossing the K boundary): the retention would
            # silently drop links the full-tile path keeps — fall back
            return False
        kept_sel = np.flatnonzero(cand >= q)

    if kept_sel is not None and kept_sel.size:
        kidx = res.idx[kept_sel].astype(np.int64)
        kvals = res.vals[kept_sel].astype(np.float64)
        order = np.argsort(kidx, kind="stable")  # row-major
        kidx = kidx[order]
        kvals = kvals[order]
        _emit_pairs(
            kidx // B, kidx % B, kvals, pos_f, pos_t, pnt_f, pnt_t,
            g, sr_dist, lr_prob, sr_links, lr_rows_sink,
            apply_lr_quantile=False, lr_thresh=q,
        )
    if parts != "lr" and res.n_sr:
        sidx = res.sr_idx[: res.n_sr].astype(np.int64)
        svals = res.sr_vals[: res.n_sr].astype(np.float64)
        _emit_pairs(
            sidx // B, sidx % B, svals, pos_f, pos_t, pnt_f, pnt_t,
            g, sr_dist, None, sr_links, lr_rows_sink,
        )
    return True


# --------------------------------------------------------------------------
# The state the sweep keeps on the device
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceInputs:
    codes: torch.Tensor  # [nseq, nsnp_pad] u8 rank codes, sequence-major
    r: torch.Tensor  # [nsnp_pad] f32 distinct-allele counts
    pos: torch.Tensor  # [nsnp_pad] i32 genome positions
    valid: torch.Tensor  # [nsnp_pad] bool, False on pad sites
    w32: torch.Tensor  # [nseq] f32 Hamming weights
    wparts: torch.Tensor  # [3, nseq] bf16 split terms of w32
    neff: float  # sum of the weights, rounded to f32
    # [nsnp_pad] i32 CDS cluster of each site (0 on pad sites), for the
    # on-device SR reduction
    paint: Optional[torch.Tensor] = None


def device_inputs(ranked: RankedSnps, valid: np.ndarray, hdw: np.ndarray,
                  neff: float, device,
                  paint_sorted: Optional[np.ndarray] = None) -> DeviceInputs:
    """Upload what the sweep reads on the device: the stratified rank
    codes (either package's `stratify` output), r, positions, validity,
    the weights and their bf16 split, neff and, when given, the sites'
    clusters in stratified order."""
    w32, parts = wparts(np.asarray(hdw, np.float64))
    return DeviceInputs(
        codes=torch.from_numpy(np.ascontiguousarray(ranked.rank_codes)).to(device),
        r=torch.from_numpy(np.asarray(ranked.r, np.float32)).to(device),
        pos=torch.from_numpy(np.asarray(ranked.pos, np.int32)).to(device),
        valid=torch.from_numpy(np.asarray(valid, bool)).to(device),
        w32=w32.to(device),
        wparts=parts.to(device).contiguous(),
        neff=float(np.float32(neff)),
        paint=(None if paint_sorted is None else
               torch.from_numpy(np.asarray(paint_sorted, np.int32)).to(device)),
    )


# --------------------------------------------------------------------------
# One tile -> link extraction (port of `_extract_body`)
# --------------------------------------------------------------------------
def tile_mi(dev: DeviceInputs, bi: int, bj: int, block: int, Rf: int,
            Rt: int, pure: bool) -> torch.Tensor:
    """The [block, block] MI tile of block pair (bi, bj)."""
    fs, ts = bi * block, bj * block
    return rank_tile_mi(
        dev.codes, fs, ts, block, block, dev.w32, dev.wparts,
        dev.r[fs : fs + block], dev.r[ts : ts + block], dev.neff,
        Rf, Rt, pure,
    )


def extract_tile(
    dev: DeviceInputs, bi: int, bj: int, *, block: int, sr_dist: int,
    g: int, K: int, k_row: int, prob: float, Rf: int, Rt: int, pure: bool,
    keep_sr: bool = False,
) -> TileExtract:
    """One tile -> SR pairs, LR top-K and certificate (the JAX package's
    `_extract_body`, spmd_sweep.py:224-326).  With keep_sr the SR pairs
    stay device tensors (i32 flat indices, f32 MI) for the on-device SR
    reduction; otherwise they are copied to the host."""
    B = block
    fs, ts = bi * B, bj * B
    mi = tile_mi(dev, bi, bj, B, Rf, Rt, pure)
    f32 = torch.float32
    sr_ok, lr_ok = tile_masks(
        dev.pos[fs : fs + B], dev.pos[ts : ts + B], dev.valid[fs : fs + B],
        dev.valid[ts : ts + B], bi == bj, g, sr_dist,
    )

    # ---- SR: exact row-major compaction
    sr_idx = torch.nonzero(sr_ok.reshape(-1)).reshape(-1)
    sr_vals = mi.reshape(-1)[sr_idx]
    sr_idx = sr_idx.to(torch.int32)

    # ---- LR: exact two-stage top-K + exactness certificate
    neg = torch.where(lr_ok, mi, float("-inf"))
    lr_row = lr_ok.sum(dim=1)
    n_lr = lr_row.sum()
    vals, idx = two_stage_topk(neg, k_row, K)
    n_out = vals.numel()
    # certificate at the needed depth (spmd_sweep.py:306-321)
    prob_t = torch.tensor(prob, dtype=f32, device=mi.device)
    i_cert = n_lr - torch.floor((n_lr.to(f32) - 1.0) * prob_t).to(n_lr.dtype) + 8
    i_cert = torch.clamp(i_cert, 0, n_out - 1)
    i_cert = torch.minimum(i_cert, torch.clamp(n_lr - 1, min=0))
    vstar = vals[i_cert]
    above = (neg >= vstar) & lr_ok
    tot_max = lr_row.max()
    abv_max = above.sum(dim=1).max()
    exact = (tot_max <= k_row) | (torch.isfinite(vstar) & (abv_max <= k_row))

    head = torch.stack([n_lr, tot_max, exact.to(n_lr.dtype)]).cpu().tolist()
    return TileExtract(
        n_lr=int(head[0]),
        exact=bool(head[2]),
        vals=vals.cpu().numpy(),
        idx=idx.to(torch.int32).cpu().numpy(),
        n_sr=int(sr_idx.numel()),
        sr_idx=sr_idx if keep_sr else sr_idx.cpu().numpy(),
        sr_vals=sr_vals if keep_sr else sr_vals.cpu().numpy(),
        row_max=int(head[1]),
    )


def fallback_full_tile(
    dev: DeviceInputs, ranked: RankedSnps, valid: np.ndarray,
    paint_sorted: np.ndarray, bi: int, bj: int, g: int, sr_dist: int,
    lr_prob: Optional[float], sr_links: List[list], lr_rows_sink: Callable,
    emit_sr: bool = True,
) -> None:
    """Exact full-tile extraction for tiles the bounded extraction cannot
    certify (the JAX package's `_fallback_full_tile`).  With
    emit_sr=False only the LR side is emitted (the tile's SR links were
    already single-sourced from the primary extraction)."""
    from ldweaver_tpu_torch.core.sweep import _emit_pairs

    if not emit_sr:
        sr_links = [[] for _ in sr_links]  # discard SR appends
    B = ranked.block
    f_sl = slice(bi * B, (bi + 1) * B)
    t_sl = slice(bj * B, (bj + 1) * B)
    pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
    mi = tile_mi(
        dev, bi, bj, B, int(ranked.block_rmax[bi]), int(ranked.block_rmax[bj]),
        pure,
    ).cpu().numpy().astype(np.float64)
    val_f = valid[f_sl]
    val_t = valid[t_sl]
    if bi == bj:
        fii, fjj = np.tril_indices(B, -1)
        fii = fii.astype(np.int32)
        fjj = fjj.astype(np.int32)
    else:
        fii = np.repeat(np.arange(B, dtype=np.int32), B)
        fjj = np.tile(np.arange(B, dtype=np.int32), B)
    okm = val_f[fii] & val_t[fjj]
    fii, fjj = fii[okm], fjj[okm]
    if fii.size:
        _emit_pairs(
            fii, fjj, mi[fii, fjj],
            ranked.pos[f_sl], ranked.pos[t_sl],
            paint_sorted[f_sl], paint_sorted[t_sl],
            g, sr_dist, lr_prob, sr_links, lr_rows_sink,
        )


# --------------------------------------------------------------------------
# The single-GPU BLK5 driver
# --------------------------------------------------------------------------
def blk5_sweep(
    snp_data,
    hdw: np.ndarray,
    paint: np.ndarray,
    neff: float,
    sr_dist: int,
    lr_retain_links: float,
    lr_links_approx: Optional[float],
    sr_links: List[list],
    lr_rows_sink: Callable,
    block: int,
    device,
    perform_sr_only: bool = False,
    topk_cap: int = 1 << 18,
    verbose: bool = True,
    sr_reduce: str = "auto",
) -> Tuple[Dict[str, float], Optional[DeviceSrReduction]]:
    """Run BLK5's sweep tile by tile on `device` and emit links in the
    reference's order (panel order over tiles, row-major inside a tile,
    f64 thresholds).  Returns (stats, DeviceSrReduction or None).

    `sr_reduce` selects where the SR background model's heavy pass runs
    (`sr_reduce.select_mode`): on the host, every SR pair is emitted into
    `sr_links`; on the device, no SR pair is emitted, and the caller
    finishes with `merge_and_sort_sr_links_from_candidates` on the
    returned reduction (TSVs byte-identical to the host mode)."""
    from ldweaver_tpu_torch.parallel.slabs import panel_pair_order

    ranked = stratify(
        snp_data.codes, snp_data.acgtn_table, snp_data.pos, snp_data.r, block
    )
    B = ranked.block
    nb = ranked.rank_codes.shape[1] // B
    valid = np.arange(ranked.pos.size) < snp_data.nsnp
    paint_sorted = np.concatenate(
        [paint[ranked.perm], np.zeros(ranked.pos.size - snp_data.nsnp, np.int64)]
    )
    g = snp_data.g
    lr_prob = (
        None
        if (perform_sr_only or lr_links_approx is None)
        else max(0.0, 1.0 - lr_retain_links / lr_links_approx)
    )
    K, k_row = extract_dims(B, lr_prob, k_max=topk_cap)
    prob = 1.0 if lr_prob is None else lr_prob
    sr_counts = sr_pair_counts(ranked, valid, g, sr_dist)
    total_sr = int(sr_counts.sum())
    device_reduce = select_mode(sr_reduce, total_sr, g, device,
                                verbose) == "device"
    dev = device_inputs(ranked, valid, hdw, neff, device,
                        paint_sorted if device_reduce else None)
    segs = []  # device mode: (bi, bj, sr_idx, sr_vals) of every tile

    stats = dict(tiles=0, retries=0, fallbacks=0, sr_pairs=0, K=K,
                 k_row=k_row, block=B,
                 sr_reduce="device" if device_reduce else "host")
    primary_parts = "lr" if device_reduce else "both"
    # wall split of the primary tiles: extraction (device work up to the
    # copies of its results to the host) and host emission
    extract_s = emit_s = 0.0
    for bi, bj in panel_pair_order(nb, nb):
        Rf = int(ranked.block_rmax[bi])
        Rt = int(ranked.block_rmax[bj])
        pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
        t0 = time.perf_counter()
        res = extract_tile(
            dev, bi, bj, block=B, sr_dist=int(sr_dist), g=int(g), K=K,
            k_row=k_row, prob=prob, Rf=Rf, Rt=Rt, pure=pure,
            keep_sr=device_reduce,
        )
        if device_reduce and res.n_sr:
            segs.append((bi, bj, res.sr_idx, res.sr_vals))
        t1 = time.perf_counter()
        extract_s += t1 - t0
        f_sl = slice(bi * B, (bi + 1) * B)
        t_sl = slice(bj * B, (bj + 1) * B)
        emit_kw = dict(
            B=B, pos_f=ranked.pos[f_sl], pos_t=ranked.pos[t_sl],
            pnt_f=paint_sorted[f_sl], pnt_t=paint_sorted[t_sl],
            g=g, sr_dist=sr_dist, lr_prob=lr_prob,
            expected_sr=int(sr_counts[bi, bj]),
            sr_links=sr_links, lr_rows_sink=lr_rows_sink,
        )
        stats["tiles"] += 1
        stats["sr_pairs"] += res.n_sr
        done = emit_tile_extract(res, K=K, parts=primary_parts, **emit_kw)
        emit_s += time.perf_counter() - t1
        if done:
            continue
        # the LR certificate failed, but SR compaction is exact regardless:
        # emit SR once from the primary extraction and redo only the LR side
        if not device_reduce:
            emit_tile_extract(res, K=K, parts="sr", **emit_kw)
        done = False
        if lr_prob is not None:
            # boosted-capacity retry before the full-tile transfer — only
            # when it moves fewer bytes than the B^2 f32 tile
            K2, k2 = retry_dims(res, B, lr_prob, K, k_row)
            if K2 * 8 < B * B * 4:
                res2 = extract_tile(  # its SR side is unused: no copy
                    dev, bi, bj, block=B, sr_dist=int(sr_dist), g=int(g),
                    K=K2, k_row=k2, prob=prob, Rf=Rf, Rt=Rt, pure=pure,
                    keep_sr=True,
                )
                stats["retries"] += 1
                done = emit_tile_extract(res2, K=K2, parts="lr", **emit_kw)
        if not done:
            stats["fallbacks"] += 1
            fallback_full_tile(
                dev, ranked, valid, paint_sorted, bi, bj, g, sr_dist,
                lr_prob, sr_links, lr_rows_sink, emit_sr=False,
            )
    stats.update(extract_s=round(extract_s, 3), emit_s=round(emit_s, 3))
    reduction = None
    if device_reduce:
        reduction = run_device_reduction(
            segs, dev.pos, dev.paint, ranked_pos=ranked.pos,
            paint_sorted=paint_sorted, B=B, nb=nb, g=int(g),
            sr_dist=int(sr_dist), nclust=len(sr_links), total_sr=total_sr,
        )
        stats.update(reduction.stats)
    if verbose:
        print(
            f"BLK5 sweep: {stats['tiles']} tiles on {device},"
            f" {stats['sr_pairs']} sr pairs, {stats['retries']} retries,"
            f" {stats['fallbacks']} fallbacks, SR reduction on the"
            f" {stats['sr_reduce']}",
            flush=True,
        )
    return stats, reduction
