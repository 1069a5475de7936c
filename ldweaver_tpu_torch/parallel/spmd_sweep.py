"""BLK5 link extraction on one or more devices and processes: the port of
the JAX package's SPMD sweep (parallel/spmd_sweep.py there).

Per tile of the r-stratified block-pair grid, `dispatch_extract` queues
the MI tile (kernel K1) and its extraction on the device without waiting
for it, and `finish_extract` waits for the results (`extract_tile` does
both; `core.sweep.FastTileRunner` keeps tiles queued in between):
  * **SR links**: every short-range pair, compacted row-major (a cumsum
    and scatter into the exact host count from the positions, as the
    reference does; the device's own count is checked against it);
  * **LR links**: an exact two-stage top-K (per-row stable sort, then a
    stable sort of the survivors, lowest flat index first on ties, as
    `lax.top_k`) plus an exactness certificate.  The host interpolates the
    type-7 retention threshold in f64 from the two order statistics around
    the quantile (`lr_threshold_from_topk`) and keeps candidates >= q.

`blk5_sweep` is BLK5's one tile loop, for backends "spmd" and "fast":
it drives a `FastTileRunner` over a slab pool (every block resident when
the rank codes fit the device budget, else streamed in row panels),
dispatches `pipeline_depth` tiles ahead, and recovers tiles whose
certificate fails with a boosted-capacity retry and, past that, an exact
full-tile extraction.  With the on-device SR reduction (`sr_reduce`
"auto" when the table fits, or "device") every tile's SR pairs stay on
the card and `parallel/sr_reduce.run_device_reduction` reduces them
after the loop; with several shards "part" leaves them on their shard
(`sr_reduce.run_part_reduction`); otherwise they are copied to the host
and emitted there.  Links are emitted in the canonical
`panel_pair_order(nb, nb)` tile order.  Several local devices and
processes (parallel/multihost.py) each sweep a contiguous range of that
order.  With a checkpoint directory the sweep resumes tile by tile.  The
host helpers (SR counts, top-K sizing, emission) are copies of the JAX
package's.
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


def emit_tile_lr(
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
    lr_rows_sink: Callable,
    **_unused,
) -> bool:
    """Emit one tile's LR links from its extraction result; returns False
    if the tile needs the LR retry/fallback (failed certificate or
    retention kept more than the top-K).

    The tile's SR pairs are not emitted here: their compaction is exact
    regardless of the LR certificate, so they are single-sourced from the
    primary extraction (`emit_sr_pairs`, or the on-device reduction) and
    only the LR side is redone on the retry/fallback."""
    from ldweaver_tpu_torch.core.sweep import _emit_pairs

    if res.n_sr != expected_sr:
        raise RuntimeError(
            f"device SR count {res.n_sr} != host count {expected_sr}"
        )
    q = None
    kept_sel = None
    if lr_prob is not None and res.n_lr > 0:
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
            g, sr_dist, lr_prob, [], lr_rows_sink,
            apply_lr_quantile=False, lr_thresh=q,
        )
    return True


def emit_sr_pairs(sr_idx: np.ndarray, sr_vals: np.ndarray, *, B: int,
                  pos_f: np.ndarray, pos_t: np.ndarray, pnt_f: np.ndarray,
                  pnt_t: np.ndarray, g: int, sr_dist: int, sr_links: List[list],
                  lr_rows_sink: Callable, **_unused) -> None:
    """Emit one tile's SR pairs (row-major flat indices, f32 MI) into
    `sr_links`: from an extraction, or replayed from a checkpoint."""
    from ldweaver_tpu_torch.core.sweep import _emit_pairs

    if len(sr_idx) == 0:
        return
    sidx = np.asarray(sr_idx).astype(np.int64)
    svals = np.asarray(sr_vals).astype(np.float64)
    _emit_pairs(
        sidx // B, sidx % B, svals, pos_f, pos_t, pnt_f, pnt_t,
        g, sr_dist, None, sr_links, lr_rows_sink,
    )


# --------------------------------------------------------------------------
# The state the sweep keeps on the device
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceInputs:
    # [nseq, ncols] u8 rank codes, sequence-major: the whole stratified
    # tensor, or the pool of a slab cache (parallel/slabs.py)
    codes: torch.Tensor
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
                  paint_sorted: Optional[np.ndarray] = None,
                  codes: Optional[torch.Tensor] = None) -> DeviceInputs:
    """Upload what the sweep reads on the device: the stratified rank
    codes (either package's `stratify` output; or `codes`, a slab pool
    that the caller fills), r, positions, validity, the weights and their
    bf16 split, neff and, when given, the sites' clusters in stratified
    order."""
    w32, parts = wparts(np.asarray(hdw, np.float64))
    if codes is None:
        codes = torch.from_numpy(np.ascontiguousarray(ranked.rank_codes)).to(device)
    return DeviceInputs(
        codes=codes,
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
            Rt: int, pure: bool,
            cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The [block, block] MI tile of block pair (bi, bj).  `cols` are the
    code-tensor column offsets of the two blocks (a slab pool's slots);
    by default the blocks' own offsets bi * block, bj * block."""
    fs, ts = bi * block, bj * block
    cf, ct = cols if cols is not None else (fs, ts)
    return rank_tile_mi(
        dev.codes, cf, ct, block, block, dev.w32, dev.wparts,
        dev.r[fs : fs + block], dev.r[ts : ts + block], dev.neff,
        Rf, Rt, pure,
    )


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue the copy of a card tensor into pinned host memory (the caller
    waits on an event recorded after it); a CPU tensor is returned as
    is."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def compact_indices(flags: torch.Tensor, size: Optional[int]) -> torch.Tensor:
    """Ascending indices of the True entries of a 1-D bool tensor, as
    i32.  With the count known on the host (`size`) no host sync is
    needed: a cumsum gives each entry its slot and a scatter places it
    (entries past `size` land in a discarded extra slot; the caller
    checks the device's own count).  Without it, torch.nonzero."""
    if size is None:
        return torch.nonzero(flags).reshape(-1).to(torch.int32)
    slot = torch.cumsum(flags, 0, dtype=torch.int32)
    dest = torch.where(flags & (slot <= size), slot - 1, size).to(torch.int64)
    out = torch.empty(size + 1, dtype=torch.int32, device=flags.device)
    out.scatter_(0, dest, torch.arange(flags.numel(), dtype=torch.int32,
                                       device=flags.device))
    return out[:size]


@dataclasses.dataclass
class PendingExtract:
    """One dispatched extraction: host copies in flight (or device tensors
    for kept SR pairs) and the event after which they are complete."""

    head: torch.Tensor  # [4] i64: n_lr, row_max, exact, n_sr (device count)
    vals: torch.Tensor
    idx: torch.Tensor
    sr_idx: torch.Tensor
    sr_vals: torch.Tensor
    keep_sr: bool
    event: Optional[object] = None  # torch.cuda.Event on the card


def dispatch_extract(
    dev: DeviceInputs, bi: int, bj: int, *, block: int, sr_dist: int,
    g: int, K: int, k_row: int, prob: float, Rf: int, Rt: int, pure: bool,
    keep_sr: bool = False, n_sr: Optional[int] = None,
    cols: Optional[Tuple[int, int]] = None,
) -> PendingExtract:
    """Queue one tile's extraction (the JAX package's `_extract_body`,
    spmd_sweep.py:224-326) and the copies of its results to the host,
    without waiting for the card when `n_sr`, the tile's exact SR pair
    count, is given.  With keep_sr the SR pairs stay device tensors (i32
    flat indices, f32 MI) for the on-device SR reduction."""
    B = block
    fs, ts = bi * B, bj * B
    mi = tile_mi(dev, bi, bj, B, Rf, Rt, pure, cols)
    f32 = torch.float32
    sr_ok, lr_ok = tile_masks(
        dev.pos[fs : fs + B], dev.pos[ts : ts + B], dev.valid[fs : fs + B],
        dev.valid[ts : ts + B], bi == bj, g, sr_dist,
    )

    # ---- SR: exact row-major compaction
    sr_flags = sr_ok.reshape(-1)
    sr_idx = compact_indices(sr_flags, n_sr)
    sr_vals = mi.reshape(-1)[sr_idx]

    # ---- LR: exact two-stage top-K + exactness certificate
    neg = torch.where(lr_ok, mi, float("-inf"))
    lr_row = lr_ok.sum(dim=1)
    n_lr = lr_row.sum()
    vals, idx = two_stage_topk(neg, k_row, K)
    n_out = vals.numel()
    # certificate at the needed depth (spmd_sweep.py:306-321)
    prob_t = torch.full((), prob, dtype=f32, device=mi.device)
    i_cert = n_lr - torch.floor((n_lr.to(f32) - 1.0) * prob_t).to(n_lr.dtype) + 8
    i_cert = torch.clamp(i_cert, 0, n_out - 1)
    i_cert = torch.minimum(i_cert, torch.clamp(n_lr - 1, min=0))
    # a 1-element index: indexing with a 0-d tensor would read it on the host
    vstar = vals.index_select(0, i_cert.reshape(1)).reshape(())
    above = (neg >= vstar) & lr_ok
    tot_max = lr_row.max()
    abv_max = above.sum(dim=1).max()
    exact = (tot_max <= k_row) | (torch.isfinite(vstar) & (abv_max <= k_row))
    head = torch.stack([n_lr, tot_max, exact.to(n_lr.dtype),
                        sr_flags.sum().to(n_lr.dtype)])
    p = PendingExtract(
        head=to_host(head), vals=to_host(vals),
        idx=to_host(idx.to(torch.int32)),
        sr_idx=sr_idx if keep_sr else to_host(sr_idx),
        sr_vals=sr_vals if keep_sr else to_host(sr_vals), keep_sr=keep_sr,
    )
    if mi.device.type == "cuda":
        p.event = torch.cuda.Event()
        p.event.record()
    return p


def finish_extract(p: PendingExtract) -> TileExtract:
    """Wait for a dispatched extraction and return its result."""
    if p.event is not None:
        p.event.synchronize()
    n_lr, row_max, exact, n_sr = p.head.tolist()
    return TileExtract(
        n_lr=int(n_lr),
        exact=bool(exact),
        vals=p.vals.numpy(),
        idx=p.idx.numpy(),
        n_sr=int(n_sr),
        sr_idx=p.sr_idx if p.keep_sr else p.sr_idx.numpy(),
        sr_vals=p.sr_vals if p.keep_sr else p.sr_vals.numpy(),
        row_max=int(row_max),
    )


def extract_tile(
    dev: DeviceInputs, bi: int, bj: int, *, block: int, sr_dist: int,
    g: int, K: int, k_row: int, prob: float, Rf: int, Rt: int, pure: bool,
    keep_sr: bool = False, n_sr: Optional[int] = None,
    cols: Optional[Tuple[int, int]] = None,
) -> TileExtract:
    """One tile -> SR pairs, LR top-K and certificate, synchronously
    (`dispatch_extract` then `finish_extract`)."""
    return finish_extract(dispatch_extract(
        dev, bi, bj, block=block, sr_dist=sr_dist, g=g, K=K, k_row=k_row,
        prob=prob, Rf=Rf, Rt=Rt, pure=pure, keep_sr=keep_sr, n_sr=n_sr,
        cols=cols,
    ))


def full_tile_emit(
    mi: np.ndarray, ranked: RankedSnps, valid: np.ndarray,
    paint_sorted: np.ndarray, bi: int, bj: int, g: int, sr_dist: int,
    lr_prob: Optional[float], lr_rows_sink: Callable,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host extraction of a whole [B, B] f32 MI tile (the JAX package's
    `_finish_full` / `_fallback_full_tile`): every valid pair (i > j on a
    diagonal tile), the f64 type-7 LR retention over the tile's LR
    values.  Emits the LR links and returns the tile's SR pairs (i32 flat
    index, f32 MI), which the caller emits in the canonical tile order."""
    from ldweaver_tpu_torch.core.mi import circular_len
    from ldweaver_tpu_torch.core.sweep import _emit_pairs

    B = ranked.block
    f_sl = slice(bi * B, (bi + 1) * B)
    t_sl = slice(bj * B, (bj + 1) * B)
    pos_f, pos_t = ranked.pos[f_sl], ranked.pos[t_sl]
    if bi == bj:
        fii, fjj = np.tril_indices(B, -1)
        fii = fii.astype(np.int32)
        fjj = fjj.astype(np.int32)
    else:
        fii = np.repeat(np.arange(B, dtype=np.int32), B)
        fjj = np.tile(np.arange(B, dtype=np.int32), B)
    okm = valid[f_sl][fii] & valid[t_sl][fjj]
    fii, fjj = fii[okm], fjj[okm]
    if fii.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    vals = mi[fii, fjj]
    lens = circular_len(pos_t[fjj], pos_f[fii], g)  # symmetric
    sr = lens <= sr_dist
    record = ((fii[sr].astype(np.int64) * B + fjj[sr]).astype(np.int32),
              vals[sr].astype(np.float32))
    _emit_pairs(
        fii, fjj, vals.astype(np.float64), pos_f, pos_t,
        paint_sorted[f_sl], paint_sorted[t_sl], g, sr_dist, lr_prob, [],
        lr_rows_sink,
    )
    return record


def fallback_full_tile(
    dev: DeviceInputs, ranked: RankedSnps, valid: np.ndarray,
    paint_sorted: np.ndarray, bi: int, bj: int, g: int, sr_dist: int,
    lr_prob: Optional[float], lr_rows_sink: Callable,
    cols: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact full-tile extraction for tiles the bounded extraction cannot
    certify: the tile on the device, then `full_tile_emit`."""
    B = ranked.block
    pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
    mi = tile_mi(
        dev, bi, bj, B, int(ranked.block_rmax[bi]), int(ranked.block_rmax[bj]),
        pure, cols,
    ).cpu().numpy()
    return full_tile_emit(mi, ranked, valid, paint_sorted, bi, bj, g, sr_dist,
                          lr_prob, lr_rows_sink)


def recover_lr(
    dev: DeviceInputs, ranked: RankedSnps, valid: np.ndarray,
    paint_sorted: np.ndarray, res: TileExtract, bi: int, bj: int, *,
    g: int, sr_dist: int, lr_prob: Optional[float], K: int, k_row: int,
    emit_kw: dict, cols: Optional[Tuple[int, int]] = None,
) -> Tuple[bool, bool]:
    """The LR side of a tile whose primary extraction failed its
    certificate (its SR side was emitted from the primary result): a
    boosted-capacity retry when it moves fewer bytes than the B^2 f32
    tile, else (or if the retry fails too) the exact full tile.  The
    policy of both JAX sweeps.  Returns (retried, fell_back)."""
    B = ranked.block
    Rf, Rt = int(ranked.block_rmax[bi]), int(ranked.block_rmax[bj])
    pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
    retried = False
    if lr_prob is not None:
        K2, k2 = retry_dims(res, B, lr_prob, K, k_row)
        if K2 * 8 < B * B * 4:
            res2 = extract_tile(  # its SR side is unused: no copy
                dev, bi, bj, block=B, sr_dist=int(sr_dist), g=int(g), K=K2,
                k_row=k2, prob=lr_prob, Rf=Rf, Rt=Rt, pure=pure, keep_sr=True,
                n_sr=emit_kw["expected_sr"], cols=cols,
            )
            retried = True
            if emit_tile_lr(res2, K=K2, **emit_kw):
                return True, False
    fallback_full_tile(
        dev, ranked, valid, paint_sorted, bi, bj, g, sr_dist, lr_prob,
        emit_kw["lr_rows_sink"], cols=cols,
    )
    return retried, True


def tile_emit_kw(ranked: RankedSnps, paint_sorted: np.ndarray, bi: int,
                 bj: int, *, g: int, sr_dist: int, lr_prob: Optional[float],
                 expected_sr: int, sr_links: List[list],
                 lr_rows_sink: Callable) -> dict:
    """The per-tile keyword arguments of `emit_tile_lr` and
    `emit_sr_pairs`."""
    B = ranked.block
    f_sl = slice(bi * B, (bi + 1) * B)
    t_sl = slice(bj * B, (bj + 1) * B)
    return dict(
        B=B, pos_f=ranked.pos[f_sl], pos_t=ranked.pos[t_sl],
        pnt_f=paint_sorted[f_sl], pnt_t=paint_sorted[t_sl],
        g=g, sr_dist=sr_dist, lr_prob=lr_prob, expected_sr=int(expected_sr),
        sr_links=sr_links, lr_rows_sink=lr_rows_sink,
    )


# --------------------------------------------------------------------------
# The BLK5 driver: one or more shards
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
    checkpoint_dir: Optional[str] = None,
    device_budget_bytes: Optional[int] = None,
    pipeline_depth: int = 4,
    n_devices: Optional[int] = None,
) -> Tuple[Dict[str, float], Optional[DeviceSrReduction]]:
    """Run BLK5's sweep tile by tile (backends "spmd" and "fast" alike)
    and emit links in the reference's order (row-major inside a tile, f64
    thresholds).  Returns (stats, DeviceSrReduction or None).

    Shards: the local devices times the processes of
    `torch.distributed` (`multihost.shard_layout(device, n_devices)`).
    The canonical tile list `panel_pair_order(nb, nb)` is cut into one
    contiguous range a shard;
    each local shard is a lane of one `core.sweep.FastTileRunner`, whose
    slab pool holds every block when the rank codes fit 60% of
    `device_budget_bytes` (by default the card's memory), else the lane's
    tiles are visited in row panels and the slabs stream
    (parallel/slabs.py).  The lanes take tiles in turn, `pipeline_depth`
    a lane dispatched ahead of the host emission.  Under several
    processes every process gathers every tile's results at one fixed
    point after its loop.  Every process then emits LR rows and SR pairs
    tile by tile in the canonical order, so the TSVs are byte-identical
    whatever the shards and the panels.

    `sr_reduce` selects where the SR background model's heavy pass runs
    (`sr_reduce.select_mode`): on the host, every SR pair is emitted into
    `sr_links`; on the device ("device": the gathered pairs on the first
    local device; "part": each shard keeps its own and
    `sr_reduce.run_part_reduction` reduces them by k2 range), no SR pair
    is emitted and the caller finishes with
    `merge_and_sort_sr_links_from_candidates` on the returned reduction
    (TSVs byte-identical to the host mode).  Each process selects the
    mode, and for "part" the range budget (`sr_reduce.part_range_budget`),
    from its own SR budget, against which "device" counts
    `sr_reduce.flat_peak_bytes` of the whole table and "part"
    `sr_reduce.part_peak_bytes` of the largest shard (both measured on the
    card); under several processes they compare their choices before the
    loop and raise if they differ.

    `checkpoint_dir` resumes the sweep tile by tile (the JAX package's
    segment checkpoints, at tile granularity): each finished tile's LR
    rows and, in host SR mode, its SR pairs (i32 flat index, f32 MI) are
    written atomically, keyed by a manifest of the plan, the device type
    and a checksum of the data.  On a rerun a done tile replays from disk
    without a dispatch in host mode; in the device modes it replays its
    LR rows and is dispatched again to rebuild its SR pairs on the card.
    Under several processes there is no checkpoint, as in the JAX package:
    one process's disk says nothing of the others'.

    On CUDA devices the sweep resets the peak memory statistic of its
    local cards and reports its own peaks (`peak_tiles_bytes` after the
    tiles, `peak_bytes` after the SR reduction; the largest card of this
    process).  `emit_s` is the emission in canonical order (LR rows to
    the sink, SR pairs to `sr_links` or the device segments).  Stats also
    hold `shards`, `rank`, `gather_s` and
    `gather_bytes` (the gathers of this process) and `k1_launches` (the
    K1 launches of this process)."""
    from collections import deque

    from ldweaver_tpu_torch.core.sweep import (
        FastTileRunner,
        _BlockCheckpoint,
        data_crc,
        replay_lr_rows,
        tile_payload,
    )
    from ldweaver_tpu_torch.ops.rank_mi import K1
    from ldweaver_tpu_torch.parallel import multihost
    from ldweaver_tpu_torch.parallel.slabs import (
        auto_budget,
        panel_pair_order,
        plan_budget,
    )
    from ldweaver_tpu_torch.parallel.sr_reduce import (
        part_range_budget,
        run_part_reduction,
        sr_budget,
    )

    devices, first, nsh = multihost.shard_layout(device, n_devices)
    device = devices[0]
    L = len(devices)
    world, rank = multihost.process_count(), multihost.process_index()
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
    if perform_sr_only:
        lr_links_approx = None
    sr_counts = sr_pair_counts(ranked, valid, g, sr_dist)
    total_sr = int(sr_counts.sum())
    canonical = list(panel_pair_order(nb, nb))
    shard_tiles = [canonical[lo:hi]
                   for lo, hi in multihost.shard_ranges(len(canonical), nsh)]
    lane_of = {t: l for l in range(L) for t in shard_tiles[first + l]}
    shard_sr = [sum(int(sr_counts[t]) for t in tiles) for tiles in shard_tiles]
    mode = select_mode(sr_reduce, total_sr, g, device, verbose, shard_sr=shard_sr)
    range_budget = (part_range_budget(sr_budget(device), max(shard_sr))
                    if mode == "part" else 0)
    gstats = multihost.GatherStats()
    if world > 1:
        # every process must issue the same collectives: one mode, one plan
        choices = multihost.allgather_object((mode, range_budget), gstats)
        if len(set(choices)) > 1:
            raise RuntimeError(
                "BLK5: the processes chose different SR reductions (mode,"
                f" range budget) by rank: {choices}; give every process the"
                " same LDW_SR_BUDGET and the same card memory")
    keep_sr = mode != "host"
    if device_budget_bytes is None:
        device_budget_bytes = auto_budget(device)
    streaming, max_slabs, panel = plan_budget(snp_data.nseq, B, nb,
                                              device_budget_bytes)
    cuda = device.type == "cuda"
    if cuda:
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)
    k1_before = K1.launches
    runner = FastTileRunner(
        ranked, paint_sorted, valid, hdw, neff, g, sr_dist, lr_retain_links,
        lr_links_approx, sr_links, topk_cap=topk_cap, max_slabs=max_slabs,
        keep_sr=keep_sr, sr_counts=sr_counts, devices=devices,
    )
    depth = max(1, int(pipeline_depth))
    stats = dict(tiles=0, retries=0, fallbacks=0, demoted=False, sr_pairs=0,
                 K=runner.K, k_row=runner.k_row, block=B,
                 sr_reduce={"part": "device-part"}.get(mode, mode),
                 streaming=streaming, max_slabs=max_slabs, panel=panel,
                 depth=depth, pool_bytes=runner.cache.pool.numel(), uploads=0,
                 hits=0, dispatch_s=0.0, finish_s=0.0, emit_s=0.0,
                 ckpt_s=0.0, ckpt_hits=0, shards=nsh, rank=rank, gather_s=0.0,
                 gather_bytes=0)
    ckpt = None
    if checkpoint_dir and world == 1:
        t0 = time.perf_counter()
        plan = (
            snp_data.nsnp, snp_data.nseq, g, int(sr_dist),
            float(lr_retain_links), runner.lr_prob, B, runner.K, runner.k_row,
            int(topk_cap), {"part": "device"}.get(mode, mode), device.type,
            data_crc(ranked.rank_codes, ranked.pos, ranked.r, paint_sorted,
                     np.asarray(hdw, np.float64)),
        )
        ckpt = _BlockCheckpoint(checkpoint_dir, plan)
        stats["ckpt_s"] += time.perf_counter() - t0

    def depth_limit() -> int:
        """In-flight tile cap (`depth` a lane).  Extract-mode tiles hold
        O(P_sr + K) bytes, but full-transfer tiles (post-demotion) each
        hold a B x B f32 output: under a streaming budget, clamp to what
        ~20% of the budget holds (checked per tile: demotion can flip the
        mode)."""
        if not streaming or runner._mode() != "full":
            return depth * L
        return min(depth, max(1, int(device_budget_bytes * 0.2 / (B * B * 4))))

    queue: deque = deque()
    ready: dict = {}  # finished tiles' (LR rows, SR pairs), awaiting their turn
    # device modes: each lane's kept SR pairs (bi, bj, sr_idx, sr_vals) in
    # canonical order ("device": all of them on lane 0)
    segs: List[list] = [[] for _ in range(L)]
    n_emitted = 0

    def emit_ready():
        """Emit the finished tiles that are next in the canonical order."""
        nonlocal n_emitted
        t0 = time.perf_counter()
        while n_emitted < len(canonical) and canonical[n_emitted] in ready:
            ci, cj = canonical[n_emitted]
            rows, sr = ready.pop((ci, cj))
            for cols in rows:
                lr_rows_sink(*cols)
            if mode == "host":
                runner.emit_sr(ci, cj, *sr)
            elif sr is not None and len(sr[0]):
                lane = lane_of[ci, cj] if mode == "part" else 0
                segs[lane].append((ci, cj,
                                   torch.as_tensor(sr[0], device=devices[lane]),
                                   torch.as_tensor(sr[1], device=devices[lane])))
            n_emitted += 1
        stats["emit_s"] += time.perf_counter() - t0

    def finish_one():
        bi, bj, pending, hit = queue.popleft()
        rows: list = []  # the tile's LR rows, emitted in canonical order

        def sink(*cols):
            rows.append(tuple(np.asarray(c) for c in cols))

        t0 = time.perf_counter()
        if hit is not None:  # a checkpointed tile, replayed in its place
            if pending is None:
                sr = (hit["sr_idx"], hit["sr_vals"])
            else:  # device modes: the SR pairs come from the re-dispatch
                sr = runner.finish(pending, None)
                t1 = time.perf_counter()
                stats["finish_s"] += t1 - t0
                t0 = t1
            replay_lr_rows(hit, sink)
            stats["ckpt_s"] += time.perf_counter() - t0
        else:
            sr = runner.finish(pending, sink)
            t1 = time.perf_counter()
            stats["finish_s"] += t1 - t0
            if ckpt is not None:
                ckpt.save(f"spmd_{bi}_{bj}",
                          tile_payload(None if keep_sr else sr, rows))
                stats["ckpt_s"] += time.perf_counter() - t1
        ready[bi, bj] = (rows, sr)
        stats["tiles"] += 1
        if world == 1:
            emit_ready()

    # each lane's tiles in panel order, the lanes taking turns
    lane_tiles = [[t for t in panel_pair_order(nb, panel) if lane_of.get(t) == l]
                  for l in range(L)]
    visit = [(l, lane_tiles[l][k]) for k in range(max(map(len, lane_tiles)))
             for l in range(L) if k < len(lane_tiles[l])]
    cur_panel = [-1] * L
    for lane, (bi, bj) in visit:
        if bi // panel != cur_panel[lane]:
            cur_panel[lane] = bi // panel
            runner.pin_panel(range(cur_panel[lane] * panel,
                                   min((cur_panel[lane] + 1) * panel, nb)),
                             lane=lane)
        stats["sr_pairs"] += int(sr_counts[bi, bj])
        hit = None
        if ckpt is not None:
            t0 = time.perf_counter()
            hit = ckpt.load(f"spmd_{bi}_{bj}")
            stats["ckpt_s"] += time.perf_counter() - t0
            stats["ckpt_hits"] += hit is not None
        pending = None
        if hit is None or keep_sr:
            t0 = time.perf_counter()
            pending = runner.dispatch(bi, bj, lane=lane)
            stats["dispatch_s"] += time.perf_counter() - t0
        queue.append((bi, bj, pending, hit))
        while len(queue) >= depth_limit():
            finish_one()
    while queue:
        finish_one()
    runner.unpin_all()
    if world > 1:
        # every process's tiles, at one fixed point: LR rows, and the SR
        # pairs unless each shard reduces its own ("part")
        def host_sr(sr):
            if mode == "part":
                return None
            return tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                         for x in sr)

        local = {t: (rows, host_sr(sr)) for t, (rows, sr) in ready.items()}
        for r, part in enumerate(multihost.allgather_object(local, gstats)):
            if r != rank:
                ready.update(part)
        emit_ready()
    if n_emitted != len(canonical):
        raise RuntimeError(f"BLK5: {len(canonical) - n_emitted} tiles missing")
    stats.update(retries=runner.retries, fallbacks=runner.fallbacks,
                 demoted=runner._demoted,
                 uploads=sum(c.uploads for c in runner.caches),
                 hits=sum(c.hits for c in runner.caches),
                 k1_launches=K1.launches - k1_before)
    if cuda:
        stats["peak_tiles_bytes"] = max(torch.cuda.max_memory_allocated(d)
                                        for d in set(devices))
    reduction = None
    red_kw = dict(ranked_pos=ranked.pos, paint_sorted=paint_sorted, B=B, nb=nb,
                  g=int(g), sr_dist=int(sr_dist), nclust=len(sr_links),
                  total_sr=total_sr)
    if mode == "device":
        reduction = run_device_reduction(
            segs[0], runner.dev.pos, runner.dev.paint, **red_kw)
    elif mode == "part":
        pos_blocks = [ranked.pos[i * B : (i + 1) * B][valid[i * B : (i + 1) * B]]
                      for i in range(nb)]
        reduction = run_part_reduction(
            segs, [d.pos for d in runner.devs], [d.paint for d in runner.devs],
            shard_tiles=shard_tiles, first_shard=first, pos_blocks=pos_blocks,
            part_budget_bytes=range_budget,
            gather=(None if world == 1 else
                    lambda obj: multihost.allgather_object(obj, gstats)),
            **red_kw)
    if reduction is not None:
        stats.update(reduction.stats)
    stats.update(gather_s=gstats.seconds, gather_bytes=gstats.nbytes)
    for k in ("dispatch_s", "finish_s", "emit_s", "ckpt_s", "gather_s"):
        stats[k] = round(stats[k], 3)
    if cuda:
        stats["peak_bytes"] = max(torch.cuda.max_memory_allocated(d)
                                  for d in set(devices))
    if verbose:
        print(
            f"BLK5 sweep: {stats['tiles']} tiles on {L} local device(s)"
            f" ({device}) of {nsh} shard(s), {stats['sr_pairs']} sr pairs,"
            f" {stats['retries']} retries, {stats['fallbacks']} fallbacks, SR"
            f" reduction {stats['sr_reduce']}; slab cache {stats['uploads']}"
            f" uploads, {stats['hits']} hits"
            f" ({'streamed' if streaming else 'resident'},"
            f" {max_slabs or nb} slots, panel {panel}); depth {depth}"
            + (f"; {stats['ckpt_hits']} tiles from checkpoints"
               if ckpt is not None else "")
            + (f"; gathered {stats['gather_bytes']} bytes in"
               f" {stats['gather_s']} s" if world > 1 else ""),
            flush=True,
        )
    return stats, reduction
