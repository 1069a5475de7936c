"""Blocked all-vs-all MI sweep driver (reference `perform_MI_computation`,
R/computePairwiseMI.R:46-145 + per-block `perform_MI_computation_ACGTN`,
R/computePairwiseMI.R:167-386).

backends "spmd" and "fast" are one sweep (`parallel/spmd_sweep.blk5_sweep`):
the r-stratified tiles run on one or more devices and processes through
`FastTileRunner`,
dispatched `pipeline_depth` ahead of the host emission and fed from a
slab cache whose pool a device budget bounds (parallel/slabs.py); with
`sr_reduce` "auto" (when the SR table fits) or "device" the SR background
model reduces on the device too (parallel/sr_reduce.py).  The two names
differ only in the key of their stats.  The compat backends "jax", "pallas" and
"numpy" walk the reference's contiguous `make_blocks` tiling with one MI
tile per block pair (`sweep_block_pair`): "numpy" the float64 oracle on
the host, "jax" the f32 PyTorch tile (`core/mi.mi_tile_jax`), "pallas"
kernel K3 (`ops/compat_mi.mi_tile_pallas`); link extraction is host code.
The background model, ARACNE and the TSV writers run on the host.

With `checkpoint_dir` every backend resumes an interrupted sweep: each
finished block pair (compat) or tile ("spmd" and "fast", under
`spmd_tiles/`) is written atomically as one uncompressed npz, and a
manifest of the configuration, the device type and a checksum of the
data invalidates stale ones (`_BlockCheckpoint`).
"""

from __future__ import annotations

import functools
import json
import os
import time
import zipfile
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldweaver_tpu_torch.core.aracne import run_aracne
from ldweaver_tpu_torch.core.background import (
    merge_and_sort_sr_links,
    merge_and_sort_sr_links_from_candidates,
)
from ldweaver_tpu_torch.core import mi as mi_mod
from ldweaver_tpu_torch.core.mi import (
    LinkTable,
    circular_len,
    estimate_lr_links,
    make_blocks,
    round_blk_sz,
    tile_pair_indices,
)
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.io.writers import append_tsv_rows, format_float
from ldweaver_tpu_torch.ops.compat_mi import mi_tile_pallas
from ldweaver_tpu_torch.parallel.fast_sweep import tile_masks, two_stage_topk
from ldweaver_tpu_torch.parallel.slabs import SlabCache
from ldweaver_tpu_torch.parallel.spmd_sweep import (
    _circular_window_counts,
    blk5_sweep,
    device_inputs,
    dispatch_extract,
    emit_sr_pairs,
    emit_tile_lr,
    extract_dims,
    fallback_full_tile,
    fast_block_size,
    finish_extract,
    full_tile_emit,
    recover_lr,
    sr_pair_counts,
    tile_emit_kw,
    tile_mi,
    to_host,
)
from ldweaver_tpu_torch.support import check_supported, resolve_device
from ldweaver_tpu_torch.utils.profiling import maybe_trace, span
from ldweaver_tpu_torch.utils.r_compat import quantile_type7


def _tile_backend(backend: str, device) -> Callable:
    if backend == "numpy":
        return mi_mod.mi_tile_numpy
    if backend == "jax":
        return functools.partial(mi_mod.mi_tile_jax, device=device)
    if backend == "pallas":
        return functools.partial(mi_tile_pallas, device=device)
    raise ValueError(f"unknown MI backend {backend!r}")


def sweep_block_pair(
    snp_data: SnpData,
    hdw: np.ndarray,
    paint: np.ndarray,
    neff: float,
    fs: int,
    fe: int,
    ts: int,
    te: int,
    sr_dist: int,
    lr_retain_links: float,
    lr_links_approx: Optional[float],
    sr_links: List[LinkTable],
    lr_rows_sink: Callable,
    backend: str = "jax",
    rxy_compat: bool = True,
    perform_sr_only: bool = False,
    device="cuda",
):
    """One block-pair: MI tile + SR/LR link extraction
    (R/computePairwiseMI.R:167-386).  fs/fe/ts/te are 1-based inclusive.
    """
    g = snp_data.g
    from_idx = np.arange(fs - 1, fe, dtype=np.int64)
    to_idx = np.arange(ts - 1, te, dtype=np.int64)
    pos = snp_data.pos

    if perform_sr_only:
        # drop sites forming no short-range pair (strict <, :182-183)
        pf = pos[from_idx].astype(np.float64)
        pt = pos[to_idx].astype(np.float64)
        lens_ft = 0.5 * g - np.abs(
            np.mod(pt[None, :] - pf[:, None], g) - 0.5 * g
        )
        kp_f = (np.abs(lens_ft) < sr_dist).any(axis=1)
        kp_t = (np.abs(lens_ft) < sr_dist).any(axis=0)
        from_idx = from_idx[kp_f]
        to_idx = to_idx[kp_t]
        if from_idx.size == 0 or to_idx.size == 0:
            return

    pos_f = pos[from_idx]
    pos_t = pos[to_idx]
    paint_f = paint[from_idx]
    paint_t = paint[to_idx]
    r_f = snp_data.r[from_idx]
    r_t = snp_data.r[to_idx]
    uq_f = snp_data.uqe[from_idx]
    uq_t = snp_data.uqe[to_idx]
    codes_f = np.ascontiguousarray(snp_data.codes[:, from_idx].T)
    codes_t = np.ascontiguousarray(snp_data.codes[:, to_idx].T)

    tile_fn = _tile_backend(backend, device)
    mi = tile_fn(
        codes_f, codes_t, hdw, r_f, r_t, uq_f, uq_t, neff, rxy_compat=rxy_compat
    )
    mi = np.asarray(mi, dtype=np.float64)

    diagonal_block = fs == ts and fe == te
    ii, jj = tile_pair_indices(from_idx.size, to_idx.size, diagonal_block)
    if ii.size == 0:
        return

    pos2 = pos_f[ii]
    pos1 = pos_t[jj]  # orientation per R/computePairwiseMI.R:319-320
    clust2 = paint_f[ii]
    clust1 = paint_t[jj]
    lens = circular_len(pos1, pos2, g)  # :330
    vals = mi[ii, jj]

    sr_mask = lens <= sr_dist  # :333
    lr_mask = ~sr_mask

    if lr_mask.any() and not perform_sr_only:
        lrv = vals[lr_mask]
        prob = max(
            0.0, 1.0 - lr_retain_links / lr_links_approx
        )  # :352 (block factors cancel)
        disc_thresh = quantile_type7(lrv, prob)
        keep = lrv >= disc_thresh  # :358
        if keep.any():
            sel = np.flatnonzero(lr_mask)[keep]
            lr_rows_sink(
                pos1[sel],
                pos2[sel],
                clust1[sel],
                clust2[sel],
                lens[sel],
                vals[sel],
            )

    if sr_mask.any():
        sel = np.flatnonzero(sr_mask)
        t = LinkTable(
            pos1=pos1[sel],
            pos2=pos2[sel],
            clust1=clust1[sel],
            clust2=clust2[sel],
            len=lens[sel],
            MI=vals[sel],
        )
        nclust = len(sr_links)
        for ci in range(1, nclust + 1):
            m = (t.clust1 == ci) | (t.clust2 == ci)  # .compareToRow, :373
            if m.any():
                sr_links[ci - 1].append(t.take(np.flatnonzero(m)))


def _emit_pairs(
    ii, jj, vals, pos_f, pos_t, paint_f, paint_t, g, sr_dist,
    lr_prob, sr_links, lr_rows_sink, apply_lr_quantile=True,
    lr_thresh=None,
):
    """Shared link emission: orientation-normalise, split SR/LR, apply the
    per-block LR retention quantile, bin SR links per cluster."""
    pos2 = pos_f[ii]
    pos1 = pos_t[jj]
    clust2 = paint_f[ii]
    clust1 = paint_t[jj]
    # normalise orientation to pos1 < pos2 (the r-stratified permutation
    # makes raw emission orientation arbitrary; the reference's diagonal
    # blocks emit pos1 < pos2 - R/computePairwiseMI.R:306-320)
    swap = pos1 > pos2
    pos1_n = np.where(swap, pos2, pos1)
    pos2_n = np.where(swap, pos1, pos2)
    clust1_n = np.where(swap, clust2, clust1)
    clust2_n = np.where(swap, clust1, clust2)
    pos1, pos2, clust1, clust2 = pos1_n, pos2_n, clust1_n, clust2_n
    lens = circular_len(pos1, pos2, g)

    sr_mask = lens <= sr_dist
    lr_mask = ~sr_mask
    if lr_mask.any() and lr_prob is not None:
        lrv = vals[lr_mask]
        if apply_lr_quantile:
            disc_thresh = quantile_type7(lrv, lr_prob)
        else:
            disc_thresh = lr_thresh
        keep = lrv >= disc_thresh
        if keep.any():
            sel = np.flatnonzero(lr_mask)[keep]
            lr_rows_sink(
                pos1[sel], pos2[sel], clust1[sel], clust2[sel],
                lens[sel], vals[sel],
            )
    if sr_mask.any():
        sel = np.flatnonzero(sr_mask)
        t = LinkTable(
            pos1=pos1[sel], pos2=pos2[sel], clust1=clust1[sel],
            clust2=clust2[sel], len=lens[sel], MI=vals[sel],
        )
        for ci in range(1, len(sr_links) + 1):
            m = (t.clust1 == ci) | (t.clust2 == ci)
            if m.any():
                sr_links[ci - 1].append(t.take(np.flatnonzero(m)))




# --------------------------------------------------------------------------
# The fast backend: split dispatch / finish over a slab cache
# --------------------------------------------------------------------------
def _lr_quantile(mi: torch.Tensor, lr_ok: torch.Tensor, prob: float):
    """Type-7 quantile of the tile's LR values, on the device: the two
    order statistics around (n - 1) * prob interpolated in float64 (NaN
    for a tile without LR pairs)."""
    xs = torch.sort(torch.where(lr_ok, mi, float("nan")).reshape(-1)).values
    n = lr_ok.sum()
    h = (n.to(torch.float64) - 1.0) * prob
    lo = torch.clamp(torch.floor(h).to(torch.int64), min=0)
    hi = torch.clamp(torch.minimum(lo + 1, n - 1), min=0)
    x_lo, x_hi = xs.index_select(0, torch.stack([lo, hi])).to(torch.float64)
    q = x_lo + (h - lo.to(torch.float64)) * (x_hi - x_lo)
    return torch.where(n > 0, q, float("nan"))


class FastTileRunner:
    """Tile executor of BLK5 (backends "spmd" and "fast",
    parallel/spmd_sweep.blk5_sweep): a slab cache on the device and split
    `dispatch` / `finish`, so the sweep queues tiles ahead and the card
    computes while the host emits links.  `dispatch` waits for
    nothing on the card: it reads the tile's two slabs from the cache
    pool, queues the tile (kernel K1) and the copies of its results into
    pinned host memory, and records an event; `finish` waits on the event
    and emits.

    Transfer modes per tile:
      'extract' (the 'auto' default) - the spmd sweep's on-device link
        extraction (parallel/spmd_sweep.dispatch_extract): the SR pairs
        compacted into the tile's exact host-known count (kept on the
        device with `keep_sr`, for the on-device SR reduction), a
        certified two-stage LR top-K;
      'summary' - the tile's f64 type-7 LR threshold, an LR top-K with 16
        candidates a row, and the submatrix of the rows and columns that
        can hold SR pairs;
      'full' - the whole [B, B] tile, extracted on the host (also the
        exact fallback of a saturated summary tile).
    A failed LR certificate takes the boosted retry and then the full
    tile (spmd_sweep.recover_lr); repeated saturation (4 fallbacks, and
    at least as many as tiles that succeeded) demotes the runner to full
    transfers.  Outputs do not depend on the transfer mode.

    `devices` are the local devices (the JAX runner's `devices=`; None,
    as there, the first card): each
    is a lane with its own slab cache and device inputs; `dispatch` sends
    a tile to the lane it is given (lane 0 by default), and `finish` runs
    its retry or fallback on the same lane.  Results do not depend on the
    lane."""

    def __init__(
        self,
        ranked,
        paint_sorted: np.ndarray,
        valid: np.ndarray,
        hdw: np.ndarray,
        neff: float,
        g: int,
        sr_dist: int,
        lr_retain_links: float,
        lr_links_approx: Optional[float],
        sr_links: List[list],
        transfer: str = "auto",
        topk: int = 8192,
        max_slabs: Optional[int] = None,
        keep_sr: bool = False,
        topk_cap: int = 1 << 18,
        sr_counts: Optional[np.ndarray] = None,
        devices: Optional[Sequence] = None,
    ):
        self.ranked = ranked
        self.paint_sorted = paint_sorted
        self.valid = valid
        self.g = g
        self.sr_dist = sr_dist
        self.sr_links = sr_links
        self.transfer = transfer
        self.topk = topk
        self.keep_sr = keep_sr
        self.lr_prob = (
            None
            if lr_links_approx is None
            else max(0.0, 1.0 - lr_retain_links / lr_links_approx)
        )
        self.caches, self.devs = [], []
        for d in devices or [resolve_device("cuda")]:
            cache = SlabCache(ranked.rank_codes, ranked.block, max_slabs, d)
            self.caches.append(cache)
            self.devs.append(device_inputs(
                ranked, valid, np.asarray(hdw, np.float64), neff, d,
                paint_sorted if keep_sr else None, codes=cache.pool,
            ))
        self.cache, self.dev = self.caches[0], self.devs[0]  # lane 0
        self.K, self.k_row = extract_dims(ranked.block, self.lr_prob,
                                          k_max=topk_cap)
        self.sr_counts = (sr_pair_counts(ranked, valid, g, sr_dist)
                          if sr_counts is None else sr_counts)
        self.fallbacks = 0
        self.retries = 0
        self._summary_ok = 0
        self._demoted = False

    def _mode(self) -> str:
        if self._demoted or self.transfer == "full":
            return "full"
        if self.transfer == "summary":
            return "summary"
        return "extract"  # 'auto' / 'extract'

    def _bucket(self, bi: int, bj: int):
        rk = self.ranked
        return (int(rk.block_rmax[bi]), int(rk.block_rmax[bj]),
                bool(rk.block_pure[bi]) and bool(rk.block_pure[bj]))

    def _cols(self, bi: int, bj: int, lane: int = 0) -> Tuple[int, int]:
        cache = self.caches[lane]
        return cache.get(bi), cache.get(bj)

    def pin_panel(self, rows, lane: int) -> None:
        """Pin a panel's row slabs in one lane's cache."""
        self.caches[lane].unpin()
        self.caches[lane].pin(rows)

    def unpin_all(self) -> None:
        for c in self.caches:
            c.unpin()

    def _emit_kw(self, bi: int, bj: int, lr_rows_sink: Callable) -> dict:
        return tile_emit_kw(
            self.ranked, self.paint_sorted, bi, bj, g=self.g,
            sr_dist=self.sr_dist, lr_prob=self.lr_prob,
            expected_sr=int(self.sr_counts[bi, bj]), sr_links=self.sr_links,
            lr_rows_sink=lr_rows_sink,
        )

    def emit_sr(self, bi: int, bj: int, sr_idx, sr_vals) -> None:
        """Emit a tile's SR pairs (replay of a checkpoint)."""
        emit_sr_pairs(sr_idx, sr_vals, **self._emit_kw(bi, bj, None))

    # -- dispatch: queue device work, do NOT wait for it ----------------
    def dispatch(self, bi: int, bj: int, lane: int = 0) -> dict:
        with span("ldw.blk5.dispatch"):
            return self._dispatch(bi, bj, lane)

    def _dispatch(self, bi: int, bj: int, lane: int) -> dict:
        cols = self._cols(bi, bj, lane)
        dev = self.devs[lane]
        mode = self._mode()
        Rf, Rt, pure = self._bucket(bi, bj)
        B = self.ranked.block
        if mode == "extract":
            p = dispatch_extract(
                dev, bi, bj, block=B, sr_dist=int(self.sr_dist),
                g=int(self.g), K=self.K, k_row=self.k_row,
                prob=1.0 if self.lr_prob is None else self.lr_prob,
                Rf=Rf, Rt=Rt, pure=pure, keep_sr=self.keep_sr,
                n_sr=int(self.sr_counts[bi, bj]), cols=cols,
            )
            return dict(kind="extract", bi=bi, bj=bj, p=p, lane=lane)
        mi = tile_mi(dev, bi, bj, B, Rf, Rt, pure, cols)
        if mode == "summary":
            out = self._dispatch_summary(bi, bj, mi, dev)
        else:
            out = dict(kind="full", bi=bi, bj=bj, mi=to_host(mi))
        out["lane"] = lane
        if mi.device.type == "cuda":
            out["event"] = torch.cuda.Event()
            out["event"].record()
        return out

    def _dispatch_summary(self, bi: int, bj: int, mi: torch.Tensor,
                          dev) -> dict:
        rk, B, g = self.ranked, self.ranked.block, self.g
        f_sl = slice(bi * B, (bi + 1) * B)
        t_sl = slice(bj * B, (bj + 1) * B)
        pos_f, pos_t = rk.pos[f_sl], rk.pos[t_sl]
        val_f, val_t = self.valid[f_sl], self.valid[t_sl]
        # SR-capable rows / columns from the positions (host, cheap)
        row_cnt = _circular_window_counts(pos_f, pos_t[val_t], g, self.sr_dist)
        col_cnt = _circular_window_counts(pos_t, pos_f[val_f], g, self.sr_dist)
        rows_sel = np.flatnonzero((row_cnt > 0) & val_f)
        cols_sel = np.flatnonzero((col_cnt > 0) & val_t)
        fs, ts = bi * B, bj * B
        _, lr_ok = tile_masks(
            dev.pos[fs : fs + B], dev.pos[ts : ts + B], dev.valid[fs : fs + B],
            dev.valid[ts : ts + B], bi == bj, int(g), int(self.sr_dist),
        )
        prob = 1.0 if self.lr_prob is None else self.lr_prob
        thresh = _lr_quantile(mi, lr_ok, prob)
        neg = torch.where(lr_ok, mi, float("-inf"))
        above = neg >= thresh.to(torch.float32)
        k_row = min(16, B, self.topk)
        vals, idx = two_stage_topk(neg, k_row, self.topk)

        def index(sel):
            t = torch.from_numpy(sel.astype(np.int64))
            if mi.device.type == "cuda":
                t = t.pin_memory().to(mi.device, non_blocking=True)
            return t

        sub = mi[index(rows_sel)][:, index(cols_sel)]
        counts = torch.stack([above.sum(), above.sum(dim=1).max()])
        return dict(
            kind="summary", bi=bi, bj=bj, thresh=to_host(thresh),
            counts=to_host(counts), vals=to_host(vals),
            idx=to_host(idx.to(torch.int32)), sub=to_host(sub),
            rows_sel=rows_sel, cols_sel=cols_sel,
        )

    # -- finish: wait + host emission ------------------------------------
    def finish(self, pending: dict, lr_rows_sink: Optional[Callable]):
        """Emit a dispatched tile's LR links (none with lr_rows_sink=None:
        a tile replayed from a checkpoint whose SR pairs are rebuilt);
        returns its SR pairs (i32 row-major flat index, f32 MI; device
        tensors with keep_sr) for `emit_sr` or the on-device SR reduction,
        which the caller feeds in the canonical tile order (the background
        model's sums follow the SR table's order).  SR is single-sourced
        from the primary result: its compaction is exact whatever the LR
        side."""
        with span("ldw.blk5.finish"):
            return self._finish(pending, lr_rows_sink)

    def _finish(self, pending: dict, lr_rows_sink: Optional[Callable]):
        bi, bj, lane = pending["bi"], pending["bj"], pending["lane"]
        dev = self.devs[lane]
        skip_lr = lr_rows_sink is None
        kw = self._emit_kw(bi, bj, lr_rows_sink or (lambda *cols: None))
        if pending["kind"] == "extract":
            res = finish_extract(pending["p"])
            if res.n_sr != kw["expected_sr"]:
                raise RuntimeError(
                    f"device SR count {res.n_sr} != host count {kw['expected_sr']}"
                )
            record = (res.sr_idx[: res.n_sr], res.sr_vals[: res.n_sr])
            if skip_lr:
                return record
            if emit_tile_lr(res, K=self.K, **kw):
                self._summary_ok += 1
                return record
            # the LR certificate failed: redo only the LR side
            retried, fell_back = recover_lr(
                dev, self.ranked, self.valid, self.paint_sorted, res,
                bi, bj, g=self.g, sr_dist=self.sr_dist, lr_prob=self.lr_prob,
                K=self.K, k_row=self.k_row, emit_kw=kw,
                cols=self._cols(bi, bj, lane),
            )
            self.retries += retried
            if fell_back:
                self._note_fallback()
            else:
                self._summary_ok += 1
            return record
        if pending.get("event") is not None:
            pending["event"].synchronize()
        if pending["kind"] == "full":
            return full_tile_emit(
                pending["mi"].numpy(), self.ranked, self.valid,
                self.paint_sorted, bi, bj, self.g, self.sr_dist, self.lr_prob,
                kw["lr_rows_sink"],
            )
        record = self._finish_summary(pending, kw)
        if record is not None:
            self._summary_ok += 1
            return record
        # saturated top-K: the exact full tile (synchronous)
        self._note_fallback()
        return fallback_full_tile(
            dev, self.ranked, self.valid, self.paint_sorted, bi, bj,
            self.g, self.sr_dist, self.lr_prob, kw["lr_rows_sink"],
            cols=self._cols(bi, bj, lane),
        )

    def _note_fallback(self) -> None:
        """At most one extra dispatch per tile; repeated saturation demotes
        the runner to full transfers, so an adversarially dense dataset
        cannot run every tile twice."""
        self.fallbacks += 1
        if self.fallbacks >= 4 and self.fallbacks >= self._summary_ok:
            self._demoted = True

    def _finish_summary(self, pending: dict, kw: dict):
        B, bi, bj = self.ranked.block, pending["bi"], pending["bj"]
        n_above, n_row_max = pending["counts"].tolist()
        vals = pending["vals"].numpy()
        if n_above > vals.shape[0] or n_row_max > 16:
            return None  # saturated (globally or per row)
        thresh = float(pending["thresh"])
        rows_sel, cols_sel = pending["rows_sel"], pending["cols_sel"]
        if self.lr_prob is not None and np.isfinite(thresh):
            vals64 = vals.astype(np.float64)
            keep = np.isfinite(vals64) & (vals64 >= thresh)
            if keep.any():
                kidx = pending["idx"].numpy()[keep].astype(np.int64)
                order = np.argsort(kidx, kind="stable")  # row-major
                _emit_pairs(
                    kidx[order] // B, kidx[order] % B, vals64[keep][order],
                    kw["pos_f"], kw["pos_t"], kw["pnt_f"], kw["pnt_t"], self.g,
                    self.sr_dist, self.lr_prob, self.sr_links,
                    kw["lr_rows_sink"], apply_lr_quantile=False,
                    lr_thresh=thresh,
                )
        # SR pairs from the gathered submatrix
        sr_idx, sr_vals = np.zeros(0, np.int32), np.zeros(0, np.float32)
        if rows_sel.size and cols_sel.size:
            sub = pending["sub"].numpy()
            lens = circular_len(kw["pos_t"][cols_sel][None, :],
                                kw["pos_f"][rows_sel][:, None], self.g)
            mask = lens <= self.sr_dist
            if bi == bj:
                mask &= rows_sel[:, None] > cols_sel[None, :]
            ri, cj = np.nonzero(mask)
            sr_idx = (rows_sel[ri] * B + cols_sel[cj]).astype(np.int32)
            sr_vals = sub[ri, cj].astype(np.float32)
        if sr_idx.size != kw["expected_sr"]:
            raise RuntimeError(
                f"summary SR count {sr_idx.size} != host count {kw['expected_sr']}"
            )
        return sr_idx, sr_vals


def sweep_block_pair_fast(
    ranked,
    paint_sorted: np.ndarray,
    valid: np.ndarray,
    hdw: np.ndarray,
    neff: float,
    g: int,
    bi: int,
    bj: int,
    sr_dist: int,
    lr_retain_links: float,
    lr_links_approx: Optional[float],
    sr_links: List[LinkTable],
    lr_rows_sink: Callable,
    transfer: str = "auto",
    device="cuda",
):
    """Fast-path block pair, synchronous (dispatch + finish back to back).

    Unlike the compat path, off-diagonal block pairs KEEP their in-block
    diagonal pairs (the reference drops them - a quirk, not a feature).
    The pipeline uses FastTileRunner directly to queue tiles ahead."""
    runner = FastTileRunner(
        ranked, paint_sorted, valid, hdw, neff, g, sr_dist,
        lr_retain_links, lr_links_approx, sr_links, transfer=transfer,
        devices=[resolve_device(device)],
    )
    runner.emit_sr(bi, bj, *runner.finish(runner.dispatch(bi, bj), lr_rows_sink))


# --------------------------------------------------------------------------
# Block checkpoints
# --------------------------------------------------------------------------
LINK_FIELDS = ("pos1", "pos2", "clust1", "clust2", "len", "MI")


def data_crc(*arrays) -> int:
    """crc32 over the bytes of the arrays: a checkpoint manifest keys on
    the data, not only on its shapes."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).view(np.uint8).ravel(), crc)
    return crc


class _BlockCheckpoint:
    """Block-granular sweep checkpointing: each completed block pair (or
    tile) is persisted as one uncompressed npz, written atomically; a
    manifest keyed by the sweep configuration invalidates stale
    checkpoints."""

    def __init__(self, directory: str, config_key):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        manifest = os.path.join(directory, "manifest.json")
        key = json.dumps(list(map(str, config_key)))
        stale = True
        if os.path.exists(manifest):
            try:
                with open(manifest) as fh:
                    stale = fh.read() != key
            except OSError:
                pass
        if stale:
            for f in os.listdir(directory):
                if f.endswith(".npz"):
                    os.unlink(os.path.join(directory, f))
            with open(manifest + ".tmp", "wt") as fh:
                fh.write(key)
            os.replace(manifest + ".tmp", manifest)

    def _path(self, key) -> str:
        return os.path.join(self.dir, f"blk_{key}.npz")

    def load(self, key) -> Optional[dict]:
        """The block's arrays, or None if it has no (readable) checkpoint."""
        try:
            with np.load(self._path(key)) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError, zipfile.BadZipFile):
            return None

    def save(self, key, payload: dict) -> None:
        tmp = self._path(key) + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self._path(key))


def tile_payload(sr, lr_rows) -> dict:
    """Checkpoint arrays of one tile: its SR pairs (i32 flat index, f32
    MI; None when they stay on the device) and its LR rows as emitted."""
    payload = {}
    if sr is not None:
        payload["sr_idx"] = np.asarray(sr[0], np.int32)
        payload["sr_vals"] = np.asarray(sr[1], np.float32)
    for k, cols in enumerate(lr_rows):
        for name, col in zip(LINK_FIELDS, cols):
            payload[f"lr{k}_{name}"] = col
    payload["n_lr"] = np.int64(len(lr_rows))
    return payload


def replay_lr_rows(z: dict, lr_sink: Callable) -> None:
    for k in range(int(z["n_lr"])):
        lr_sink(*[z[f"lr{k}_{name}"] for name in LINK_FIELDS])


def perform_mi_computation(
    snp_data: SnpData,
    hdw: np.ndarray,
    cds_var,
    lr_save_path: str,
    sr_save_path: str,
    plt_folder: Optional[str] = None,
    sr_dist: int = 20000,
    lr_retain_links: float = 1e6,
    max_blk_sz: int = 10000,
    srp_cutoff: float = 3.0,
    run_aracne_flag: bool = True,
    perform_sr_analysis_only: bool = False,
    order_links: bool = True,
    backend: str = "jax",
    rxy_compat: bool = True,
    r_compat_sampling: bool = True,
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    device_budget_bytes: Optional[int] = None,
    pipeline_depth: int = 4,
    n_devices: Optional[int] = None,
    phase_timings: Optional[dict] = None,
    sr_reduce: str = "auto",
    device="cuda",
):
    """Full MI computation + background model + ARACNE + TSV outputs.

    Returns the reduced short-range link table (SrLinks with ARACNE column),
    like the reference returns sr_links_red (R/computePairwiseMI.R:143).

    device_budget_bytes bounds the slab pool of backends "spmd" and
    "fast" (by default the card's memory; under it the slabs stream,
    parallel/slabs.py); pipeline_depth is how many of their tiles are
    dispatched ahead of the host emission.  n_devices and the processes
    of `torch.distributed` shard their tiles (`spmd_sweep.blk5_sweep`);
    the compat backends run on one device.  checkpoint_dir resumes an
    interrupted sweep (module docstring).  phase_timings, if given a
    dict, is filled with the wall-clock split (sweep / background fit /
    aracne / sr write, plus the sweep's tile stats under "spmd" or
    "fast").  rxy_compat selects the reference's RXY alias on the compat
    backends."""
    check_supported(backend=backend, n_devices=n_devices)
    device = resolve_device(device)
    t000 = time.time()
    # the reference rounds the block size to a 1000-multiple (:69); that
    # shapes only the compat tiling, the spmd/fast tile keeps max_blk_sz
    fast_blk = fast_block_size(snp_data.nsnp, max_blk_sz)
    nclust = cds_var.nclust
    # per-cluster PART lists (concatenated once after the sweep: a
    # concat per block would be quadratic in total links)
    sr_links: List[list] = [[] for _ in range(nclust)]
    neff = float(np.asarray(hdw, dtype=np.float64).sum())  # :77

    lr_links_approx = None
    if not perform_sr_analysis_only:
        lr_links_approx = estimate_lr_links(
            snp_data.pos, snp_data.g, sr_dist, r_compat=r_compat_sampling
        )
        if os.path.exists(lr_save_path):
            os.unlink(lr_save_path)

    def lr_sink(pos1, pos2, clust1, clust2, lens, vals):
        # "%.15g" is byte-identical to format_float for finite values (it
        # collapses integral floats to int form like R's as.character);
        # +0.0 normalises -0.0 -> "0" like R
        lens = np.asarray(lens, np.float64) + 0.0
        vals = np.asarray(vals, np.float64) + 0.0
        if np.isnan(lens).any() or np.isnan(vals).any():  # NA semantics
            rows = zip(pos1, pos2, clust1, clust2, lens, vals)
            append_tsv_rows(
                lr_save_path,
                (
                    (
                        str(int(a)),
                        str(int(b)),
                        str(int(c)),
                        str(int(d)),
                        format_float(e),
                        format_float(f),
                    )
                    for a, b, c, d, e, f in rows
                ),
            )
            return
        fmt = "%d\t%d\t%d\t%d\t%.15g\t%.15g\n"
        with open(lr_save_path, "at") as fh:
            fh.write(
                "".join(
                    fmt % t
                    for t in zip(
                        np.asarray(pos1, np.int64).tolist(),
                        np.asarray(pos2, np.int64).tolist(),
                        np.asarray(clust1, np.int64).tolist(),
                        np.asarray(clust2, np.int64).tolist(),
                        lens.tolist(),
                        vals.tolist(),
                    )
                )
            )

    tiled = backend in ("spmd", "fast")
    chkpt = None
    if checkpoint_dir and not tiled:
        # the JAX package's key (core/sweep.py:903-913), the options that
        # change the links, the device type (the compat tiles' numerics
        # differ between the card and the host) and the data's crc
        chkpt = _BlockCheckpoint(checkpoint_dir, config_key=(
            snp_data.nsnp, snp_data.nseq, sr_dist, float(lr_retain_links),
            round_blk_sz(max_blk_sz), backend, nclust,
            perform_sr_analysis_only, lr_links_approx, rxy_compat, device.type,
            data_crc(snp_data.codes, snp_data.pos, np.asarray(hdw, np.float64),
                     cds_var.paint),
        ))

    def run_block(key, fn):
        """Run one compat block pair with block-granular checkpoint and
        restart (the reference resumes only at whole-file granularity,
        R/BacGWES.R:382-385)."""
        hit = chkpt.load(key) if chkpt is not None else None
        if hit is not None:
            for ci, parts in enumerate(sr_links):
                if f"sr{ci}_pos1" in hit:
                    parts.append(LinkTable(*[hit[f"sr{ci}_{f}"] for f in LINK_FIELDS]))
            replay_lr_rows(hit, lr_sink)
            return
        before = [len(t) for t in sr_links]
        lr_acc = []

        def capture_sink(*cols):
            lr_acc.append(tuple(np.asarray(c) for c in cols))
            lr_sink(*cols)

        fn(capture_sink)
        if chkpt is not None:
            payload = tile_payload(None, lr_acc)
            for ci, parts in enumerate(sr_links):
                if len(parts) > before[ci]:
                    tail = LinkTable.concat(parts[before[ci]:])
                    for f in LINK_FIELDS:
                        payload[f"sr{ci}_{f}"] = getattr(tail, f)
            chkpt.save(key, payload)

    dev_sr = None
    with maybe_trace("blk5_sweep"):
        if tiled:
            stats, dev_sr = blk5_sweep(
                snp_data,
                np.asarray(hdw, dtype=np.float64),
                cds_var.paint,
                neff,
                sr_dist,
                lr_retain_links,
                None if perform_sr_analysis_only else lr_links_approx,
                sr_links,
                lr_sink,
                block=fast_blk,
                device=device,
                perform_sr_only=perform_sr_analysis_only,
                verbose=verbose,
                sr_reduce=sr_reduce,
                checkpoint_dir=(os.path.join(checkpoint_dir, "spmd_tiles")
                                if checkpoint_dir else None),
                device_budget_bytes=device_budget_bytes,
                pipeline_depth=pipeline_depth,
                n_devices=n_devices,
            )
            if phase_timings is not None:
                phase_timings[backend] = stats
        else:
            blocks = make_blocks(snp_data.nsnp, round_blk_sz(max_blk_sz))
            for bi in range(blocks.shape[0]):
                t0 = time.time()
                fs, fe, ts, te = (int(v) for v in blocks[bi])
                run_block(
                    f"compat_{fs}_{ts}",
                    lambda sink, fs=fs, fe=fe, ts=ts, te=te: sweep_block_pair(
                        snp_data,
                        np.asarray(hdw, dtype=np.float64),
                        cds_var.paint,
                        neff,
                        fs,
                        fe,
                        ts,
                        te,
                        sr_dist,
                        lr_retain_links,
                        lr_links_approx,
                        sr_links,
                        sink,
                        backend=backend,
                        rxy_compat=rxy_compat,
                        perform_sr_only=perform_sr_analysis_only,
                        device=device,
                    ),
                )
                if verbose:
                    print(
                        f"Block {bi + 1} of {blocks.shape[0]} ... "
                        f"done in {time.time() - t0:.2f} s"
                    )

    _t_sweep_end = time.time()
    if dev_sr is not None:
        # the SR table never left the device: finish the background model
        # from the group stats' fits and the candidate links
        # (byte-identical to the host path; parallel/sr_reduce.py)
        sr_links_red, sr_check, fits = merge_and_sort_sr_links_from_candidates(
            nclust, dev_sr.tables, dev_sr.fits, sr_dist, srp_cutoff
        )
    else:
        sr_tables = [LinkTable.concat(parts) for parts in sr_links]
        sr_links_red, sr_check, fits = merge_and_sort_sr_links(
            nclust, sr_tables, sr_dist, srp_cutoff
        )
    _t_bg_end = time.time()

    if plt_folder is not None:
        os.makedirs(plt_folder, exist_ok=True)
        from ldweaver_tpu_torch.io.writers import save_cluster_fits

        save_cluster_fits(fits, plt_folder)

    if run_aracne_flag and len(sr_links_red) > 0:
        labels = run_aracne(
            sr_links_red.pos1,
            sr_links_red.pos2,
            sr_links_red.MI,
            sr_check.pos1,
            sr_check.pos2,
            sr_check.MI,
        )
        sr_links_red.ARACNE = labels.astype(np.int64)
    else:
        sr_links_red.ARACNE = np.ones(len(sr_links_red), dtype=np.int64)
    _t_aracne_end = time.time()

    if order_links and len(sr_links_red) > 0:  # :134-137
        order = np.argsort(-sr_links_red.srp_max, kind="stable")
        sr_links_red = sr_links_red.take(order)

    # sr_links.tsv: 9 cols, no header (schema R/BacGWES.R:385)
    if os.path.exists(sr_save_path):
        os.unlink(sr_save_path)
    append_tsv_rows(
        sr_save_path,
        (
            (
                str(int(sr_links_red.clust_c[i])),
                str(int(sr_links_red.pos1[i])),
                str(int(sr_links_red.pos2[i])),
                str(int(sr_links_red.clust1[i])),
                str(int(sr_links_red.clust2[i])),
                format_float(sr_links_red.len[i]),
                format_float(sr_links_red.MI[i]),
                format_float(sr_links_red.srp_max[i]),
                str(int(sr_links_red.ARACNE[i])),
            )
            for i in range(len(sr_links_red))
        ),
    )
    if phase_timings is not None:
        phase_timings.update(
            sweep_s=round(_t_sweep_end - t000, 2),
            background_s=round(_t_bg_end - _t_sweep_end, 2),
            aracne_s=round(_t_aracne_end - _t_bg_end, 2),
            sr_write_s=round(time.time() - _t_aracne_end, 2),
        )
    if verbose:
        print(f"All done in {(time.time() - t000) / 60:.2f} mins")
    return sr_links_red

