"""Blocked all-vs-all MI sweep driver (reference `perform_MI_computation`,
R/computePairwiseMI.R:46-145 + per-block `perform_MI_computation_ACGTN`,
R/computePairwiseMI.R:167-386).

backend "spmd": the r-stratified tile sweep runs on one device
(parallel/spmd_sweep.py), and with `sr_reduce` "auto" (when the SR table
fits) or "device" the SR background model reduces there too
(parallel/sr_reduce.py).  The compat backends "jax", "pallas" and
"numpy" walk the reference's contiguous `make_blocks` tiling with one MI
tile per block pair (`sweep_block_pair`): "numpy" the float64 oracle on
the host, "jax" the f32 PyTorch tile (`core/mi.mi_tile_jax`), "pallas"
kernel K3 (`ops/compat_mi.mi_tile_pallas`); link extraction is host code.
The background model, ARACNE and the TSV writers run on the host.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Callable, List, Optional

import numpy as np

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
from ldweaver_tpu_torch.parallel.spmd_sweep import blk5_sweep, fast_block_size
from ldweaver_tpu_torch.support import check_supported, resolve_device
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
    n_devices: Optional[int] = None,
    phase_timings: Optional[dict] = None,
    sr_reduce: str = "auto",
    device="cuda",
):
    """Full MI computation + background model + ARACNE + TSV outputs.

    Returns the reduced short-range link table (SrLinks with ARACNE column),
    like the reference returns sr_links_red (R/computePairwiseMI.R:143).
    phase_timings, if given a dict, is filled with the wall-clock split
    (sweep / background fit / aracne / sr write, plus the spmd sweep's
    tile stats).  rxy_compat selects the reference's RXY alias on the
    compat backends."""
    check_supported(
        backend=backend, n_devices=n_devices, checkpoint_dir=checkpoint_dir,
    )
    device = resolve_device(device)
    t000 = time.time()
    # the reference rounds the block size to a 1000-multiple (:69); that
    # shapes only the compat tiling, the spmd tile keeps max_blk_sz
    fast_blk = fast_block_size(snp_data.nsnp, max_blk_sz)
    blocks = make_blocks(snp_data.nsnp, round_blk_sz(max_blk_sz))
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

    dev_sr = None
    if backend == "spmd":
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
        )
        if phase_timings is not None:
            phase_timings["spmd"] = stats
    else:
        for bi in range(blocks.shape[0]):
            t0 = time.time()
            fs, fe, ts, te = (int(v) for v in blocks[bi])
            sweep_block_pair(
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
                lr_sink,
                backend=backend,
                rxy_compat=rxy_compat,
                perform_sr_only=perform_sr_analysis_only,
                device=device,
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
