"""The sharded compat sweep: LR top-k and an SR histogram over shards (the
JAX package's parallel/sweep.py).

The SNP code tensor, weights and per-site arrays are replicated on every
shard (one shard a local device and process,
`multihost.shard_layout`); the list of upper-triangular block pairs is
padded to a multiple of the shard count and cut into one contiguous
range a shard (`pad_pairs`, the JAX mesh's
P('b') split).  Each shard computes one [B, B] 25-allele compat MI tile
a pair with kernel K3 (ops/compat_mi.py, the reference's RXY alias of a
square tile), keeps a two-stage LR top-k and a histogram of the SR MI
values, and the shards' results are merged: the top-k by (MI descending,
pair slot, place in the tile's top-k), which is `lax.top_k`'s tie rule
over the JAX scan's stacked outputs, the histograms by a sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ldweaver_tpu_torch.ops.compat_mi import N_ALLELES, compat_mi_tile
from ldweaver_tpu_torch.parallel.fast_sweep import top_k, wparts


def pad_snp_tensor(codes: np.ndarray, pos: np.ndarray, r: np.ndarray,
                   uqe: np.ndarray, block: int):
    """Pad the SNP axis to a multiple of `block`.  Padded sites get code 5
    (matches no allele -> empty one-hot rows), uq=0 (gates every term to
    zero) and position 0 (excluded by `valid`)."""
    nseq, nsnp = codes.shape
    npad = (-nsnp) % block
    if npad:
        codes = np.concatenate(
            [codes, np.full((nseq, npad), 5, dtype=codes.dtype)], axis=1
        )
        pos = np.concatenate([pos, np.zeros(npad, dtype=pos.dtype)])
        r = np.concatenate([r, np.ones(npad, dtype=r.dtype)])
        uqe = np.concatenate([uqe, np.zeros((npad, 5), dtype=uqe.dtype)])
    valid = np.arange(codes.shape[1]) < nsnp
    return codes, pos, r, uqe, valid


def block_pair_list(nsnp_padded: int, block: int) -> np.ndarray:
    """Upper-triangular block pairs [(bi, bj)] (make_blocks equivalent,
    R/computePairwiseMI.R:147-165) over the padded SNP axis."""
    nb = nsnp_padded // block
    return np.array(
        [(i, j) for i in range(nb) for j in range(i, nb)], dtype=np.int32
    ).reshape(-1, 2)


def pad_pairs(pairs: np.ndarray, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the pair list to a multiple of the shard count; padded entries
    are marked invalid and contribute nothing."""
    p = (-len(pairs)) % n_shards
    valid = np.ones(len(pairs) + p, dtype=bool)
    if p:
        pairs = np.concatenate([pairs, np.zeros((p, 2), dtype=pairs.dtype)])
        valid[-p:] = False
    return pairs, valid


class _ShardInputs:
    """The replicated operands of K3 on one device."""

    def __init__(self, codes, w32, r, uqe, pos, valid, block, device):
        nb = codes.shape[1] // block
        t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(device, dt)
        self.codes = t(codes, torch.uint8)  # [nseq, nsnp_pad], sequence-major
        _, parts = wparts(np.asarray(w32, np.float32))
        self.wparts = parts.to(device).contiguous()
        w = t(w32)
        self.r = t(r)
        self.pos = t(pos, torch.int32)
        self.valid = t(valid, torch.bool)
        # weighted allele counts and uq gates, [nb, 5, block] f32
        px = torch.stack([w @ (self.codes == a).to(torch.float32)
                          for a in range(N_ALLELES)])
        self.px = px.reshape(N_ALLELES, nb, block).transpose(0, 1).contiguous()
        self.uq = (t(uqe).T.reshape(N_ALLELES, nb, block).transpose(0, 1)
                   .contiguous())


def _pair_candidates(x: _ShardInputs, bi: int, bj: int, block: int, g: int,
                     sr_dist: int, neff: float, topk: int, hist_bins: int,
                     hist_max: float):
    """One pair's LR top-k (vals, flat in-tile idx; -inf padded to topk)
    and its SR histogram (the scan body of `build_sharded_sweep`)."""
    B = block
    fs, ts = bi * B, bj * B
    r_f, r_t = x.r[fs : fs + B], x.r[ts : ts + B]
    # the square-tile RXY alias of the compat tile: 0.25 * r_t[i] * r_f[j]
    rxy = (0.25 * r_t[:, None] * r_f[None, :]).contiguous()
    mi = compat_mi_tile(x.codes, fs, ts, B, B, x.wparts, x.px[bi], x.px[bj],
                        r_f, r_t, x.uq[bi], x.uq[bj], neff, rxy)
    ii = torch.arange(B, device=mi.device)
    tri = (ii[:, None] > ii[None, :]) if bi == bj else (ii[:, None] != ii[None, :])
    ok = tri & x.valid[fs : fs + B][:, None] & x.valid[ts : ts + B][None, :]
    d = torch.remainder(x.pos[ts : ts + B][None, :] - x.pos[fs : fs + B][:, None], g)
    lens = 0.5 * g - torch.abs(d.to(torch.float32) - 0.5 * g)
    lr_ok = ok & (lens > sr_dist)
    sr_ok = ok & (lens <= sr_dist)
    masked = torch.where(lr_ok, mi, float("-inf"))
    k_row = min(64, B, topk)
    srt, col = torch.sort(-masked, dim=1, stable=True)
    row_vals, row_idx = -srt[:, :k_row], col[:, :k_row]
    flat_rc = ii[:, None] * B + row_idx
    vals, sel = top_k(row_vals.reshape(-1), min(topk, B * k_row))
    idx = flat_rc.reshape(-1)[sel]
    if vals.numel() < topk:
        pad = topk - vals.numel()
        vals = torch.cat([vals, torch.full((pad,), float("-inf"), device=mi.device)])
        idx = torch.cat([idx, torch.zeros(pad, dtype=idx.dtype, device=mi.device)])
    b = torch.clamp((mi / (hist_max / hist_bins)).to(torch.int32), 0, hist_bins - 1)
    hist = torch.bincount(b[sr_ok], minlength=hist_bins)
    return vals, idx, hist


def sharded_lr_topk(
    snp_data,
    hdw: np.ndarray,
    block: int = 512,
    sr_dist: int = 20000,
    topk: int = 1024,
    n_devices: Optional[int] = None,
    hist_bins: int = 256,
    hist_max: float = 4.0,
    device="cuda",
):
    """The sharded sweep -> (pos1, pos2, MI) of the global long-range top-k,
    MI descending, and the [hist_bins] i32 histogram of the SR MI values
    (bins of hist_max / hist_bins, the last one open).  Shards: the local
    devices (`support.resolve_devices(device, n_devices)`) times the
    processes of `torch.distributed`; every process returns the merged
    result."""
    from ldweaver_tpu_torch.parallel import multihost

    devices, first, nsh = multihost.shard_layout(device, n_devices)
    codes, pos, r, uqe, valid = pad_snp_tensor(
        snp_data.codes, snp_data.pos, snp_data.r, snp_data.uqe, block
    )
    pairs, pair_valid = pad_pairs(block_pair_list(codes.shape[1], block), nsh)
    per = len(pairs) // nsh
    neff = float(np.float32(np.asarray(hdw, np.float64).sum()))
    w32 = np.asarray(hdw, np.float32)
    local = []
    for l, d in enumerate(devices):
        x = _ShardInputs(codes, w32, r, uqe, pos, valid, block, d)
        best_v = torch.full((topk,), float("-inf"), device=d)
        best_t = torch.zeros((topk,), dtype=torch.int64, device=d)
        best_x = torch.zeros((topk,), dtype=torch.int64, device=d)
        hist = torch.zeros(hist_bins, dtype=torch.int64, device=d)
        lo = (first + l) * per
        for slot in range(lo, lo + per):
            if not pair_valid[slot]:
                continue
            bi, bj = (int(v) for v in pairs[slot])
            vals, idx, h = _pair_candidates(x, bi, bj, block, int(snp_data.g),
                                            int(sr_dist), neff, topk,
                                            hist_bins, hist_max)
            tie = torch.arange(topk, device=d) + slot * topk
            v, sel = top_k(torch.cat([best_v, vals]), topk)
            best_t = torch.cat([best_t, tie])[sel]
            best_x = torch.cat([best_x, idx])[sel]
            best_v = v
            hist += h
        local.append((best_v.cpu().numpy(), best_t.cpu().numpy(),
                      best_x.cpu().numpy(), hist.cpu().numpy()))
    parts = [p for r_ in multihost.allgather_object(local) for p in r_]
    v, tie, x_ = (np.concatenate([p[k] for p in parts]) for k in range(3))
    hist = np.sum([p[3] for p in parts], axis=0).astype(np.int32)
    o = np.lexsort((tie, -v.astype(np.float64)))[:topk]
    v, tie, x_ = v[o], tie[o], x_[o]
    keep = np.isfinite(v)
    v, slot, x_ = v[keep], tie[keep] // topk, x_[keep]
    bi = pairs[slot, 0].astype(np.int64)
    bj = pairs[slot, 1].astype(np.int64)
    pos2 = pos[bi * block + x_ // block]  # from side
    pos1 = pos[bj * block + x_ % block]  # to side (reference orientation)
    return pos1, pos2, v, hist
