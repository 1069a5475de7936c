"""Host side of the MI engine: blocking, distances, the float64 oracle
tile, the LR link-count estimate and the link-table container.

The statistic, for SNP pair (f, t) with per-sequence weights hdw,
neff = sum(hdw), per-site distinct-allele counts r, and weighted counts
n_X(f) = sum_s hdw[s]*1[allele X at site f in seq s]:

  den(f,t) = neff + 0.5*r_f*r_t
  MI(f,t)  = sum_{X,Y in ACGTN} uq_f(X) uq_t(Y) *
             (n_XY+0.5)/den * log( (n_XY+0.5)*den /
                (n_X*n_Y + RXY + 0.5*n_X*r_f + 0.5*n_Y*r_t) )

(reference: R/computePairwiseMI.R:46-398, src/computeMI.cpp:11-21).  The
rank-compacted device tile lives in parallel/fast_sweep.py and
ops/rank_mi.py, the compat kernel tile in ops/compat_mi.py.  This module
holds the NumPy host parts, copied from the JAX package's, and
`mi_tile_jax`, the PyTorch counterpart of its XLA compat tile.
Reference quirks replicated in `mi_tile_numpy` and `rxy_term`:
  * the marginal pseudocounts pair n_X with its OWN site's r
    (R/computePairwiseMI.R:262-263,393-394);
  * RXY is `t(tcrossprod(rf, rt))*0.25` indexed linearly against the
    [F,T] tile (src/computeMI.cpp:19); `rxy_term(..., compat=True)`
    reproduces that aliasing.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

import torch

from ldweaver_tpu_torch.support import resolve_device
from ldweaver_tpu_torch.utils.r_compat import RRandomState

_F64 = np.float64


# --------------------------------------------------------------------------
# Blocking
# --------------------------------------------------------------------------
def make_blocks(nsnp: int, max_blk_sz: int = 10000) -> np.ndarray:
    """Upper-triangular block-pair list [(from_s, from_e, to_s, to_e)],
    1-based inclusive (reference: make_blocks, R/computePairwiseMI.R:147-165).
    """
    part1 = int(np.ceil(nsnp / max_blk_sz))
    from_s = [(i - 1) * max_blk_sz + 1 for i in range(1, part1 + 1)]
    from_e = [min(i * max_blk_sz, nsnp) for i in range(1, part1 + 1)]
    rows = []
    for i in range(part1):
        for j in range(i, part1):
            rows.append((from_s[i], from_e[i], from_s[j], from_e[j]))
    return np.array(rows, dtype=np.int64)


def round_blk_sz(max_blk_sz: int) -> int:
    """R `round(max_blk_sz, -3)` - nearest 1000, half-to-even
    (R/computePairwiseMI.R:69)."""
    return int(np.round(max_blk_sz / 1000.0) * 1000)


# --------------------------------------------------------------------------
# Distances
# --------------------------------------------------------------------------
def circular_len(pos1, pos2, g) -> np.ndarray:
    """Circular genome distance 0.5g - |(pos1-pos2) mod g - 0.5g|
    (R/computePairwiseMI.R:330)."""
    pos1 = np.asarray(pos1, dtype=_F64)
    pos2 = np.asarray(pos2, dtype=_F64)
    return 0.5 * g - np.abs(np.mod(pos1 - pos2, g) - 0.5 * g)


# --------------------------------------------------------------------------
# The RXY pseudocount tile (with exact R linear-aliasing compat mode)
# --------------------------------------------------------------------------
def rxy_term(r_f: np.ndarray, r_t: np.ndarray, compat: bool = True) -> np.ndarray:
    """[F,T] RXY tile.

    compat=True reproduces .fastHadamard's linear indexing of the
    transposed `rft` matrix (see module docstring); compat=False gives the
    mathematically-intended 0.25*outer(r_f, r_t).
    """
    A = 0.25 * np.outer(np.asarray(r_f, dtype=_F64), np.asarray(r_t, dtype=_F64))
    if not compat:
        return A
    F, T = A.shape
    flat = A.T.reshape(-1, order="F")  # column-major flatten of the [T,F] transpose
    return flat.reshape((F, T), order="F")


# --------------------------------------------------------------------------
# NumPy float64 oracle tile kernel
# --------------------------------------------------------------------------
def mi_tile_numpy(
    codes_f: np.ndarray,  # [F, S] uint8
    codes_t: np.ndarray,  # [T, S] uint8
    w: np.ndarray,  # [S] float64 hdw
    r_f: np.ndarray,
    r_t: np.ndarray,
    uq_f: np.ndarray,  # [F, 5]
    uq_t: np.ndarray,  # [T, 5]
    neff: float,
    rxy_compat: bool = True,
) -> np.ndarray:
    """Reference-exact MI tile in float64 (the test oracle)."""
    F, S = codes_f.shape
    T = codes_t.shape[0]
    w = np.asarray(w, dtype=_F64)
    r_f = np.asarray(r_f, dtype=_F64)
    r_t = np.asarray(r_t, dtype=_F64)

    wXf = [(codes_f == a).astype(_F64) * w for a in range(5)]
    Yt = [(codes_t == a).astype(_F64) for a in range(5)]
    pX = [m.sum(axis=1) for m in wXf]  # n_X(f)
    pY = [(y * w).sum(axis=1) for y in Yt]  # n_Y(t)

    den = neff + 0.5 * np.outer(r_f, r_t)  # R/computePairwiseMI.R:260
    RXY = rxy_term(r_f, r_t, compat=rxy_compat)
    mi = np.zeros((F, T), dtype=_F64)
    for x in range(5):  # from-allele outer, to-allele inner: R ordering :270-298
        pxr = pX[x] * (0.5 * r_f)  # pX*rX term (own-site r)
        for y in range(5):
            pxy = wXf[x] @ Yt[y].T + 0.5
            denom = (
                np.outer(pX[x], pY[y])
                + RXY
                + pxr[:, None]
                + (pY[y] * (0.5 * r_t))[None, :]
            )
            uq = np.outer(uq_f[:, x], uq_t[:, y]).astype(_F64)
            mi += uq * pxy / den * np.log(pxy / denom * den)
    return mi


# --------------------------------------------------------------------------
# PyTorch compat tile (the JAX package's XLA tile; the kernel tile of
# backend="pallas" lives in ops/compat_mi.py)
# --------------------------------------------------------------------------
def mi_tile_jax(
    codes_f,
    codes_t,
    w,
    r_f,
    r_t,
    uq_f,
    uq_t,
    neff,
    rxy_compat: bool = True,
    device_get: bool = True,
    device="cuda",
):
    """The compat MI tile in float32 on `device` -> [F, T] float64 with
    device_get, else the f32 tensor on the device; op for
    op as the JAX package's `mi_tile_jax`: 25 f32 products at full f32
    precision (TF32 off, as `resolve_device` sets it for every CUDA device:
    the counterpart of XLA's Precision.HIGHEST), then the epilogue.  The
    products are plain matrix products outside any
    kernel, so they go to torch.matmul."""
    dev = resolve_device(device)
    f32 = torch.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cf = t(codes_f)
    ct = t(codes_t)
    w32 = t(np.asarray(w, np.float32))
    rf32 = t(np.asarray(r_f, np.float32))
    rt32 = t(np.asarray(r_t, np.float32))
    uqf = t(np.asarray(uq_f, np.float32))
    uqt = t(np.asarray(uq_t, np.float32))
    rxy = t(rxy_term(r_f, r_t, compat=rxy_compat).astype(np.float32))
    neff32 = torch.tensor(np.float32(neff), dtype=f32, device=dev)
    wXf = [(cf == a).to(f32) * w32 for a in range(5)]
    Yt = [(ct == a).to(f32) for a in range(5)]
    pX = [m.sum(dim=1) for m in wXf]
    pY = [(y * w32).sum(dim=1) for y in Yt]
    den = neff32 + 0.5 * torch.outer(rf32, rt32)
    mi = torch.zeros((cf.shape[0], ct.shape[0]), dtype=f32, device=dev)
    for x in range(5):
        pxr = pX[x] * (0.5 * rf32)
        for y in range(5):
            pxy = wXf[x] @ Yt[y].T + 0.5
            denom = (
                torch.outer(pX[x], pY[y])
                + rxy
                + pxr[:, None]
                + (pY[y] * (0.5 * rt32))[None, :]
            )
            uq = torch.outer(uqf[:, x], uqt[:, y])
            mi = mi + uq * pxy / den * torch.log(pxy / denom * den)
    return mi.cpu().numpy().astype(_F64) if device_get else mi


# --------------------------------------------------------------------------
# Triangular pair extraction (column-major, as R `which(..., arr.ind=T)`)
# --------------------------------------------------------------------------
def tile_pair_indices(F: int, T: int, diagonal_block: bool):
    """(rows, cols) of emitted pairs, in the reference's emission order.

    Diagonal blocks: lower triangle i>j, column-major
    (R/computePairwiseMI.R:307).  Off-diagonal blocks: upper triangle then
    lower triangle, each column-major; in-block diagonal dropped
    (R/computePairwiseMI.R:309 - a reference quirk kept for parity).
    """
    if diagonal_block:
        # column-major over (i > j)
        cols, rows = np.meshgrid(np.arange(T), np.arange(F), indexing="xy")
        mask = rows > cols
        order = np.flatnonzero(mask.T.ravel())  # column-major enumeration
        j, i = np.unravel_index(order, (T, F))
        return i, j
    iu = []
    ju = []
    # upper.tri: i < j, column-major
    m = np.arange(F)[:, None] < np.arange(T)[None, :]
    order = np.flatnonzero(m.T.ravel())
    j, i = np.unravel_index(order, (T, F))
    iu.append(i)
    ju.append(j)
    # lower.tri: i > j, column-major
    m2 = np.arange(F)[:, None] > np.arange(T)[None, :]
    order2 = np.flatnonzero(m2.T.ravel())
    j2, i2 = np.unravel_index(order2, (T, F))
    iu.append(i2)
    ju.append(j2)
    return np.concatenate(iu), np.concatenate(ju)


# --------------------------------------------------------------------------
# LR link-count estimate (sets the constant per-block retention prob)
# --------------------------------------------------------------------------
def estimate_lr_links(
    pos: np.ndarray, g: int, sr_dist: int, r_compat: bool = True
) -> float:
    """Approximate total number of long-range pairs.

    r_compat=True replicates R/computePairwiseMI.R:92-101: a seeded
    (set.seed(1988)) 10% subsample of SNP positions, counting for each
    sampled position how many positions lie further than sr_dist away
    (circular), scaled up.  r_compat=False computes the exact count.
    """
    nsnp = pos.size

    def lr_counts(p_arr):
        # #positions farther than sr_dist (circular) = nsnp - window count;
        # the +-sr_dist window (inclusive) is counted on a doubled sorted
        # axis, O((n+m) log n) instead of the reference's O(n*m) scan
        qs = np.sort(pos)
        D = np.concatenate([qs, qs + g])
        a = ((p_arr - sr_dist - 1) % g) + 1
        lo = np.searchsorted(D, a, side="left")
        hi = np.searchsorted(D, a + 2 * sr_dist, side="right")
        return nsnp - (hi - lo)

    if r_compat:
        subset = min(nsnp, int(round(nsnp * 0.1)))
        rng = RRandomState(1988)
        picks = rng.sample_int(nsnp, subset) - 1  # 0-based
        total = int(lr_counts(pos[picks]).sum())
        return total / subset * nsnp / 2.0
    return int(lr_counts(pos).sum()) / 2.0


# --------------------------------------------------------------------------
# Link record container
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LinkTable:
    """Columnar link table (a data.frame stand-in)."""

    pos1: np.ndarray
    pos2: np.ndarray
    clust1: np.ndarray
    clust2: np.ndarray
    len: np.ndarray
    MI: np.ndarray

    def __len__(self):
        return self.pos1.size

    @classmethod
    def empty(cls):
        z = np.zeros(0)
        zi = np.zeros(0, dtype=np.int64)
        return cls(zi, zi.copy(), zi.copy(), zi.copy(), z, z.copy())

    @classmethod
    def concat(cls, tables: Sequence["LinkTable"]) -> "LinkTable":
        tables = [t for t in tables if len(t) > 0]
        if not tables:
            return cls.empty()
        return cls(
            *[
                np.concatenate([getattr(t, f.name) for t in tables])
                for f in dataclasses.fields(cls)
            ]
        )

    def take(self, idx) -> "LinkTable":
        return LinkTable(
            *[getattr(self, f.name)[idx] for f in dataclasses.fields(LinkTable)]
        )
