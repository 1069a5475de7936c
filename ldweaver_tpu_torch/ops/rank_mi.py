"""K1, the rank-compacted MI tile: wrapper of the CUDA kernel
(`csrc/rank_mi.cu`) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas_rank_mi.py`
(`_kernel_body`, reached through `mi_tile_rank_pallas`) and the pure
epilogue of `parallel/fast_sweep._rank_tile_mi` (fast_sweep.py:223-240).
The source note in `csrc/rank_mi.cu` states the design and its bound.

Both versions read the tile's rank codes straight from the resident
SEQUENCE-MAJOR code tensor `codes` [nseq, nsnp_pad] u8 at column offsets
`fs` (rows) and `ts` (columns), and take
  wparts [t, nseq] bf16  the first t (1 to 3) bf16 terms of the f32
                         Hamming weights (`n_terms` of the JAX kernel),
  px [Rf, nf] f32        weighted allele-rank marginals of the rows,
  py [Rt, nt] f32        the same for the columns,
  r_f [nf], r_t [nt] f32 distinct-allele counts,
  neff                   sum of the weights (rounded to f32),
and return the [nf, nt] f32 MI tile.  A CPU tensor goes to the plain
version; a CUDA tensor to the kernel (or the call raises).
`mi_tile_rank_pallas` is the JAX wrapper's host-facing counterpart.

`rank_mi_stage1` is K1's LR stage-1 form, for the LR sweep's tiles that
K2 does not take: the same tile under the LR mask, reduced in the kernel
to the max and first argmax of every 128-column chunk, as K2 does for the
(2, 2, pure) tiles, so only the [nf, nt/128] (value, column) pairs reach
device memory.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from ldweaver_tpu_torch.ops import cuda_build
from ldweaver_tpu_torch.support import resolve_device

N_TERMS = 3  # bf16 weight terms a kernel sums at most
CHUNK = 128  # stage-1 chunk width (pallas_fused_tile.py: chunk_c)


class LaunchCounter:
    """Kernel launches made through the wrapper: a plain integer, and the
    same count split by bucket (K1: (Rf, Rt, pure); K3: the tile shape)."""

    def __init__(self) -> None:
        self.launches = 0
        self.by_bucket = collections.Counter()

    def reset(self) -> None:
        self.launches = 0
        self.by_bucket.clear()


K1 = LaunchCounter()  # the store form, `rank_mi_tile`
K1_STAGE1 = LaunchCounter()  # the LR stage-1 form, `rank_mi_stage1`

_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Rf, Rt, pure
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nf, nt, S
    ctypes.c_void_p, ctypes.c_int,  # wparts, n_terms
    ctypes.c_void_p, ctypes.c_void_p,  # px, py
    ctypes.c_void_p, ctypes.c_void_p,  # r_f, r_t
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,  # neff, out, stream
]


# the store form's arguments up to neff, then the LR mask's and outputs
_STAGE1_ARGTYPES = _ARGTYPES[:17] + [
    ctypes.c_void_p, ctypes.c_void_p,  # pos_f, pos_t
    ctypes.c_void_p, ctypes.c_void_p,  # val_f, val_t
    ctypes.c_int, ctypes.c_int,  # same, g
    ctypes.c_float, ctypes.c_float,  # half_g, sr_dist
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # vals, cols, stream
]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rank_mi")
    for fn, types in ((lib.ldw_rank_mi_tile, _ARGTYPES),
                      (lib.ldw_rank_mi_stage1, _STAGE1_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def kernel_terms(wparts, what: str) -> int:
    """The weight terms t of a [t, S] `wparts` a kernel sums: 1 to 3, else
    ValueError."""
    t = wparts.shape[0] if wparts.dim() == 2 else 0
    if not 1 <= t <= N_TERMS:
        raise ValueError(f"{what}: wparts must hold 1 to {N_TERMS} weight terms,"
                         f" got shape {tuple(wparts.shape)}")
    return t


def check_inputs(what: str, codes, fs: int, ts: int, nf: int, nt: int,
                  wparts, n_terms: int, Rf: int, Rt: int, tensors) -> None:
    """Raise ValueError unless the (tensor, dtype, shape) triples lie on
    the code tensor's card, contiguous, the bucket within 1..5 and the
    tile's columns within the code tensor."""
    S, ld = codes.shape
    dev = codes.device
    checks = ((codes, torch.uint8, (S, ld)),
              (wparts, torch.bfloat16, (n_terms, S))) + tuple(tensors)
    for t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{what}: expected {dtype} {shape} on {dev}, got"
                f" {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if not (1 <= Rf <= 5 and 1 <= Rt <= 5):
        raise ValueError(f"{what}: (Rf, Rt) = ({Rf}, {Rt}) outside 1..5")
    if not (0 <= fs and fs + nf <= ld and 0 <= ts and ts + nt <= ld):
        raise ValueError(f"{what}: tile columns outside the code tensor")


def _tile_tensors(nf: int, nt: int, Rf: int, Rt: int, px, py, r_f, r_t):
    return ((px, torch.float32, (Rf, nf)), (py, torch.float32, (Rt, nt)),
            (r_f, torch.float32, (nf,)), (r_t, torch.float32, (nt,)))


def rank_mi_tile(codes, fs: int, ts: int, nf: int, nt: int, wparts, px, py,
                 r_f, r_t, neff: float, Rf: int, Rt: int,
                 pure: bool) -> torch.Tensor:
    """One [nf, nt] MI tile for the static bucket (Rf, Rt, pure)."""
    n_terms = kernel_terms(wparts, "rank_mi_tile")
    if codes.device.type == "cpu":
        return rank_mi_tile_reference(
            codes, fs, ts, nf, nt, wparts, px, py, r_f, r_t, neff, Rf, Rt,
            pure,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"rank_mi_tile: unsupported device {codes.device}")
    check_inputs("rank_mi_tile", codes, fs, ts, nf, nt, wparts, n_terms, Rf,
                  Rt, _tile_tensors(nf, nt, Rf, Rt, px, py, r_f, r_t))
    S, ld = codes.shape
    dev = codes.device
    out = torch.empty((nf, nt), dtype=torch.float32, device=dev)
    if nf == 0 or nt == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ldw_rank_mi_tile(
        Rf, Rt, int(bool(pure)), codes.data_ptr(), ld, fs, ts, nf, nt, S,
        wparts.data_ptr(), n_terms, px.data_ptr(), py.data_ptr(), r_f.data_ptr(),
        r_t.data_ptr(), float(neff), out.data_ptr(), stream,
    )
    cuda_build.check(lib, rc, "rank_mi_tile")
    K1.launches += 1
    K1.by_bucket[(Rf, Rt, bool(pure))] += 1
    return out


def rank_mi_stage1(codes, fs: int, ts: int, nf: int, nt: int, wparts, px, py,
                   r_f, r_t, neff: float, Rf: int, Rt: int, pure: bool,
                   pos_f, pos_t, val_f, val_t, same_block: bool, *, g: int,
                   sr_dist: int):
    """K1's LR stage-1 form: the [nf, nt] tile of the bucket (Rf, Rt, pure)
    under the LR mask of `fast_sweep.tile_masks` (positions pos_f [nf],
    pos_t [nt] i32; validity val_f, val_t bool; the triangle on a diagonal
    block pair), reduced to the max and first in-tile column attaining it
    of every 128-column chunk -> vals [nf, nt/128] f32, cols i32.  The
    values are those of `rank_mi_tile` and `chunk_max` bit for bit."""
    n_terms = kernel_terms(wparts, "rank_mi_stage1")
    if codes.device.type == "cpu":
        return rank_mi_stage1_reference(
            codes, fs, ts, nf, nt, wparts, px, py, r_f, r_t, neff, Rf, Rt,
            pure, pos_f, pos_t, val_f, val_t, same_block, g=g, sr_dist=sr_dist,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"rank_mi_stage1: unsupported device {codes.device}")
    check_inputs("rank_mi_stage1", codes, fs, ts, nf, nt, wparts, n_terms, Rf,
                  Rt, _tile_tensors(nf, nt, Rf, Rt, px, py, r_f, r_t) + (
                      (pos_f, torch.int32, (nf,)), (pos_t, torch.int32, (nt,)),
                      (val_f, torch.bool, (nf,)), (val_t, torch.bool, (nt,))))
    if nf <= 0 or nt <= 0 or nt % CHUNK:
        raise ValueError(
            f"rank_mi_stage1: nt = {nt} must be a positive multiple of {CHUNK}"
        )
    S, ld = codes.shape
    dev = codes.device
    vals = torch.empty((nf, nt // CHUNK), dtype=torch.float32, device=dev)
    cols = torch.empty((nf, nt // CHUNK), dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ldw_rank_mi_stage1(
        Rf, Rt, int(bool(pure)), codes.data_ptr(), ld, fs, ts, nf, nt, S,
        wparts.data_ptr(), n_terms, px.data_ptr(), py.data_ptr(), r_f.data_ptr(),
        r_t.data_ptr(), float(neff), pos_f.data_ptr(), pos_t.data_ptr(),
        val_f.data_ptr(), val_t.data_ptr(), int(bool(same_block)), int(g),
        0.5 * g, float(sr_dist), vals.data_ptr(), cols.data_ptr(), stream,
    )
    cuda_build.check(lib, rc, "rank_mi_stage1")
    K1_STAGE1.launches += 1
    K1_STAGE1.by_bucket[(Rf, Rt, bool(pure))] += 1
    return vals, cols


def chunk_max(masked, chunk: int = CHUNK):
    """Max and first in-tile column attaining it of every `chunk`-wide
    column chunk of a [nf, nt] tile (nt a multiple of `chunk`); an all
    -inf chunk reports its first column, as jnp.argmax does."""
    nf, nt = masked.shape
    nch = nt // chunk
    resh = masked.reshape(nf, nch, chunk)
    m = resh.amax(dim=-1)
    iota = torch.arange(chunk, device=masked.device)
    first = torch.where(resh == m[..., None], iota, chunk).amin(dim=-1)
    base = torch.arange(nch, device=masked.device)[None, :] * chunk
    return m, (base + first).to(torch.int32)


def rank_mi_stage1_reference(codes, fs: int, ts: int, nf: int, nt: int, wparts,
                             px, py, r_f, r_t, neff: float, Rf: int, Rt: int,
                             pure: bool, pos_f, pos_t, val_f, val_t,
                             same_block: bool, *, g: int, sr_dist: int,
                             dtype=torch.float32):
    """Plain PyTorch LR stage 1 (K1's stage-1 form, and K2 on (2, 2, pure)
    tiles): the plain tile, then the sweep's LR mask and the chunk max in
    torch ops, computed in `dtype` (float32 as the kernels; float64 gives
    the exact tile of the same inputs)."""
    # imported here: the sweep module imports this one
    from ldweaver_tpu_torch.parallel.fast_sweep import tile_masks

    mi = rank_mi_tile_reference(
        codes, fs, ts, nf, nt, wparts, px, py, r_f, r_t, neff, Rf, Rt, pure,
        dtype=dtype,
    )
    _, lr_ok = tile_masks(pos_f, pos_t, val_f, val_t, same_block, g, sr_dist)
    return chunk_max(torch.where(lr_ok, mi, float("-inf")))


def rank_mi_tile_reference(codes, fs: int, ts: int, nf: int, nt: int, wparts,
                           px, py, r_f, r_t, neff: float, Rf: int, Rt: int,
                           pure: bool, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K1, op for op as `fast_sweep._rank_tile_mi` of the JAX
    package: per (x, y) rank pair one product of the [nf, tS] weighted
    one-hot (the t bf16 terms of `wparts` side by side) with the [nt, tS]
    one-hot,
    in f32 (bf16 values are exact in f32, so this equals a bf16 product
    with f32 accumulation), then marginal closure and the epilogue.  With
    dtype=torch.float64 every step runs in float64 instead: the exact
    tile of the same inputs, which a kernel is held against on the card."""
    dev = codes.device
    cf = codes[:, fs : fs + nf].T
    ct = codes[:, ts : ts + nt].T
    neff_t = torch.tensor(neff, dtype=dtype, device=dev)
    px, py = px.to(dtype), py.to(dtype)
    r_f, r_t = r_f.to(dtype), r_t.to(dtype)
    pX = [px[x] for x in range(Rf)]
    pY = [py[y] for y in range(Rt)]

    counts = {}
    if Rf == 1:
        # degenerate: every from-site is monomorphic -> n_0y(f,t) = n_y(t)
        for y in range(Rt):
            counts[(0, y)] = pY[y][None, :].expand(nf, nt)
    elif Rt == 1:
        for x in range(Rf):
            counts[(x, 0)] = pX[x][:, None].expand(nf, nt)
    else:
        wp = wparts.to(dtype)
        zero = torch.zeros((), dtype=dtype, device=dev)
        rhs_cat = [
            torch.cat([(ct == y).to(dtype)] * len(wp), dim=1)
            for y in range(Rt - 1)
        ]
        for x in range(Rf - 1):
            onehot_f = cf == x
            lhs_cat = torch.cat(
                [torch.where(onehot_f, wp_t[None, :], zero) for wp_t in wp],
                dim=1,
            )
            for y in range(Rt - 1):
                counts[(x, y)] = lhs_cat @ rhs_cat[y].T
        # marginal closure for the last column / row / corner
        for x in range(Rf - 1):
            s = counts[(x, 0)]
            for y in range(1, Rt - 1):
                s = s + counts[(x, y)]
            counts[(x, Rt - 1)] = pX[x][:, None] - s
        for y in range(Rt):
            s = counts[(0, y)]
            for x in range(1, Rf - 1):
                s = s + counts[(x, y)]
            counts[(Rf - 1, y)] = pY[y][None, :] - s

    if pure and Rf >= 2 and Rt >= 2:
        den_s = neff_t + 0.5 * Rf * Rt
        logden = torch.log(den_s)
        invden = 1.0 / den_s
        ent = torch.zeros((nf, nt), dtype=dtype, device=dev)
        for x in range(Rf):
            for y in range(Rt):
                pxy = counts[(x, y)] + 0.5
                ent = ent + pxy * torch.log(pxy)
        lx = torch.zeros((nf,), dtype=dtype, device=dev)
        for x in range(Rf):
            px_s = pX[x] + 0.5 * Rt
            lx = lx + torch.log(px_s) * px_s
        ly = torch.zeros((nt,), dtype=dtype, device=dev)
        for y in range(Rt):
            py_s = pY[y] + 0.5 * Rf
            ly = ly + torch.log(py_s) * py_s
        return (ent - lx[:, None] - ly[None, :] + den_s * logden) * invden

    rr = torch.outer(r_f, r_t)
    den = neff_t + 0.5 * rr
    rxy = 0.25 * rr
    mi = torch.zeros((nf, nt), dtype=dtype, device=dev)
    for x in range(Rf):
        gate_x = (x < r_f).to(dtype)
        pxr = pX[x] * (0.5 * r_f)
        for y in range(Rt):
            pxy = counts[(x, y)] + 0.5
            denom = (
                torch.outer(pX[x], pY[y])
                + rxy
                + pxr[:, None]
                + (pY[y] * (0.5 * r_t))[None, :]
            )
            uq = torch.outer(gate_x, (y < r_t).to(dtype))
            mi = mi + uq * pxy / den * torch.log(pxy / denom * den)
    return mi


def pair_codes(codes_f, codes_t, device):
    """One SEQUENCE-MAJOR u8 code tensor on `device` holding the site-major
    row codes [F, S] from column 0 and the column codes [T, S] from the
    next multiple of 16 -> (codes, ts).  Its rows are a multiple of 16 long
    (the zero columns between are read by no tile), so a kernel stages
    every tile with 16-byte copies."""
    F, S = codes_f.shape
    T = codes_t.shape[0]
    ts = -(-F // 16) * 16
    codes = np.zeros((S, ts + -(-T // 16) * 16), np.uint8)
    codes[:, :F] = codes_f.T
    codes[:, ts : ts + T] = codes_t.T
    return torch.from_numpy(codes).to(device), ts


def mi_tile_rank_pallas(rank_codes_f: np.ndarray, rank_codes_t: np.ndarray,
                        w: np.ndarray, r_f: np.ndarray, r_t: np.ndarray,
                        neff: float, n_terms: int = 3, device_get: bool = True,
                        device="cuda"):
    """Host-facing K1 with the JAX wrapper's signature and host preparation
    (pallas_rank_mi.py:183-233): site-major rank codes [F, S] / [T, S], the
    general epilogue of the bucket (max r_f, max r_t), the `n_terms`-term
    bf16 split of the f32 weights, f32 marginals from float64 sums.  The
    TPU tile sizes (`tile_f`, `tile_t`, `chunk_s`) are not parameters: the
    kernel picks its own.  -> [F, T] float64 with device_get, else the f32
    tensor on the device.  On device="cpu" the tile comes from the plain
    version."""
    from ldweaver_tpu_torch.parallel.fast_sweep import split_terms

    dev = resolve_device(device)
    F, T = rank_codes_f.shape[0], rank_codes_t.shape[0]
    Rf, Rt = int(np.asarray(r_f).max()), int(np.asarray(r_t).max())
    w = np.asarray(w, np.float64)
    px = np.stack([((rank_codes_f == x) * w).sum(axis=1) for x in range(Rf)])
    py = np.stack([((rank_codes_t == y) * w).sum(axis=1) for y in range(Rt)])
    codes, ts = pair_codes(rank_codes_f, rank_codes_t, dev)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    out = rank_mi_tile(
        codes, 0, ts, F, T, split_terms(w, n_terms).to(dev), f32(px), f32(py),
        f32(r_f), f32(r_t), float(np.float32(neff)), Rf, Rt, False,
    )
    return out.cpu().numpy().astype(np.float64) if device_get else out
