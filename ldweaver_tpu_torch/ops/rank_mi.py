"""K1, the rank-compacted MI tile: wrapper of the CUDA kernel
(`csrc/rank_mi.cu`) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas_rank_mi.py`
(`_kernel_body`, reached through `mi_tile_rank_pallas`) and the pure
epilogue of `parallel/fast_sweep._rank_tile_mi` (fast_sweep.py:223-240).
The source note in `csrc/rank_mi.cu` states the design and its bound.

Both versions read the tile's rank codes straight from the resident
SEQUENCE-MAJOR code tensor `codes` [nseq, nsnp_pad] u8 at column offsets
`fs` (rows) and `ts` (columns), and take
  wparts [3, nseq] bf16  the three bf16 terms of the f32 Hamming weights,
  px [Rf, nf] f32        weighted allele-rank marginals of the rows,
  py [Rt, nt] f32        the same for the columns,
  r_f [nf], r_t [nt] f32 distinct-allele counts,
  neff                   sum of the weights (rounded to f32),
and return the [nf, nt] f32 MI tile.  A CPU tensor goes to the plain
version; a CUDA tensor to the kernel (or the call raises).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ldweaver_tpu_torch.ops import cuda_build

N_TERMS = 3


class LaunchCounter:
    """Kernel launches made through the wrapper: a plain integer, and the
    same count split by bucket (K1: (Rf, Rt, pure); K3: the tile shape)."""

    def __init__(self) -> None:
        self.launches = 0
        self.by_bucket = collections.Counter()

    def reset(self) -> None:
        self.launches = 0
        self.by_bucket.clear()


K1 = LaunchCounter()

_ARGTYPES = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Rf, Rt, pure
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nf, nt, S
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # wparts, px, py
    ctypes.c_void_p, ctypes.c_void_p,  # r_f, r_t
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,  # neff, out, stream
]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rank_mi")
    fn = lib.ldw_rank_mi_tile
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def rank_mi_tile(codes, fs: int, ts: int, nf: int, nt: int, wparts, px, py,
                 r_f, r_t, neff: float, Rf: int, Rt: int,
                 pure: bool) -> torch.Tensor:
    """One [nf, nt] MI tile for the static bucket (Rf, Rt, pure)."""
    if codes.device.type == "cpu":
        return rank_mi_tile_reference(
            codes, fs, ts, nf, nt, wparts, px, py, r_f, r_t, neff, Rf, Rt,
            pure,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"rank_mi_tile: unsupported device {codes.device}")
    S, ld = codes.shape
    dev = codes.device
    checks = (
        (codes, torch.uint8, (S, ld)),
        (wparts, torch.bfloat16, (N_TERMS, S)),
        (px, torch.float32, (Rf, nf)),
        (py, torch.float32, (Rt, nt)),
        (r_f, torch.float32, (nf,)),
        (r_t, torch.float32, (nt,)),
    )
    for t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"rank_mi_tile: expected {dtype} {shape} on {dev}, got"
                f" {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("rank_mi_tile: inputs must be contiguous")
    if not (1 <= Rf <= 5 and 1 <= Rt <= 5):
        raise ValueError(f"rank_mi_tile: (Rf, Rt) = ({Rf}, {Rt}) outside 1..5")
    if not (0 <= fs and fs + nf <= ld and 0 <= ts and ts + nt <= ld):
        raise ValueError("rank_mi_tile: tile columns outside the code tensor")
    out = torch.empty((nf, nt), dtype=torch.float32, device=dev)
    if nf == 0 or nt == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ldw_rank_mi_tile(
        Rf, Rt, int(bool(pure)), codes.data_ptr(), ld, fs, ts, nf, nt, S,
        wparts.data_ptr(), px.data_ptr(), py.data_ptr(), r_f.data_ptr(),
        r_t.data_ptr(), float(neff), out.data_ptr(), stream,
    )
    cuda_build.check(lib, rc, "rank_mi_tile")
    K1.launches += 1
    K1.by_bucket[(Rf, Rt, bool(pure))] += 1
    return out


def rank_mi_tile_reference(codes, fs: int, ts: int, nf: int, nt: int, wparts,
                           px, py, r_f, r_t, neff: float, Rf: int, Rt: int,
                           pure: bool, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K1, op for op as `fast_sweep._rank_tile_mi` of the JAX
    package: per (x, y) rank pair one product of the [nf, 3S] weighted
    one-hot (the three bf16 terms side by side) with the [nt, 3S] one-hot,
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
            torch.cat([(ct == y).to(dtype)] * N_TERMS, dim=1)
            for y in range(Rt - 1)
        ]
        for x in range(Rf - 1):
            onehot_f = cf == x
            lhs_cat = torch.cat(
                [torch.where(onehot_f, wp[t][None, :], zero)
                 for t in range(N_TERMS)],
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
