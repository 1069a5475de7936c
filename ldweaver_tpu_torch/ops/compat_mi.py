"""K3, the 25-allele compat MI tile: wrapper of the CUDA kernel
(`csrc/compat_mi.cu`) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas_mi.py`
(`_kernel_body`, reached through `mi_tile_pallas`), the tile of
`backend="pallas"`: weighted contingency counts over the ACGTN codes, the
full epilogue with the uq gates and own-site marginal pseudocounts, and the
RXY tile as an input (the reference's linear alias with `rxy_compat`).
The source note in `csrc/compat_mi.cu` states the design and its bound.

`mi_tile_pallas` keeps the JAX wrapper's host-facing signature (site-major
numpy codes [F, S] / [T, S], float64 weights) and its host preparation:
the bf16 weight split, f32 marginals from float64 sums, f32 r / uq and the
RXY tile from `rxy_term`.  The tile sizes of the TPU wrapper (`tile_f`,
`tile_t`, `chunk_s`) are not parameters here: the kernel picks its own;
nor is `n_terms`: the kernel always sums the three bf16 weight terms.
`compat_mi_tile` takes those inputs as tensors; a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (or the call raises).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldweaver_tpu_torch.core.mi import rxy_term
from ldweaver_tpu_torch.ops import cuda_build
from ldweaver_tpu_torch.ops.rank_mi import N_TERMS, LaunchCounter
from ldweaver_tpu_torch.parallel.fast_sweep import wparts
from ldweaver_tpu_torch.support import resolve_device

N_ALLELES = 5

K3 = LaunchCounter()

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nf, nt, S
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # wparts, px, py
    ctypes.c_void_p, ctypes.c_void_p,  # r_f, r_t
    ctypes.c_void_p, ctypes.c_void_p,  # uq_f, uq_t
    ctypes.c_float, ctypes.c_void_p,  # neff, rxy
    ctypes.c_void_p, ctypes.c_void_p,  # out, stream
]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("compat_mi")
    fn = lib.ldw_compat_mi_tile
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def compat_mi_tile(codes, fs: int, ts: int, nf: int, nt: int, wparts, px, py,
                   r_f, r_t, uq_f, uq_t, neff: float, rxy) -> torch.Tensor:
    """One [nf, nt] f32 compat MI tile.  `codes` is a SEQUENCE-MAJOR
    [nseq, ld] u8 tensor of ACGTN codes (rows: columns fs..fs+nf, columns:
    ts..ts+nt); px, py, uq_f, uq_t are [5, n] f32, r_f / r_t [n] f32, rxy
    the [nf, nt] f32 RXY tile."""
    if codes.device.type == "cpu":
        return compat_mi_tile_reference(
            codes, fs, ts, nf, nt, wparts, px, py, r_f, r_t, uq_f, uq_t, neff,
            rxy,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"compat_mi_tile: unsupported device {codes.device}")
    S, ld = codes.shape
    dev = codes.device
    checks = (
        (codes, torch.uint8, (S, ld)),
        (wparts, torch.bfloat16, (N_TERMS, S)),
        (px, torch.float32, (N_ALLELES, nf)),
        (py, torch.float32, (N_ALLELES, nt)),
        (r_f, torch.float32, (nf,)),
        (r_t, torch.float32, (nt,)),
        (uq_f, torch.float32, (N_ALLELES, nf)),
        (uq_t, torch.float32, (N_ALLELES, nt)),
        (rxy, torch.float32, (nf, nt)),
    )
    for t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"compat_mi_tile: expected {dtype} {shape} on {dev}, got"
                f" {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("compat_mi_tile: inputs must be contiguous")
    if not (0 <= fs and fs + nf <= ld and 0 <= ts and ts + nt <= ld):
        raise ValueError("compat_mi_tile: tile columns outside the code tensor")
    out = torch.empty((nf, nt), dtype=torch.float32, device=dev)
    if nf == 0 or nt == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ldw_compat_mi_tile(
        codes.data_ptr(), ld, fs, ts, nf, nt, S, wparts.data_ptr(),
        px.data_ptr(), py.data_ptr(), r_f.data_ptr(), r_t.data_ptr(),
        uq_f.data_ptr(), uq_t.data_ptr(), float(neff), rxy.data_ptr(),
        out.data_ptr(), stream,
    )
    cuda_build.check(lib, rc, "compat_mi_tile")
    K3.launches += 1
    K3.by_bucket[(nf, nt)] += 1
    return out


def compat_mi_tile_reference(codes, fs: int, ts: int, nf: int, nt: int,
                             wparts, px, py, r_f, r_t, uq_f, uq_t,
                             neff: float, rxy,
                             dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K3, op for op as `pallas_mi._kernel_body`: all 25
    count planes as f32 products of the [nf, 3S] weighted one-hot (the
    three bf16 terms side by side) with the [nt, 3S] one-hot, then the
    epilogue.  With dtype=torch.float64 every step runs in float64: the
    exact tile of the same inputs, which the kernel is held against on
    the card."""
    dev = codes.device
    px, py, r_f, r_t = (a.to(dtype) for a in (px, py, r_f, r_t))
    uq_f, uq_t, rxy = (a.to(dtype) for a in (uq_f, uq_t, rxy))
    cf = codes[:, fs : fs + nf].T
    ct = codes[:, ts : ts + nt].T
    wp = wparts.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    rhs = [torch.cat([(ct == y).to(dtype)] * N_TERMS, dim=1)
           for y in range(N_ALLELES)]
    neff_t = torch.tensor(neff, dtype=dtype, device=dev)
    den = neff_t + 0.5 * r_f[:, None] * r_t[None, :]
    mi = torch.zeros((nf, nt), dtype=dtype, device=dev)
    for x in range(N_ALLELES):
        onehot_f = cf == x
        lhs = torch.cat(
            [torch.where(onehot_f, wp[t][None, :], zero) for t in range(N_TERMS)],
            dim=1,
        )
        pxr = px[x] * (0.5 * r_f)
        for y in range(N_ALLELES):
            pxy = lhs @ rhs[y].T + 0.5
            denom = (
                px[x][:, None] * py[y][None, :]
                + rxy
                + pxr[:, None]
                + (py[y] * (0.5 * r_t))[None, :]
            )
            uq = uq_f[x][:, None] * uq_t[y][None, :]
            mi = mi + uq * pxy / den * torch.log(pxy / denom * den)
    return mi


def tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff,
                rxy_compat=True, device="cuda"):
    """`compat_mi_tile`'s operands on `device`, prepared on the host exactly
    as the JAX wrapper prepares them (pallas_mi.py:176-215).  The code
    tensor holds the row SNPs from column 0 and the column SNPs from the
    next multiple of 16, and its rows are a multiple of 16 long (the zero
    columns between are read by no tile), so the kernel stages every tile
    with 16-byte copies."""
    dev = resolve_device(device)
    F, S = codes_f.shape
    T = codes_t.shape[0]
    _, parts = wparts(np.asarray(w, np.float32))
    pxf = np.zeros((N_ALLELES, F), np.float32)
    pyf = np.zeros((N_ALLELES, T), np.float32)
    for a in range(N_ALLELES):
        pxf[a] = ((codes_f == a) * w).sum(axis=1)
        pyf[a] = ((codes_t == a) * w).sum(axis=1)
    ts = -(-F // 16) * 16
    codes = np.zeros((S, ts + -(-T // 16) * 16), np.uint8)
    codes[:, :F] = codes_f.T
    codes[:, ts : ts + T] = codes_t.T

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return (
        t(codes, torch.uint8), 0, ts, F, T, parts.to(dev).contiguous(),
        t(pxf), t(pyf), t(np.asarray(r_f, np.float32)),
        t(np.asarray(r_t, np.float32)), t(np.asarray(uq_f, np.float32).T),
        t(np.asarray(uq_t, np.float32).T), float(np.float32(neff)),
        t(rxy_term(r_f, r_t, compat=rxy_compat).astype(np.float32)),
    )


def mi_tile_pallas(codes_f: np.ndarray, codes_t: np.ndarray, w: np.ndarray,
                   r_f: np.ndarray, r_t: np.ndarray, uq_f: np.ndarray,
                   uq_t: np.ndarray, neff: float, rxy_compat: bool = True,
                   device="cuda") -> np.ndarray:
    """Host-facing K3 with the JAX wrapper's signature -> [F, T] float64.
    On device="cpu" the tile comes from the plain version."""
    args = tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff,
                       rxy_compat, device)
    return compat_mi_tile(*args).cpu().numpy().astype(np.float64)


def mi_tile_pallas_reference(codes_f: np.ndarray, codes_t: np.ndarray,
                             w: np.ndarray, r_f: np.ndarray, r_t: np.ndarray,
                             uq_f: np.ndarray, uq_t: np.ndarray, neff: float,
                             rxy_compat: bool = True,
                             device="cuda") -> np.ndarray:
    """`mi_tile_pallas` through the plain version on `device`."""
    args = tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff,
                       rxy_compat, device)
    return compat_mi_tile_reference(*args).cpu().numpy().astype(np.float64)
