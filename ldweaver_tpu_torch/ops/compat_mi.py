"""K3, the 25-allele compat MI tile: wrapper of the CUDA kernel
(`csrc/compat_mi.cu`) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas_mi.py`
(`_kernel_body`, reached through `mi_tile_pallas`), the tile of
`backend="pallas"`: weighted contingency counts over the ACGTN codes, the
full epilogue with the uq gates and own-site marginal pseudocounts, and the
RXY tile as an input (the reference's linear alias with `rxy_compat`).
The source note in `csrc/compat_mi.cu` states the design and its bound.

`mi_tile_pallas` keeps the JAX wrapper's host-facing signature (site-major
numpy codes [F, S] / [T, S], float64 weights, `n_terms`, `device_get`) and
its host preparation: the `n_terms`-term bf16 weight split, f32 marginals
from float64 sums, f32 r / uq and the RXY tile from `rxy_term`.  The tile
sizes of the TPU wrapper (`tile_f`, `tile_t`, `chunk_s`) are not
parameters here: the kernel picks its own.  `compat_mi_tile` takes those
inputs as tensors (wparts [t, nseq], t = 1 to 3); a CPU tensor goes to the
plain version, a CUDA tensor to the kernel (or the call raises).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldweaver_tpu_torch.core.mi import rxy_term
from ldweaver_tpu_torch.ops import cuda_build
from ldweaver_tpu_torch.ops.rank_mi import LaunchCounter, kernel_terms, pair_codes
from ldweaver_tpu_torch.parallel.fast_sweep import split_terms
from ldweaver_tpu_torch.support import resolve_device

N_ALLELES = 5

K3 = LaunchCounter()

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nf, nt, S
    ctypes.c_void_p, ctypes.c_int,  # wparts, n_terms
    ctypes.c_void_p, ctypes.c_void_p,  # px, py
    ctypes.c_void_p, ctypes.c_void_p,  # r_f, r_t
    ctypes.c_void_p, ctypes.c_void_p,  # uq_f, uq_t
    ctypes.c_float, ctypes.c_void_p,  # neff, rxy
    ctypes.c_void_p, ctypes.c_void_p,  # pxc, pyc
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
                   r_f, r_t, uq_f, uq_t, neff: float, rxy, pxc=None,
                   pyc=None) -> torch.Tensor:
    """One [nf, nt] f32 compat MI tile.  `codes` is a SEQUENCE-MAJOR
    [nseq, ld] u8 tensor of ACGTN codes (rows: columns fs..fs+nf, columns:
    ts..ts+nt); px, py, uq_f, uq_t are [5, n] f32, r_f / r_t [n] f32, rxy
    the [nf, nt] f32 RXY tile.  pxc / pyc [5, n] f32 are the allele counts
    under the summed terms of `wparts`, with which the kernel closes the
    fifth row and column (the plain version counts all 25 planes); by
    default px / py, which they equal when the terms sum to the f32
    weights px / py were summed from (three terms)."""
    pxc = px if pxc is None else pxc
    pyc = py if pyc is None else pyc
    n_terms = kernel_terms(wparts, "compat_mi_tile")
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
        (wparts, torch.bfloat16, (n_terms, S)),
        (px, torch.float32, (N_ALLELES, nf)),
        (py, torch.float32, (N_ALLELES, nt)),
        (r_f, torch.float32, (nf,)),
        (r_t, torch.float32, (nt,)),
        (uq_f, torch.float32, (N_ALLELES, nf)),
        (uq_t, torch.float32, (N_ALLELES, nt)),
        (rxy, torch.float32, (nf, nt)),
        (pxc, torch.float32, (N_ALLELES, nf)),
        (pyc, torch.float32, (N_ALLELES, nt)),
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
        codes.data_ptr(), ld, fs, ts, nf, nt, S, wparts.data_ptr(), n_terms,
        px.data_ptr(), py.data_ptr(), r_f.data_ptr(), r_t.data_ptr(),
        uq_f.data_ptr(), uq_t.data_ptr(), float(neff), rxy.data_ptr(),
        pxc.data_ptr(), pyc.data_ptr(), out.data_ptr(), stream,
    )
    cuda_build.check(lib, rc, "compat_mi_tile")
    K3.launches += 1
    K3.by_bucket[(nf, nt)] += 1
    return out


def compat_mi_tile_reference(codes, fs: int, ts: int, nf: int, nt: int,
                             wparts, px, py, r_f, r_t, uq_f, uq_t,
                             neff: float, rxy, pxc=None, pyc=None,
                             dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch K3, op for op as `pallas_mi._kernel_body`: all 25
    count planes as f32 products of the [nf, tS] weighted one-hot (the t
    bf16 terms of `wparts` side by side) with the [nt, tS] one-hot, then
    the epilogue (the kernel's closure marginals pxc / pyc are not
    needed).  With dtype=torch.float64 every step runs in float64: the
    exact tile of the same inputs, which the kernel is held against on
    the card."""
    dev = codes.device
    px, py, r_f, r_t = (a.to(dtype) for a in (px, py, r_f, r_t))
    uq_f, uq_t, rxy = (a.to(dtype) for a in (uq_f, uq_t, rxy))
    cf = codes[:, fs : fs + nf].T
    ct = codes[:, ts : ts + nt].T
    wp = wparts.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    rhs = [torch.cat([(ct == y).to(dtype)] * len(wp), dim=1)
           for y in range(N_ALLELES)]
    neff_t = torch.tensor(neff, dtype=dtype, device=dev)
    den = neff_t + 0.5 * r_f[:, None] * r_t[None, :]
    mi = torch.zeros((nf, nt), dtype=dtype, device=dev)
    for x in range(N_ALLELES):
        onehot_f = cf == x
        lhs = torch.cat(
            [torch.where(onehot_f, wp_t[None, :], zero) for wp_t in wp],
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
                rxy_compat=True, n_terms=3, device="cuda"):
    """`compat_mi_tile`'s operands on `device`, prepared on the host exactly
    as the JAX wrapper prepares them (pallas_mi.py:176-215), the code
    tensor from `rank_mi.pair_codes`, and the kernel's closure marginals:
    the allele counts under the summed weight terms."""
    dev = resolve_device(device)
    parts = split_terms(np.asarray(w, np.float32), n_terms)
    w_terms = parts.double().sum(0).numpy()

    def counts(c, weights):
        return np.stack([((c == a) * weights).sum(axis=1)
                         for a in range(N_ALLELES)]).astype(np.float32)

    codes, ts = pair_codes(codes_f, codes_t, dev)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    return (
        codes, 0, ts, codes_f.shape[0], codes_t.shape[0], parts.to(dev),
        t(counts(codes_f, w)), t(counts(codes_t, w)),
        t(np.asarray(r_f, np.float32)),
        t(np.asarray(r_t, np.float32)), t(np.asarray(uq_f, np.float32).T),
        t(np.asarray(uq_t, np.float32).T), float(np.float32(neff)),
        t(rxy_term(r_f, r_t, compat=rxy_compat).astype(np.float32)),
        t(counts(codes_f, w_terms)), t(counts(codes_t, w_terms)),
    )


def mi_tile_pallas(codes_f: np.ndarray, codes_t: np.ndarray, w: np.ndarray,
                   r_f: np.ndarray, r_t: np.ndarray, uq_f: np.ndarray,
                   uq_t: np.ndarray, neff: float, rxy_compat: bool = True,
                   n_terms: int = 3, device_get: bool = True, device="cuda"):
    """Host-facing K3 with the JAX wrapper's signature -> [F, T] float64
    with device_get, else the f32 tensor on the device.  On device="cpu"
    the tile comes from the plain version."""
    args = tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff,
                       rxy_compat, n_terms, device)
    out = compat_mi_tile(*args)
    return out.cpu().numpy().astype(np.float64) if device_get else out


def mi_tile_pallas_reference(codes_f: np.ndarray, codes_t: np.ndarray,
                             w: np.ndarray, r_f: np.ndarray, r_t: np.ndarray,
                             uq_f: np.ndarray, uq_t: np.ndarray, neff: float,
                             rxy_compat: bool = True, n_terms: int = 3,
                             device_get: bool = True, device="cuda"):
    """`mi_tile_pallas` through the plain version on `device`."""
    args = tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff,
                       rxy_compat, n_terms, device)
    out = compat_mi_tile_reference(*args)
    return out.cpu().numpy().astype(np.float64) if device_get else out
