"""K2, the fused LR stage-1 tile: wrapper of the CUDA kernel
(`csrc/fused_tile.cu`) and its plain PyTorch version.

Replaces the JAX package's Pallas kernel `ops/pallas_fused_tile.py`
(`_kernel_body`, reached through `fused_tile_stage1`): for an r-pure
biallelic block pair (Rf = Rt = 2) the rank-MI tile with its telescoped
epilogue, the LR mask (triangle, validity, f32 circular length above
sr_dist) and the max and first-index argmax of every 128-column chunk, so
only [nf, nt/128] (value, in-tile column) pairs reach device memory.  The
source note in `csrc/fused_tile.cu` states the design and its bound.

Both versions read the tile's rank codes straight from the resident
SEQUENCE-MAJOR code tensor `codes` [nseq, nsnp_pad] u8 at column offsets
`fs` (rows) and `ts` (columns), and take
  wparts [t, nseq] bf16      the first t (1 to 3) bf16 terms of the f32
                             weights (rows: the JAX kernel's seq-major
                             [S, n_terms] transposed),
  px [2, nf], py [2, nt] f32 weighted allele-rank marginals,
  pos_f [nf], pos_t [nt] i32 genome positions,
  val_f [nf], val_t [nt]     bool, False on pad sites,
  neff                       sum of the weights (rounded to f32),
  same_block                 True on a diagonal block pair.
A CPU tensor goes to the plain version; a CUDA tensor to the kernel (or
the call raises).
"""

from __future__ import annotations

import ctypes

import torch

from ldweaver_tpu_torch.ops import cuda_build
from ldweaver_tpu_torch.ops.rank_mi import (  # noqa: F401 (chunk_max: re-export)
    CHUNK,
    LaunchCounter,
    check_inputs,
    chunk_max,
    kernel_terms,
    rank_mi_stage1_reference,
)

K2 = LaunchCounter()

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nf, nt, S
    ctypes.c_void_p, ctypes.c_int,  # wparts, n_terms
    ctypes.c_void_p, ctypes.c_void_p,  # px, py
    ctypes.c_void_p, ctypes.c_void_p,  # pos_f, pos_t
    ctypes.c_void_p, ctypes.c_void_p,  # val_f, val_t
    ctypes.c_float, ctypes.c_int, ctypes.c_int,  # neff, same, g
    ctypes.c_float, ctypes.c_float,  # half_g, sr_dist
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # vals, cols, stream
]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_tile")
    fn = lib.ldw_fused_tile_stage1
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def fused_tile_stage1(codes, fs: int, ts: int, nf: int, nt: int, wparts, px,
                      py, pos_f, pos_t, val_f, val_t, neff: float,
                      same_block: bool, *, g: int, sr_dist: int):
    """Stage-1 candidates of one (2, 2, pure) tile: vals [nf, nt/128] f32
    and in-tile cols [nf, nt/128] i32."""
    n_terms = kernel_terms(wparts, "fused_tile_stage1")
    if codes.device.type == "cpu":
        return fused_tile_stage1_reference(
            codes, fs, ts, nf, nt, wparts, px, py, pos_f, pos_t, val_f,
            val_t, neff, same_block, g=g, sr_dist=sr_dist,
        )
    if codes.device.type != "cuda":
        raise ValueError(f"fused_tile_stage1: unsupported device {codes.device}")
    check_inputs("fused_tile_stage1", codes, fs, ts, nf, nt, wparts, n_terms,
                  2, 2, ((px, torch.float32, (2, nf)), (py, torch.float32, (2, nt)),
                         (pos_f, torch.int32, (nf,)), (pos_t, torch.int32, (nt,)),
                         (val_f, torch.bool, (nf,)), (val_t, torch.bool, (nt,))))
    if nf <= 0 or nt <= 0 or nt % CHUNK:
        raise ValueError(
            f"fused_tile_stage1: nt = {nt} must be a positive multiple of {CHUNK}"
        )
    S, ld = codes.shape
    dev = codes.device
    vals = torch.empty((nf, nt // CHUNK), dtype=torch.float32, device=dev)
    cols = torch.empty((nf, nt // CHUNK), dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ldw_fused_tile_stage1(
        codes.data_ptr(), ld, fs, ts, nf, nt, S, wparts.data_ptr(), n_terms,
        px.data_ptr(), py.data_ptr(), pos_f.data_ptr(), pos_t.data_ptr(),
        val_f.data_ptr(), val_t.data_ptr(), float(neff), int(bool(same_block)),
        int(g), 0.5 * g, float(sr_dist), vals.data_ptr(), cols.data_ptr(),
        stream,
    )
    cuda_build.check(lib, rc, "fused_tile_stage1")
    K2.launches += 1
    return vals, cols


def fused_tile_stage1_reference(codes, fs: int, ts: int, nf: int, nt: int,
                                wparts, px, py, pos_f, pos_t, val_f, val_t,
                                neff: float, same_block: bool, *, g: int,
                                sr_dist: int, dtype=torch.float32):
    """Plain PyTorch K2: K1's plain (2, 2, pure) tile, then the sweep's LR
    mask and the chunk max in torch ops (`rank_mi_stage1_reference`),
    computed in `dtype` (float32 as the kernel; float64 gives the exact
    tile of the same inputs)."""
    two_f = torch.full((nf,), 2.0, dtype=dtype, device=codes.device)
    two_t = torch.full((nt,), 2.0, dtype=dtype, device=codes.device)
    return rank_mi_stage1_reference(
        codes, fs, ts, nf, nt, wparts, px, py, two_f, two_t, neff, 2, 2, True,
        pos_f, pos_t, val_f, val_t, same_block, g=g, sr_dist=sr_dist,
        dtype=dtype,
    )
