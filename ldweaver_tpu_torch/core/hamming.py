"""Hamming-distance sequence weights (population-structure correction).

Reference: `estimate_Hamming_distance_weights`
(R/performPopulationStuctureCorrection.R:20-81):

  shared[s,t] = sum_allele crossprod(M_allele)[s,t]   (shared-SNP counts)
  hdw[s] = 1 / ( #{t : nsnp - shared[s,t] < int(nsnp*threshold)} + 1 )

Notes replicated exactly:
  * thresh = as.integer(nsnp*threshold) - truncation (line 23);
  * strict '<' (line 76);
  * the count includes t == s (the diagonal of `shared` is nsnp because
    every site maps to exactly one of the five allele classes), so every
    sequence counts itself once and the +1 makes the self-weight 1/2 at
    minimum.

Device path: the five crossprods are five one-hot [nseq, nsnp] x
[nsnp, nseq] products on the r-stratified rank codes that BLK5 sweeps.
Equality counts are invariant under stratify's column permutation and its
per-site injective relabelling, and the `npad` zero pad columns match for
every pair, adding exactly npad to each count, which is subtracted back.
The products run in f32: 0/1 operands and integer counts below 2^24 are
exact there.
"""

from __future__ import annotations

import numpy as np
import torch

from ldweaver_tpu_torch.parallel.fast_sweep import stratify
from ldweaver_tpu_torch.parallel.spmd_sweep import fast_block_size
from ldweaver_tpu_torch.support import check_supported, resolve_devices


def hamming_weights_numpy(codes: np.ndarray, threshold: float = 0.1) -> np.ndarray:
    """float64 oracle; exact integer shared-SNP counts."""
    nseq, nsnp = codes.shape
    shared = np.zeros((nseq, nseq), dtype=np.int64)
    # blocked over SNPs to bound memory
    blk = 16384
    for s in range(0, nsnp, blk):
        cb = codes[:, s : s + blk]
        for a in range(5):
            m = (cb == a).astype(np.int64)
            shared += m @ m.T
    thresh = int(nsnp * threshold)
    neigh = ((nsnp - shared) < thresh).sum(axis=0)
    return 1.0 / (neigh + 1.0)


def neighbour_counts(codes: torch.Tensor, nsnp: int, npad: int,
                     thresh: int) -> torch.Tensor:
    """[nseq] i64 count of sequences within Hamming distance < thresh of
    each sequence, from the [nseq, nsnp + npad] u8 code tensor whose
    last npad columns match for every pair."""
    nseq = codes.shape[0]
    acc = torch.zeros((nseq, nseq), dtype=torch.float32, device=codes.device)
    for a in range(5):
        m = (codes == a).to(torch.float32)
        acc = acc + m @ m.T
    shared = acc - float(npad)
    near = (nsnp - shared) < thresh  # strict <, R/perform...R:76
    return near.sum(dim=1)


def estimate_hamming_distance_weights(
    snp_data, threshold: float = 0.1, backend: str = "jax",
    max_blk_sz: int = 10000, n_devices=None, device="cuda",
) -> np.ndarray:
    """BLK4: the Hamming weights of every sequence.  backend="numpy" takes
    the float64 host oracle; every other backend computes them on the first
    of the local devices (`support.resolve_devices(device, n_devices)`)
    from the r-stratified rank codes of the BLK5 tile size.  The counts are
    exact integers, so the weights are bit-equal across backends, devices
    and processes; under several processes each one computes them whole,
    and no collective is needed."""
    check_supported(backend=backend, n_devices=n_devices)
    if backend == "numpy":
        return hamming_weights_numpy(snp_data.codes, threshold)
    device = resolve_devices(device, n_devices)[0]
    block = fast_block_size(snp_data.nsnp, max_blk_sz)
    ranked = stratify(
        snp_data.codes, snp_data.acgtn_table, snp_data.pos, snp_data.r, block
    )
    npad = ranked.pos.size - snp_data.nsnp
    thresh = int(snp_data.nsnp * threshold)  # as.integer truncation, :23
    codes = torch.from_numpy(ranked.rank_codes).to(device)
    neigh = neighbour_counts(codes, snp_data.nsnp, npad, thresh)
    return 1.0 / (neigh.cpu().numpy().astype(np.int64) + 1.0)
