"""Dense SNP code tensor - the device-friendly replacement for the reference's
five sparse boolean matrices.

The reference stores one sparse logical nsnp x nseq matrix per allele
(reference: R/extractSNPs.R:100-141).  Sparsity there exists only because a
dense R character matrix would blow RAM; on an accelerator the natural layout is a
single dense uint8 code tensor `codes[nseq, nsnp]` with the coding
A=0, C=1, G=2, T=3, N/other=4 (matching the 5-row allele order of
src/getACGTNsites.cpp:58-70).  One-hot slabs for the contingency
products are expanded on the device per tile (`codes_block == allele`), so
the full one-hot tensor is never materialised in device memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

ALLELES = np.frombuffer(b"ACGTN", dtype=np.uint8)
ALLELE_NAMES = ("A", "C", "G", "T", "N")

# byte -> code lookup: a/A=0, c/C=1, g/G=2, t/T=3, everything else = 4
# (case-insensitive classification per src/getACGTNsites.cpp:58-70)
CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE_LUT[_c] = _i
    CODE_LUT[_c + 32] = _i  # lowercase


@dataclasses.dataclass
class SnpData:
    """Parsed SNP alignment (equivalent of the reference's `snp.dat` list,
    R/extractSNPs.R:138-141).

    Attributes:
      codes: [nseq, nsnp] uint8 allele codes (0..4).
      pos: [nsnp] int64, 1-based genome positions of each SNP.
      g: genome length in bp (None for SNP-only alignments until a
         reference annotation supplies it - R/BacGWES.R:337-351).
      seq_names: sequence names in alignment order.
      acgtn_table: [5, nsnp] int64 per-site allele counts
         (reference `ACGTN_table`, src/getACGTNsites.cpp:229-265).
      uqe: [nsnp, 5] uint8 indicator of which alleles occur at each site
         (reference `uqe`, R/extractSNPs.R:47).
      r: [nsnp] int32 number of distinct alleles per site
         (reference `r = rowSums(uqe)`, R/extractSNPs.R:141).
    """

    codes: np.ndarray
    pos: np.ndarray
    g: Optional[int]
    seq_names: List[str]
    acgtn_table: np.ndarray
    uqe: np.ndarray
    r: np.ndarray

    @property
    def nseq(self) -> int:
        return self.codes.shape[0]

    @property
    def nsnp(self) -> int:
        return self.codes.shape[1]

    # ---- derived views -------------------------------------------------
    def onehot(self, allele: int) -> np.ndarray:
        """Boolean [nseq, nsnp] matrix for one allele (a reference
        `snp.matrix_X` before the transpose, R/extractSNPs.R:100-132)."""
        return self.codes == allele

    def site_slab(self, start: int, stop: int) -> np.ndarray:
        """[stop-start, nseq] uint8 code slab for a SNP block (transposed
        layout: SNPs first, like the reference's post-transpose matrices,
        R/extractSNPs.R:138)."""
        return np.ascontiguousarray(self.codes[:, start:stop].T)

    def to_fasta_rows(self, site_idx: np.ndarray) -> np.ndarray:
        """Reconstruct allele characters [nseq, len(site_idx)] for SNP
        subsets (used by GWESExplorer / snpdat_to_fa exports,
        R/createGWESExplorerOutput.R:40-46, R/io_functions.R:390-396)."""
        return ALLELES[self.codes[:, site_idx]]

    # ---- persistence (content-addressed resume artifacts) --------------
    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            codes=self.codes,
            pos=self.pos,
            g=np.int64(self.g) if self.g is not None else np.int64(-1),
            acgtn_table=self.acgtn_table,
            uqe=self.uqe,
            r=self.r,
            seq_names=json.dumps(self.seq_names),
        )

    @classmethod
    def load_npz(cls, path: str) -> "SnpData":
        z = np.load(path, allow_pickle=False)
        g = int(z["g"])
        return cls(
            codes=z["codes"],
            pos=z["pos"],
            g=None if g < 0 else g,
            seq_names=json.loads(str(z["seq_names"])),
            acgtn_table=z["acgtn_table"],
            uqe=z["uqe"],
            r=z["r"],
        )


def derive_site_stats(acgtn_table: np.ndarray):
    """uqe / r from an allele-count table (R/extractSNPs.R:47,141)."""
    uqe = (acgtn_table > 0).astype(np.uint8).T  # [nsnp, 5]
    r = uqe.sum(axis=1).astype(np.int32)
    return uqe, r
