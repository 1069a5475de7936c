"""Streaming (gz) FASTA alignment ingest -> SNP code tensor.

Replacement for the reference's two-pass kseq/Rcpp ingest:
  * pass 1 - allele counting + SNP site filtering
    (reference: src/getACGTNsites.cpp:13-176, `.extractAlnParam`)
  * pass 2 - per-site extraction of retained positions
    (reference: src/getACGTNsites.cpp:178-291, `.extractSNPs`)

The reference emits COO triplets for five sparse boolean matrices; we emit a
single dense uint8 code tensor (see core/snp_tensor.py).  A native C++
streaming tokenizer (ldweaver_tpu_torch/native) provides the throughput path,
with a vectorised-NumPy fallback when no toolchain is available.

Filter semantics are replicated exactly, including the truncated-int
thresholds:
  * default (spydrpick) filter, src/getACGTNsites.cpp:104-134:
      keep site iff >=2 of the four non-gap alleles occur, AND
      gap_count/nseq < gap_thresh, AND
      second-largest non-gap count > int(nseq*maf_thresh)        (strict >)
  * relaxed filter, src/getACGTNsites.cpp:135-166:
      keep site iff >=2 non-gap alleles occur, AND
      gap_count/nseq < gap_thresh, AND
      max(all five counts) <= int(nseq*(1-maf_thresh))
"""

from __future__ import annotations

import gzip
import io
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ldweaver_tpu_torch.core.snp_tensor import CODE_LUT, SnpData, derive_site_stats


def _open_maybe_gz(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Stream (name, sequence_bytes) records from a (gz) FASTA file."""
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gz(path) as fh:
        fh = io.BufferedReader(fh, buffer_size=1 << 20)
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                # kseq takes the name up to the first whitespace
                # (reference: src/kseq2.h name parsing)
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line.strip())
        if name is not None:
            yield name, b"".join(chunks)


def scan_alignment(path: str, use_native: bool = True):
    """Pass 1: equal-length check + 5 x L allele-count matrix.

    Equivalent of `.extractAlnParam` steps 1-2
    (src/getACGTNsites.cpp:17-89).  Returns (nseq, seq_len, names, counts)
    where counts is int64 [5, L] with rows A,C,G,T,other.  Uses the
    native C++ streaming tokenizer when available.
    """
    if use_native:
        result = _scan_alignment_native(path)
        if result is not None:
            return result
    counts = None
    seq_len = None
    names: List[str] = []
    nseq = 0
    for name, seq in iter_fasta(path):
        arr = np.frombuffer(seq, dtype=np.uint8)
        if seq_len is None:
            seq_len = arr.size
            counts = np.zeros((5, seq_len), dtype=np.int64)
        elif arr.size != seq_len:
            raise ValueError(
                "Error! sequences are of different lengths!"
            )  # R/extractSNPs.R:41
        codes = CODE_LUT[arr]
        # scatter-add one sequence's alleles into the count matrix
        for k in range(5):
            counts[k] += codes == k
        names.append(name)
        nseq += 1
    if nseq == 0:
        raise ValueError("File does not contain any sequences!")  # R/extractSNPs.R:42
    return nseq, seq_len, names, counts


def filter_sites(
    counts: np.ndarray,
    nseq: int,
    method: str = "default",
    gap_freq: float = 0.15,
    maf_freq: float = 0.01,
) -> np.ndarray:
    """SNP site filter -> 1-based retained positions.

    Exact semantics of src/getACGTNsites.cpp:104-166 (see module
    docstring); `int(...)` truncation of the MAF thresholds matches the C
    `int min_maf = n*maf_thresh` casts (lines 105, 136).
    """
    nongap = counts[:4]
    polymorphic = (nongap > 0).sum(axis=0) >= 2
    gap_ok = counts[4] / nseq < gap_freq
    if method == "default":
        min_maf = int(nseq * maf_freq)
        second_largest = np.sort(nongap, axis=0)[2]
        keep = polymorphic & gap_ok & (second_largest > min_maf)
    elif method == "relaxed":
        min_maf = int(nseq * (1 - maf_freq))
        keep = polymorphic & gap_ok & (counts.max(axis=0) <= min_maf)
    else:
        warnings.warn("Unknown filtering method, using default...")
        return filter_sites(counts, nseq, "default", gap_freq, maf_freq)
    return np.flatnonzero(keep).astype(np.int64) + 1  # 1-based, cpp:122,154


def _scan_alignment_native(path: str):
    """Native pass-1 (ldw_scan_alignment); None -> fall back to Python."""
    import ctypes
    import tempfile

    from ldweaver_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    # first record gives the capacity
    first = next(iter_fasta(path), None)
    if first is None:
        raise ValueError("File does not contain any sequences!")
    seq_len = len(first[1])
    counts = np.zeros((5, seq_len), dtype=np.int64)
    out_len = ctypes.c_int64(0)
    with tempfile.NamedTemporaryFile(mode="r", suffix=".names") as nf:
        n = lib.ldw_scan_alignment(
            path.encode(), counts.reshape(-1), seq_len,
            ctypes.byref(out_len), nf.name.encode(),
        )
        if n == -3:
            raise ValueError("Error! sequences are of different lengths!")
        if n <= 0:
            return None  # unexpected native failure: Python fallback
        names = [line.strip() for line in open(nf.name)]
    return int(n), int(out_len.value), names, counts


def _extract_codes_native(path: str, pos_1based: np.ndarray, nseq: int):
    from ldweaver_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    nsnp = pos_1based.size
    codes = np.zeros((nseq, nsnp), dtype=np.uint8)
    acgtn = np.zeros((5, nsnp), dtype=np.int64)
    n = lib.ldw_extract_codes(
        path.encode(),
        np.ascontiguousarray(pos_1based, dtype=np.int64),
        nsnp,
        codes.reshape(-1),
        nseq,
        acgtn.reshape(-1),
    )
    if n != nseq:
        return None
    # names come from pass 1 (identical file); callers that used the
    # native scan already have them
    return codes, acgtn, None


def extract_codes(path: str, pos_1based: np.ndarray, nseq: int,
                  use_native: bool = True):
    """Pass 2: gather retained sites into a dense code tensor.

    Equivalent of `.extractSNPs` (src/getACGTNsites.cpp:178-291); also
    accumulates the per-site ACGTN count table (cpp:229-265).
    """
    if use_native:
        result = _extract_codes_native(path, pos_1based, nseq)
        if result is not None:
            return result
    nsnp = pos_1based.size
    codes = np.empty((nseq, nsnp), dtype=np.uint8)
    idx0 = pos_1based - 1
    names: List[str] = []
    i = 0
    for name, seq in iter_fasta(path):
        arr = np.frombuffer(seq, dtype=np.uint8)
        codes[i] = CODE_LUT[arr[idx0]]
        names.append(name)
        i += 1
    acgtn_table = np.zeros((5, nsnp), dtype=np.int64)
    for k in range(5):
        acgtn_table[k] = (codes == k).sum(axis=0)
    return codes, acgtn_table, names


def parse_fasta_alignment(
    aln_path: str,
    gap_freq: float = 0.15,
    maf_freq: float = 0.01,
    method: str = "default",
) -> SnpData:
    """Full-genome alignment -> SnpData.

    Equivalent of `parse_fasta_alignment` (R/extractSNPs.R:23-142); the
    genome length g is the alignment length.
    """
    nseq, seq_len, scan_names, counts = scan_alignment(aln_path)
    pos = filter_sites(counts, nseq, method, gap_freq, maf_freq)
    if pos.size == 0:
        raise ValueError("File does not contain any SNPs")  # R/extractSNPs.R:43
    codes, acgtn_table, names = extract_codes(aln_path, pos, nseq)
    if names is None:
        names = scan_names
    uqe, r = derive_site_stats(acgtn_table)
    return SnpData(
        codes=codes,
        pos=pos,
        g=int(seq_len),
        seq_names=names,
        acgtn_table=acgtn_table,
        uqe=uqe,
        r=r,
    )


def parse_fasta_snp_alignment(
    aln_path: str,
    pos: np.ndarray,
    gap_freq: float = 0.15,
    maf_freq: float = 0.01,
    method: str = "default",
) -> SnpData:
    """SNP-only alignment (snp-sites output) + genome-position vector.

    Equivalent of `parse_fasta_SNP_alignment` (R/extractSNPs.R:168-281):
    sites are re-filtered, then the retained alignment columns are mapped
    through the user's `pos` vector (R/extractSNPs.R:200).  g is unknown
    (None) until an annotation supplies it (R/BacGWES.R:337-351).
    """
    pos = np.asarray(pos, dtype=np.int64)
    if np.unique(pos).size != pos.size:
        raise ValueError("Provided pos contains duplicates!")  # R/BacGWES.R:122
    nseq, seq_len, scan_names, counts = scan_alignment(aln_path)
    if pos.size != seq_len:
        raise ValueError(
            "Error! Number of positions do not match the fasta sequence length"
        )  # R/extractSNPs.R:194
    kept = filter_sites(counts, nseq, method, gap_freq, maf_freq)
    if kept.size == 0:
        raise ValueError("File does not contain any SNPs")
    codes, acgtn_table, names = extract_codes(aln_path, kept, nseq)
    if names is None:
        names = scan_names
    genome_pos = pos[kept - 1].astype(np.int64)  # R/extractSNPs.R:200
    uqe, r = derive_site_stats(acgtn_table)
    return SnpData(
        codes=codes,
        pos=genome_pos,
        g=None,
        seq_names=names,
        acgtn_table=acgtn_table,
        uqe=uqe,
        r=r,
    )
