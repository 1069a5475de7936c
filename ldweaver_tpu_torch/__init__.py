"""LDWeaver in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package `ldweaver_tpu` (which stays the reference): the
same genome-wide epistasis pipeline, with the all-vs-all Hamming-weighted
SNP-pair mutual-information sweep on one CUDA device.  The rank-compacted
MI tile runs in a hand-written CUDA kernel (csrc/rank_mi.cu, wrapped by
ops/rank_mi.py); host code (ingest, CDS diversity, background model,
ARACNE, writers, plots) is a copy of the reference package's.  The port
imports neither JAX nor the reference package.

Ported so far: `ldweaver(..., backend="spmd", SnpEff_Annotate=False)`,
blocks BLK1-BLK7.  Entry points run on device="cuda" unless the caller
passes device="cpu" (the kernels' plain PyTorch versions).

Layer map:
  io/       - FASTA ingest, GenBank/GFF3 parsing, TSV readers/writers
  core/     - SNP tensor, Hamming weights, CDS diversity, MI host helpers,
              background model, ARACNE, the BLK5 driver
  ops/      - the CUDA kernels' wrappers, plain versions and build
  parallel/ - rank stratification, the MI tile, tile extraction and sweep
  utils/    - R-compatible numerics (type-7 quantile, Beta MLE, R RNG)
  pipeline  - the LDWeaver() driver, BLK1-BLK7
"""

__version__ = "0.1.0"

from ldweaver_tpu_torch.config import LDWeaverConfig  # noqa: F401

# Public API; each symbol is a lazy attribute so `import ldweaver_tpu_torch`
# stays cheap (torch and pandas load when used).
_API = {
    "ldweaver": ("ldweaver_tpu_torch.pipeline", "ldweaver"),
    "cleanup": ("ldweaver_tpu_torch.pipeline", "cleanup"),
    "parse_fasta_alignment": (
        "ldweaver_tpu_torch.io.fasta", "parse_fasta_alignment"),
    "parse_fasta_snp_alignment": (
        "ldweaver_tpu_torch.io.fasta", "parse_fasta_snp_alignment"),
    "parse_genbank_file": ("ldweaver_tpu_torch.io.genbank", "parse_genbank_file"),
    "parse_gff_file": ("ldweaver_tpu_torch.io.gff", "parse_gff_file"),
    "estimate_variation_in_cds": (
        "ldweaver_tpu_torch.core.cds", "estimate_variation_in_cds"),
    "estimate_hamming_distance_weights": (
        "ldweaver_tpu_torch.core.hamming", "estimate_hamming_distance_weights"),
    "perform_mi_computation": (
        "ldweaver_tpu_torch.core.sweep", "perform_mi_computation"),
    "run_aracne": ("ldweaver_tpu_torch.core.aracne", "run_aracne"),
    "read_long_range_links": (
        "ldweaver_tpu_torch.io.readers", "read_long_range_links"),
    "read_short_range_links": (
        "ldweaver_tpu_torch.io.readers", "read_short_range_links"),
    "make_gwes_plots": ("ldweaver_tpu_torch.plots", "make_gwes_plots"),
    "genomewide_ld_map": ("ldweaver_tpu_torch.plots", "genomewide_ld_map"),
}

__all__ = ["LDWeaverConfig", *_API]


def __getattr__(name):
    if name in _API:
        import importlib

        mod, attr = _API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'ldweaver_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API))
