"""LDWeaver in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package `ldweaver_tpu` (which stays the reference): the
same genome-wide epistasis pipeline, with the all-vs-all Hamming-weighted
SNP-pair mutual-information sweep on one or more CUDA devices and
processes.  Every MI tile runs
in a hand-written CUDA kernel (csrc/*.cu, wrapped by ops/*.py); host code
(ingest, CDS diversity, background model, ARACNE, annotation, writers,
plots) is a copy of the reference package's.  The port imports neither
JAX nor the reference package.

`ldweaver(...)` runs all twelve blocks with the reference package's
defaults (SnpEff_Annotate=True): BLK1-BLK7 with the BLK5 backends "spmd"
(kernel K1), "jax" (the default), "pallas" (kernel K3) and "numpy", then
annotation, tophits, tanglegram, GWESExplorer export, network plots and
the long-range analysis.  Entry points run on device="cuda" unless the
caller passes device="cpu" (the kernels' plain PyTorch versions);
`n_devices` and the processes of `torch.distributed`
(parallel/multihost.py) shard BLK5.  The CLI is
`python -m ldweaver_tpu_torch.cli`.

Layer map:
  io/       - FASTA ingest, GenBank/GFF3 parsing, TSV readers/writers
  core/     - SNP tensor, Hamming weights, CDS diversity, MI host helpers,
              background model, ARACNE, long-range analyser, BLK5 driver
  ops/      - the CUDA kernels' wrappers, plain versions and build
  parallel/ - rank stratification, the MI tile, tile extraction and sweeps
  utils/    - R-compatible numerics (type-7 quantile, Beta MLE, R RNG)
  annotate, tanglegram, trees, plots, viz_html - outputs (host code)
  pipeline  - the LDWeaver() 12-block driver
"""

__version__ = "0.1.0"

from ldweaver_tpu_torch.config import LDWeaverConfig  # noqa: F401

# Public API, the reference package's names; each symbol is a lazy
# attribute so `import ldweaver_tpu_torch` stays cheap (torch and pandas
# load when used).
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
    "analyse_long_range_links": (
        "ldweaver_tpu_torch.pipeline", "analyse_long_range_links"),
    "perform_annotations": ("ldweaver_tpu_torch.annotate", "perform_annotations"),
    # the reference NAMESPACE names (perform_snpEff_annotations,
    # write_output_for_gwes_explorer) as aliases
    "perform_snpeff_annotations": (
        "ldweaver_tpu_torch.annotate", "perform_annotations"),
    "write_gwes_explorer_output": (
        "ldweaver_tpu_torch.io.writers", "write_gwes_explorer_output"),
    "write_output_for_gwes_explorer": (
        "ldweaver_tpu_torch.io.writers", "write_gwes_explorer_output"),
    "snpdat_to_fa": ("ldweaver_tpu_torch.io.writers", "snpdat_to_fa"),
    "generate_links_snps_fasta": (
        "ldweaver_tpu_torch.io.writers", "generate_links_snps_fasta"),
    "read_top_hits": ("ldweaver_tpu_torch.io.readers", "read_top_hits"),
    "read_long_range_links": (
        "ldweaver_tpu_torch.io.readers", "read_long_range_links"),
    "read_short_range_links": (
        "ldweaver_tpu_torch.io.readers", "read_short_range_links"),
    "read_annotated_links": (
        "ldweaver_tpu_torch.io.readers", "read_annotated_links"),
    "make_gwes_plots": ("ldweaver_tpu_torch.plots", "make_gwes_plots"),
    "genomewide_ld_map": ("ldweaver_tpu_torch.plots", "genomewide_ld_map"),
    "create_network": ("ldweaver_tpu_torch.plots", "create_network"),
    "create_network_for_gene": (
        "ldweaver_tpu_torch.plots", "create_network_for_gene"),
    "create_tanglegram": ("ldweaver_tpu_torch.tanglegram", "create_tanglegram"),
    "view_tree": ("ldweaver_tpu_torch.trees", "view_tree"),
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
