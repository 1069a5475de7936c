"""Typed configuration for the LDWeaver pipeline (PyTorch port).

Mirrors the argument surface, defaults and clamping behaviour of the
reference driver `LDWeaver()` (reference: R/BacGWES.R:69-192).

Divergences from the reference (deliberate, documented):
  * R/BacGWES.R:155-158 clamps an out-of-range `max_tophits` by assigning
    `sr_dist = 250` (a plain bug -- the warning text says it is clamping
    max_tophits).  We clamp `max_tophits` to 250 instead.
  * `ncores` is replaced by device/mesh settings; OpenMP/BLAS threading
    has no counterpart on the device (reference: R/BacGWES.R:127-139).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence


def _clamp(name, value, lo, hi, default):
    if value < lo or value > hi:
        warnings.warn(
            f"Unable to use the provided value for <{name}>: {value}, "
            f"using {default}"
        )
        return default
    return value


@dataclasses.dataclass
class LDWeaverConfig:
    """Pipeline configuration (defaults follow R/BacGWES.R:69-75)."""

    # --- SNP filtering (reference: R/BacGWES.R:16-19, src/getACGTNsites.cpp:104-166)
    snp_filt_method: str = "default"  # 'default' | 'relaxed'
    gap_freq: float = 0.15
    maf_freq: float = 0.01

    # --- population structure (reference: R/BacGWES.R:20)
    hdw_threshold: float = 0.1

    # --- analysis scope
    perform_SR_analysis_only: bool = False
    SnpEff_Annotate: bool = True

    # --- link classification (reference: R/BacGWES.R:23-29)
    sr_dist: int = 20000
    lr_retain_links: int = 1_000_000
    max_tophits: int = 250
    num_clusts_CDS: int = 3
    srp_cutoff: float = 3.0

    # --- outputs
    tanglegram_break_segments: Optional[int] = 5
    write_gwesExplorer: bool = True
    save_additional_outputs: bool = False

    # --- compute (device settings in place of ncores/mega_dset)
    max_blk_sz: int = 10000
    # precision of the on-device contingency matmuls:
    #   'f32'    - float32 MXU path (default; passes precision=HIGHEST)
    #   'f64'    - float64 path (CPU oracle / exact-parity runs)
    # (the JAX package's field and comment; neither package reads it)
    precision: str = "f32"
    # local devices of the sweep, one shard each (None = every card, one
    # a process under several processes; "cpu": one; support.resolve_devices)
    n_devices: Optional[int] = None
    # use the fused Pallas kernel where available (falls back to XLA)
    # (the JAX package's field and comment; neither package reads it)
    use_pallas: bool = True
    # replicate R's seeded 10% subsampling when estimating the number of LR
    # links (reference: R/computePairwiseMI.R:92-101, set.seed(1988)).  When
    # False, the exact count is computed instead (deterministic and exact).
    r_compat_lr_sampling: bool = True
    # device-memory cap of the fast backend's slab pool (None = the card's
    # memory); under it the rank-code slabs stream through an LRU cache in
    # panel order (parallel/slabs.py)
    device_budget_bytes: Optional[int] = None
    # how many tiles the fast backend dispatches ahead of the host
    # emission (1 = synchronous)
    pipeline_depth: int = 4
    # where the SR background reduction runs for backend='spmd'
    # (parallel/sr_reduce.py): 'auto' = on the device when the reduction's
    # measured footprint (sr_reduce.flat_peak_bytes) fits the budget, else
    # over several shards 'part' when it fits, else the host with a
    # warning; 'device' = always on
    # the device; 'part' = the grid-partitioned reduction over several
    # shards ('auto' on one); 'host' = copy the SR table to the host.
    # Outputs are byte-identical across modes.
    sr_reduce: str = "auto"

    def __post_init__(self):
        if self.snp_filt_method not in ("default", "relaxed"):
            warnings.warn("Unknown filtering method, using default...")
            self.snp_filt_method = "default"
        if self.sr_reduce not in ("auto", "device", "part", "host"):
            warnings.warn("Unknown sr_reduce mode, using auto...")
            self.sr_reduce = "auto"
        # clamps mirror R/BacGWES.R:142-179
        self.sr_dist = int(
            min(99999, max(1001, self.sr_dist))
            if (self.sr_dist < 1000 or self.sr_dist > 100000)
            else self.sr_dist
        )
        if self.lr_retain_links <= 1e3 or self.lr_retain_links >= 1e10:
            warnings.warn(
                "Unable to use the provided value for <lr_retain_links>, "
                "using 1000000"
            )
            self.lr_retain_links = 1_000_000
        self.max_tophits = _clamp("max_tophits", self.max_tophits, 50, 1000, 250)
        self.num_clusts_CDS = _clamp(
            "num_clusts_CDS", self.num_clusts_CDS, 1, 10, 3
        )
        self.srp_cutoff = _clamp("srp_cutoff", self.srp_cutoff, 0, 5, 3)
        if self.tanglegram_break_segments is not None:
            self.tanglegram_break_segments = _clamp(
                "tanglegram_break_segments",
                self.tanglegram_break_segments,
                0,
                10,
                5,
            )
        self.max_blk_sz = _clamp(
            "max_blk_sz", self.max_blk_sz, 1000, 100000, 10000
        )
