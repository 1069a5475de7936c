"""The LDWeaver pipeline driver (PyTorch port).

Mirrors the 12-block orchestration of the reference `LDWeaver()` entry
point (R/BacGWES.R:69-492) with the same caching / resume-from-artifact
behaviour (npz/tsv in place of rds), console-log tee, timings.json and the
cleanup() folder layout.  BLK4 and BLK5 run on `device` (CUDA by
default); everything else is host code.  With SnpEff_Annotate=False the
run returns after BLK7, as the reference package does.

Blocks (R/BacGWES.R:77-88):
  BLK1  parse alignment -> SNP tensor
  BLK2  parse GBK or GFF+ref
  BLK3  CDS diversity + clustering + painting
  BLK4  Hamming distance weights
  BLK5  MI computation + background model + ARACNE    *** hot ***
  BLK6  genomewide LD map
  BLK7  GWES plots
  BLK8  annotation + SR tophits
  BLK9  tanglegram
  BLK10 GWESExplorer output
  BLK11 network plot
  BLK12 long-range link analysis
  + cleanup
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np
import pandas as pd

from ldweaver_tpu_torch.config import LDWeaverConfig
from ldweaver_tpu_torch.core.cds import CdsVar, estimate_variation_in_cds
from ldweaver_tpu_torch.core.hamming import estimate_hamming_distance_weights
from ldweaver_tpu_torch.core.lr import analyse_long_range_links_core
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.core.sweep import perform_mi_computation
from ldweaver_tpu_torch.io import readers
from ldweaver_tpu_torch.io.fasta import parse_fasta_alignment, parse_fasta_snp_alignment
from ldweaver_tpu_torch.io.genbank import parse_genbank_file
from ldweaver_tpu_torch.io.gff import parse_gff_file
from ldweaver_tpu_torch.io.writers import write_gwes_explorer_output
from ldweaver_tpu_torch.support import check_supported, resolve_devices


class _Tee:
    """sink(split=T) equivalent (R/BacGWES.R:208-210)."""

    def __init__(self, path):
        self.file = open(path, "at")
        self.stdout = sys.stdout

    def write(self, s):
        self.file.write(s)
        self.stdout.write(s)

    def flush(self):
        self.file.flush()
        self.stdout.flush()


def _first_existing(*paths):
    """Prefer an already-existing artifact (resume), else the default
    location - the LAST candidate (R/BacGWES.R:217-241)."""
    for p in paths:
        if os.path.exists(p):
            return p
    return paths[-1]


def ldweaver(
    dset: str,
    aln_path: str,
    aln_has_all_bases: bool = True,
    pos: Optional[np.ndarray] = None,
    gbk_path: Optional[str] = None,
    gff3_path: Optional[str] = None,
    ref_fasta_path: Optional[str] = None,
    validate_ref_ann_lengths: bool = True,
    snpeff_jar_path: Optional[str] = None,
    config: Optional[LDWeaverConfig] = None,
    backend: str = "jax",
    device="cuda",
    **config_kwargs,
):
    """Run the full GWES pipeline; everything is saved under `dset`.

    Equivalent of LDWeaver::LDWeaver (R/BacGWES.R:69-492).  BLK4 and BLK5
    run on `device` ("cuda", or "cpu" for the plain PyTorch versions of
    the kernels).  `backend` picks the BLK5 sweep as in the JAX package:
    "spmd" (the r-stratified tile sweep on kernel K1), "fast" (the same
    tiles dispatched ahead of the host emission through a slab cache that
    `device_budget_bytes` bounds; byte-identical outputs), or the compat
    backends "jax" (the default, f32 PyTorch tiles), "pallas" (kernel K3)
    and "numpy" (the float64 oracle, which also computes BLK4 on the
    host).  BLK5 checkpoints into `dset/mi_chkpt`, so an interrupted run
    resumes its sweep.  BLK8-BLK12 (annotation, tophits, tanglegram, GWESExplorer
    export, network plot, LR analysis) run with SnpEff_Annotate=True, the
    default; snpEff itself runs when `snpeff_jar_path` and `java` exist,
    the built-in annotator otherwise.  Returns the reduced short-range
    link table.
    """
    cfg = config or LDWeaverConfig(**config_kwargs)
    check_supported(backend=backend, n_devices=cfg.n_devices)
    # the local devices of BLK4 and BLK5 (support.resolve_devices)
    devices = resolve_devices(device, cfg.n_devices)
    device = devices[0]
    cfg = dataclasses.replace(cfg, n_devices=len(devices))
    t_global = time.time()
    timings = {}
    open_stages = []

    class _stage:
        """Structured per-stage timing (SURVEY.md section 5: the reference
        only prints Sys.time() deltas; we also persist timings.json).
        Stages register themselves so the pipeline-level finally can close
        a stage interrupted by an exception and still record its wall
        clock (ADVICE r2: manual enter/exit pairs lost the timing of a
        raising block and skipped the final dump)."""

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = time.time()
            open_stages.append(self)

        def __exit__(self, *exc):
            timings[self.name] = round(time.time() - self.t0, 3)
            if self in open_stages:
                open_stages.remove(self)

    _stage.timings = timings  # body-side access (e.g. blk5_phases)

    # ---- sanity checks (R/BacGWES.R:99-124)
    if (gbk_path is None) == (gff3_path is None):
        raise ValueError("Either gbk_path or gff3_path must be provided")
    if gff3_path is not None and ref_fasta_path is None:
        raise ValueError("Reference fasta file must be provided for gff3 annotations")
    if not aln_has_all_bases:
        if pos is None:
            raise ValueError(
                "A numeric vector of 'positions' <pos> must be provided if "
                "aln_has_all_bases = F"
            )
        validate_ref_ann_lengths = False  # R/BacGWES.R:181-183
    elif pos is not None:
        raise ValueError("pos cannot be provided for alignments with all bases!")

    order_links = not cfg.SnpEff_Annotate  # R/BacGWES.R:104-115

    os.makedirs(dset, exist_ok=True)
    info_file = os.path.join(
        dset, f"LDW_run_{time.strftime('%Y%m%d%H%M%S')}.txt"
    )
    tee = _Tee(info_file)

    import json as _json

    def _dump_timings():
        # written after BLK5 (the expensive stage, crash resilience), at
        # every pipeline exit, and from the finally below on a crash
        with open(os.path.join(dset, "timings.json"), "wt") as _fh:
            _json.dump(timings, _fh, indent=1)

    try:
        return _ldweaver_body(
            dset, aln_path, aln_has_all_bases, pos, gbk_path, gff3_path,
            ref_fasta_path, validate_ref_ann_lengths, snpeff_jar_path,
            cfg, backend, device, order_links, tee, t_global, _stage,
            _dump_timings,
        )
    finally:
        # a raising block still gets its (partial) wall clock recorded
        for st in list(open_stages):
            st.__exit__()
        _dump_timings()
        tee.file.close()


def _ldweaver_body(
    dset, aln_path, aln_has_all_bases, pos, gbk_path, gff3_path,
    ref_fasta_path, validate_ref_ann_lengths, snpeff_jar_path,
    cfg, backend, device, order_links, tee, t_global, _stage, _dump_timings,
):
    with contextlib.redirect_stdout(tee):
        print("***** This is LDWeaver (PyTorch port) *****")
        # capability banner (the reference prints OpenMP status at start,
        # R/BacGWES.R:247)
        from ldweaver_tpu_torch.native import get_lib

        print(
            "Native host kernels:",
            "available" if get_lib() is not None else "unavailable (NumPy fallback)",
        )
        if device.type == "cuda":
            import torch

            print(f"Compute device: {torch.cuda.get_device_name(device)}")
        else:
            print(f"Compute device: {device}")
        print(f"Performing GWES analysis on: {dset}")
        print(f"Alignment: {aln_path}")
        print("\n *** Parameters *** \n")
        if cfg.snp_filt_method == "default":
            print(
                f"Default SNP filtering: sites with gap_freq < {cfg.gap_freq} "
                f"and non-gap minor allele freq > {cfg.maf_freq} will be retained."
            )
        else:
            print(
                f"Relaxed SNP filtering: sites with gap_freq < {cfg.gap_freq} "
                f"and minor allele freq > {cfg.maf_freq} will be retained."
            )
        print(f"Hamming distance calculation weight: {cfg.hdw_threshold}")
        print(
            f"Links <= {cfg.sr_dist} bp-apart will be classified as "
            f"short-range (sr-links)"
        )
        if not cfg.perform_SR_analysis_only:
            print(
                f"Approx. top {cfg.lr_retain_links} long range links will be saved"
            )
        print(f"Top sr-links with -log10(p) > {cfg.srp_cutoff} will be saved")

        add_path = os.path.join(dset, "Additional_Outputs")
        if cfg.save_additional_outputs:
            os.makedirs(add_path, exist_ok=True)

        snp_path = _first_existing(
            os.path.join(add_path, "snp_ACGTN.npz"),
            os.path.join(dset, "snp_ACGTN.npz"),
        )
        cds_var_path = _first_existing(
            os.path.join(add_path, "cds_var.npz"),
            os.path.join(dset, "cds_var.npz"),
        )
        hdw_path = _first_existing(
            os.path.join(add_path, "hdw.npz"), os.path.join(dset, "hdw.npz")
        )
        lr_save_path = _first_existing(
            os.path.join(dset, "Temp/lr_links.tsv"),
            os.path.join(dset, "lr_links.tsv"),
        )
        sr_save_path = _first_existing(
            os.path.join(dset, "Temp/sr_links.tsv"),
            os.path.join(dset, "sr_links.tsv"),
        )
        tophits_path = _first_existing(
            os.path.join(dset, "Tophits/sr_tophits.tsv"),
            os.path.join(dset, "sr_tophits.tsv"),
        )

        # ---- BLK1: alignment -> SNP tensor (R/BacGWES.R:279-303)
        print("\n#################### BLOCK 1 ####################\n")
        stage1 = _stage("blk1_parse_alignment"); stage1.__enter__()
        if not os.path.exists(snp_path):
            t0 = time.time()
            if aln_has_all_bases:
                snp_data = parse_fasta_alignment(
                    aln_path,
                    gap_freq=cfg.gap_freq,
                    maf_freq=cfg.maf_freq,
                    method=cfg.snp_filt_method,
                )
            else:
                snp_data = parse_fasta_snp_alignment(
                    aln_path,
                    pos,
                    gap_freq=cfg.gap_freq,
                    maf_freq=cfg.maf_freq,
                    method=cfg.snp_filt_method,
                )
            print(f"BLOCK 1 complete in {time.time() - t0:.2f} s")
        else:
            print("Loading previous snp matrix")
            snp_data = SnpData.load_npz(snp_path)

        stage1.__exit__()
        # ---- BLK2: annotation (R/BacGWES.R:306-335)
        # resume cache: parsed_gbk.rds / parsed_gff3.rds equivalents
        # (R/BacGWES.R:314-319) as pickles of the parsed dataclasses.
        print("\n#################### BLOCK 2 ####################\n")
        stage2 = _stage("blk2_annotation_parse"); stage2.__enter__()
        import pickle

        ann_base = "parsed_gbk.pkl" if gbk_path is not None else "parsed_gff3.pkl"
        ann_cache = _first_existing(
            os.path.join(add_path, ann_base), os.path.join(dset, ann_base)
        )
        gbk = None
        gff = None
        if gbk_path is not None:
            if os.path.exists(ann_cache):
                print("Loading parsed gbk file...")
                with open(ann_cache, "rb") as fh:
                    gbk = pickle.load(fh)
                ref_g = gbk.length if gbk.length else len(gbk.sequence)
            else:
                gbk, ref_g = parse_genbank_file(
                    gbk_path, g=snp_data.g, length_check=validate_ref_ann_lengths
                )
                if cfg.save_additional_outputs:
                    with open(ann_cache, "wb") as fh:
                        pickle.dump(gbk, fh)
            cds_features = gbk.cds
            cds_starts, cds_ends = gbk.cds_ranges()
            ref_seq = gbk.sequence
            genome_name = gbk.name
            if snp_data.g is None:
                snp_data.g = ref_g  # R/BacGWES.R:337-342
                print(f"Extracted ref genome length {ref_g} from genbank...")
        else:
            if os.path.exists(ann_cache):
                print("Loading parsed gff3 file...")
                with open(ann_cache, "rb") as fh:
                    gff = pickle.load(fh)
            else:
                gff = parse_gff_file(
                    gff3_path,
                    ref_fasta_path,
                    perform_length_check=validate_ref_ann_lengths,
                )
                if cfg.save_additional_outputs:
                    with open(ann_cache, "wb") as fh:
                        pickle.dump(gff, fh)
            cds_features = [
                f for f in gff.features if f.type.lower() == "cds"
            ]
            cds_starts, cds_ends = gff.cds_ranges()
            ref_seq = gff.ref
            genome_name = gff.seqid
            if snp_data.g is None:
                snp_data.g = gff.g

        # tanglegram locus lookup scans EVERY feature type, not just CDS
        # (R/createTanglegram.R:88-137 walks genes/cds/exons/transcripts/
        # other_features)
        all_features = gbk.features if gbk is not None else gff.features

        if cfg.save_additional_outputs and not os.path.exists(snp_path):
            snp_data.save_npz(snp_path)
        stage2.__exit__()

        # ---- BLK3: CDS diversity (R/BacGWES.R:353-364)
        # resume cache: cds_var.rds equivalent (R/BacGWES.R:358-364)
        print("\n#################### BLOCK 3 ####################\n")
        stage3 = _stage("blk3_cds_diversity"); stage3.__enter__()
        if os.path.exists(cds_var_path):
            print("Loading previous CDS variation estimates")
            cds_var = CdsVar.load_npz(cds_var_path)
        else:
            cds_var = estimate_variation_in_cds(
                snp_data,
                cds_starts,
                cds_ends,
                ref_seq,
                num_clusts_cds=cfg.num_clusts_CDS,
            )
            if cfg.save_additional_outputs:
                cds_var.save_npz(cds_var_path)
        from ldweaver_tpu_torch.plots import plot_cds_clusters

        plot_cds_clusters(cds_var, os.path.join(dset, "CDS_clustering.png"))
        stage3.__exit__()

        # ---- BLK4: Hamming weights (R/BacGWES.R:366-378)
        print("\n#################### BLOCK 4 ####################\n")
        stage4 = _stage("blk4_hamming_weights"); stage4.__enter__()
        if os.path.exists(hdw_path):
            print("Loading previous Hamming distance estimates")
            hdw = np.load(hdw_path)["hdw"]
        else:
            hdw = estimate_hamming_distance_weights(
                snp_data,
                cfg.hdw_threshold,
                backend=backend,
                max_blk_sz=cfg.max_blk_sz,
                n_devices=cfg.n_devices,
                device=device,
            )
            if cfg.save_additional_outputs:
                np.savez_compressed(hdw_path, hdw=hdw)
        stage4.__exit__()

        # ---- BLK5: MI computation (R/BacGWES.R:380-395)
        print("\n#################### BLOCK 5 ####################\n")
        stage5 = _stage("blk5_mi_computation"); stage5.__enter__()
        have_mi = os.path.exists(sr_save_path) and (
            cfg.perform_SR_analysis_only or os.path.exists(lr_save_path)
        )
        if have_mi:
            print("Loading previous MI computation")
            sr_df = readers.read_short_range_links(sr_save_path)
        else:
            print("Commencing MI computation")
            _blk5_phases: dict = {}
            sr_links = perform_mi_computation(
                snp_data,
                hdw,
                cds_var,
                phase_timings=_blk5_phases,
                lr_save_path=lr_save_path,
                sr_save_path=sr_save_path,
                plt_folder=dset,
                sr_dist=cfg.sr_dist,
                lr_retain_links=cfg.lr_retain_links,
                max_blk_sz=cfg.max_blk_sz,
                srp_cutoff=cfg.srp_cutoff,
                run_aracne_flag=True,
                perform_sr_analysis_only=cfg.perform_SR_analysis_only,
                order_links=order_links,
                backend=backend,
                r_compat_sampling=cfg.r_compat_lr_sampling,
                checkpoint_dir=os.path.join(dset, "mi_chkpt"),
                device_budget_bytes=cfg.device_budget_bytes,
                pipeline_depth=cfg.pipeline_depth,
                n_devices=cfg.n_devices,
                sr_reduce=cfg.sr_reduce,
                device=device,
            )
            if _blk5_phases:
                # BLK5's phase split (sweep/background/aracne + the sweep's
                # tile stats) rides along in timings.json
                _stage.timings["blk5_phases"] = _blk5_phases
            sr_df = pd.DataFrame(
                dict(
                    clust_c=sr_links.clust_c,
                    pos1=sr_links.pos1,
                    pos2=sr_links.pos2,
                    clust1=sr_links.clust1,
                    clust2=sr_links.clust2,
                    len=sr_links.len,
                    MI=sr_links.MI,
                    srp_max=sr_links.srp_max,
                    ARACNE=sr_links.ARACNE,
                )
            )

        stage5.__exit__()
        _dump_timings()
        # ---- BLK6: genomewide LD map (R/BacGWES.R:399-408)
        if not cfg.perform_SR_analysis_only:
            print("\n#################### BLOCK 6 ####################\n")
            stage6 = _stage("blk6_ld_map"); stage6.__enter__()
            try:
                from ldweaver_tpu_torch.plots import genomewide_ld_map

                lr_df_all = readers.read_long_range_links(
                    lr_save_path, sr_dist=cfg.sr_dist
                )
                genomewide_ld_map(
                    lr_df_all,
                    sr_df,
                    os.path.join(dset, "LD_plot.png"),
                    plot_title=f"GW-LD: {dset}",
                )
            except Exception as e:  # plotting must not kill the pipeline
                print(f"LD map skipped: {e}")
            stage6.__exit__()

        if len(sr_df) == 0:
            raise RuntimeError(
                "No potentially important sr_links were identified! "
                "Cannot continue analysis..."
            )  # R/BacGWES.R:411-414

        # ---- BLK7: GWES plots (R/BacGWES.R:417-420)
        print("\n#################### BLOCK 7 ####################\n")
        stage7 = _stage("blk7_gwes_plots"); stage7.__enter__()
        from ldweaver_tpu_torch.core.background import SrLinks as _SrLinks
        from ldweaver_tpu_torch.plots import make_gwes_plots

        sr_struct = _SrLinks(
            clust_c=sr_df["clust_c"].to_numpy(),
            pos1=sr_df["pos1"].to_numpy(),
            pos2=sr_df["pos2"].to_numpy(),
            clust1=sr_df["clust1"].to_numpy(),
            clust2=sr_df["clust2"].to_numpy(),
            len=sr_df["len"].to_numpy(dtype=np.float64),
            MI=sr_df["MI"].to_numpy(dtype=np.float64),
            srp_max=sr_df["srp_max"].to_numpy(dtype=np.float64),
            ARACNE=sr_df["ARACNE"].to_numpy(),
        )
        make_gwes_plots(sr_struct, dset, are_srlinks_ordered=order_links)
        stage7.__exit__()

        # ---- BLK8: annotation + tophits (R/BacGWES.R:422-438)
        print("\n#################### BLOCK 8 ####################\n")
        if not cfg.SnpEff_Annotate:
            cleanup(dset)
            _dump_timings()
            print(
                f"\n** All done in {(time.time() - t_global) / 60:.3f} m **"
            )
            return sr_df

        stage8 = _stage("blk8_annotation_tophits"); stage8.__enter__()
        from ldweaver_tpu_torch.annotate import perform_annotations

        if not os.path.exists(tophits_path):
            tophits = perform_annotations(
                dset_name=dset,
                annotation_folder=dset,
                snp_data=snp_data,
                cds_var=cds_var,
                links_df=sr_df,
                genome_name=genome_name,
                g=snp_data.g,
                cds_features=cds_features,
                ref_seq=ref_seq,
                snpeff_jar=snpeff_jar_path,
                gbk_path=gbk_path,
                gff_path=gff3_path,
                ref_path=ref_fasta_path,
                tophits_path=tophits_path,
                max_tophits=cfg.max_tophits,
                links_type="SR",
            )
        else:
            print("Loading previous top hits")
            tophits = readers.read_top_hits(tophits_path)
        stage8.__exit__()

        # ---- BLK9: tanglegram (R/BacGWES.R:441-448)
        if cfg.tanglegram_break_segments is not None:
            print("\n#################### BLOCK 9 ####################\n")
            stage9 = _stage("blk9_tanglegram"); stage9.__enter__()
            from ldweaver_tpu_torch.tanglegram import create_tanglegram

            create_tanglegram(
                tophits,
                all_features,
                os.path.join(dset, "SR_Tanglegram"),
                break_segments=cfg.tanglegram_break_segments,
            )
            stage9.__exit__()

        # ---- BLK10: GWESExplorer (R/BacGWES.R:449-458)
        if cfg.write_gwesExplorer:
            print("\n#################### BLOCK 10 ####################\n")
            stage10 = _stage("blk10_gwes_explorer"); stage10.__enter__()
            write_gwes_explorer_output(
                snp_data,
                dict(
                    pos1=tophits["pos1"].to_numpy(),
                    pos2=tophits["pos2"].to_numpy(),
                    len=tophits["len"].to_numpy(),
                    ARACNE=tophits["ARACNE"].to_numpy(),
                    MI=tophits["MI"].to_numpy(),
                    srp=tophits["srp"].to_numpy()
                    if "srp" in tophits
                    else tophits["MI"].to_numpy(),
                ),
                os.path.join(dset, "SR_GWESExplorer"),
                links_type="SR",
            )
            stage10.__exit__()

        # ---- BLK11: network plot (R/BacGWES.R:461-467)
        print("\n#################### BLOCK 11 ####################\n")
        stage11 = _stage("blk11_network_plot"); stage11.__enter__()
        try:
            from ldweaver_tpu_torch.plots import create_network

            create_network(
                tophits,
                os.path.join(dset, "SR_network_plot.png"),
                plot_title=f"Networks in short-range tophits for {dset}",
            )
        except Exception as e:
            print(f"network plot skipped: {e}")
        stage11.__exit__()

        # ---- BLK12: LR analysis (R/BacGWES.R:469-487)
        if not cfg.perform_SR_analysis_only:
            print("\n#################### BLOCK 12 ####################\n")
            stage12 = _stage("blk12_lr_analysis"); stage12.__enter__()
            if not (
                os.path.exists(os.path.join(dset, "lr_tophits.tsv"))
                or os.path.exists(os.path.join(dset, "Tophits/lr_tophits.tsv"))
            ):
                analyse_long_range_links(
                    dset,
                    lr_save_path,
                    sr_save_path,
                    SnpEff_Annotate=cfg.SnpEff_Annotate,
                    snpeff_jar_path=snpeff_jar_path,
                    snp_data=snp_data,
                    cds_var=cds_var,
                    genome_name=genome_name,
                    cds_features=cds_features,
                    ref_seq=ref_seq,
                    gbk_path=gbk_path,
                    gff3_path=gff3_path,
                    ref_fasta_path=ref_fasta_path,
                    sr_dist=cfg.sr_dist,
                )
            else:
                print("Results from previous LR analysis exist!")
            stage12.__exit__()

        cleanup(dset)
        _dump_timings()
        print(f"\n** All done in {(time.time() - t_global) / 60:.3f} m **")
    return sr_df


def analyse_long_range_links(
    dset: str,
    lr_links_path: str,
    sr_links_path: str,
    SnpEff_Annotate: bool = False,
    snpeff_jar_path: Optional[str] = None,
    snp_data=None,
    cds_var=None,
    genome_name: str = "",
    cds_features=None,
    ref_seq: str = "",
    gbk_path=None,
    gff3_path=None,
    ref_fasta_path=None,
    max_tophits: int = 500,
    links_from_spydrpick: bool = False,
    sr_dist: int = 20000,
):
    """BLK12 equivalent of analyse_long_range_links (R/lr_analyser.R:30-187).
    Host code: reads the link tables, thresholds and ARACNE-prunes the LR
    links, and annotates them when SnpEff_Annotate and snp_data are given."""
    os.makedirs(dset, exist_ok=True)
    lr_links = readers.read_long_range_links(
        lr_links_path, links_from_spydrpick=links_from_spydrpick, sr_dist=sr_dist
    )
    sr_links = readers.read_short_range_links(sr_links_path)
    result = analyse_long_range_links_core(lr_links, sr_links)

    from ldweaver_tpu_torch.plots import plot_lr_gwes

    plot_lr_gwes(
        result.links,
        max(result.thresholds),
        os.path.join(dset, "lr_gwes.png"),
    )

    if SnpEff_Annotate and snp_data is not None:
        from ldweaver_tpu_torch.annotate import perform_annotations

        tophits = perform_annotations(
            dset_name=dset,
            annotation_folder=dset,
            snp_data=snp_data,
            cds_var=cds_var,
            links_df=result.links,
            genome_name=genome_name,
            g=snp_data.g,
            cds_features=cds_features,
            ref_seq=ref_seq,
            snpeff_jar=snpeff_jar_path,
            gbk_path=gbk_path,
            gff_path=gff3_path,
            ref_path=ref_fasta_path,
            tophits_path=os.path.join(dset, "lr_tophits.tsv"),
            max_tophits=max_tophits,
            links_type="LR",
        )
        write_gwes_explorer_output(
            snp_data,
            dict(
                pos1=tophits["pos1"].to_numpy(),
                pos2=tophits["pos2"].to_numpy(),
                len=tophits["len"].to_numpy(),
                ARACNE=tophits["ARACNE"].to_numpy(),
                MI=tophits["MI"].to_numpy(),
            ),
            os.path.join(dset, "LR_GWESExplorer"),
            links_type="LR",
        )
        try:
            from ldweaver_tpu_torch.plots import create_network

            create_network(
                tophits,
                os.path.join(dset, "lr_network_plot.png"),
                plot_title=f"Networks in long-range tophits for {dset}",
            )
        except Exception as e:
            print(f"lr network plot skipped: {e}")
        return tophits
    return result.links


def cleanup(dset: str, delete_after_moving: bool = False) -> None:
    """Organise outputs into the reference folder layout
    (cleanup, R/io_functions.R:236-327): Fit/, Additional_Outputs/,
    Annotated_links/, GWESPlots/, Tophits/, GWESExplorer dirs stay,
    Temp/ for intermediates, originals preserved in OLD/ unless deleted.
    """
    import re

    if not os.path.exists(dset):
        raise FileNotFoundError(dset)
    files = sorted(os.listdir(dset))
    moved = []

    rules = [
        (r"^c\d+_fit_data\.npz$", "Fit"),
        (r"^(cds_var|hdw|parsed_gbk|parsed_gff3|snp_ACGTN)\.(rds|npz|pkl)$",
         "Additional_Outputs"),
        (r"^c\d+_fit\.png$", "Fit"),
        (r"^CDS_clustering\.png$", "Fit"),
        (r"_links_annotated\.tsv$", "Annotated_links"),
        (r"_gwes.*\.png$", "GWESPlots"),
        (r"_tophits\.tsv$", "Tophits"),
        (r"_network_plot\.(png|html)$", "Tophits"),
        (r"_GWESExplorer$", "GWESExplorer"),
        (r"(snpEff|\.vcf$|annotations\.tsv$|_links\.tsv$|^LDW_run_)", "Temp"),
    ]

    for f in files:
        full = os.path.join(dset, f)
        for pat, sub in rules:
            if re.search(pat, f):
                dst_dir = os.path.join(dset, sub)
                os.makedirs(dst_dir, exist_ok=True)
                dst = os.path.join(dst_dir, f)
                if not os.path.exists(dst):
                    if os.path.isdir(full):
                        shutil.copytree(full, dst)
                    else:
                        shutil.copy2(full, dst)
                moved.append(f)
                break

    for f in set(moved):
        full = os.path.join(dset, f)
        if not delete_after_moving:
            old = os.path.join(dset, "OLD")
            os.makedirs(old, exist_ok=True)
            dst = os.path.join(old, f)
            if os.path.exists(dst):
                if os.path.isdir(dst):
                    shutil.rmtree(dst)
                else:
                    os.unlink(dst)
            shutil.move(full, dst)
        else:
            if os.path.isdir(full):
                shutil.rmtree(full)
            else:
                os.unlink(full)
