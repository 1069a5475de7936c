"""Command-line interface of the PyTorch port, mirroring the LDWeaver()
argument surface (R/BacGWES.R:69-75) and the reference package's CLI: one
command line parses in both.

    python -m ldweaver_tpu_torch.cli run --dset out --aln alignment.fa.gz \
        --gbk ref.gbk [--device cuda|cpu]
    python -m ldweaver_tpu_torch.cli lr-analyse --dset out \
        --lr-links out/Temp/lr_links.tsv --sr-links out/Temp/sr_links.tsv

`run --device` (default cuda) is the entry points' `device` argument;
`run --backend` defaults to fast, as in the reference package's CLI.
`--n-devices` shards BLK5 over local devices; `--coordinator host:port
--num-processes N --process-id I` joins N processes over
`torch.distributed` (gloo) before anything touches CUDA
(parallel/multihost.py), and every process writes the same outputs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

def build_parser():
    p = argparse.ArgumentParser(prog="ldweaver-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="full GWES pipeline (LDWeaver())")
    run.add_argument("--dset", required=True)
    run.add_argument("--aln", required=True, dest="aln_path")
    run.add_argument("--gbk", dest="gbk_path")
    run.add_argument("--gff3", dest="gff3_path")
    run.add_argument("--ref-fasta", dest="ref_fasta_path")
    run.add_argument("--pos", help="positions file for SNP-only alignments")
    run.add_argument("--snp-filt-method", default="default",
                     choices=["default", "relaxed"])
    run.add_argument("--gap-freq", type=float, default=0.15)
    run.add_argument("--maf-freq", type=float, default=0.01)
    run.add_argument("--hdw-threshold", type=float, default=0.1)
    run.add_argument("--sr-dist", type=int, default=20000)
    run.add_argument("--lr-retain-links", type=float, default=1e6)
    run.add_argument("--max-tophits", type=int, default=250)
    run.add_argument("--num-clusts-cds", type=int, default=3)
    run.add_argument("--srp-cutoff", type=float, default=3.0)
    run.add_argument("--max-blk-sz", type=int, default=10000)
    run.add_argument("--sr-only", action="store_true")
    run.add_argument("--no-annotate", action="store_true")
    run.add_argument("--no-gwes-explorer", action="store_true")
    run.add_argument("--tanglegram-segments", type=int, default=5)
    run.add_argument("--save-additional-outputs", action="store_true")
    run.add_argument("--no-length-validation", action="store_true")
    run.add_argument("--snpeff-jar", dest="snpeff_jar_path")
    run.add_argument("--backend", default="fast",
                     choices=["jax", "numpy", "pallas", "fast", "spmd"],
                     help="BLK5 sweep (default fast; spmd writes"
                          " byte-identical outputs and reduces the SR table"
                          " on the card, the faster path on one card)")
    run.add_argument("--device", default="cuda",
                     help="torch device of BLK4 and BLK5: cuda (default) or"
                          " cpu (the kernels' plain PyTorch versions)")
    run.add_argument("--coordinator", default=None,
                     help="multi-process coordinator address (host:port of"
                          " process 0)")
    run.add_argument("--num-processes", type=int, default=None,
                     help="total process count")
    run.add_argument("--process-id", type=int, default=None,
                     help="this process's id in [0, num_processes)")
    run.add_argument("--device-budget-bytes", type=int, default=None,
                     help="device-memory cap of the fast backend's slab pool"
                          " (default the card's memory); below the rank"
                          " codes' size the slabs stream")
    run.add_argument("--pipeline-depth", type=int, default=4,
                     help="tiles the fast backend dispatches ahead of the"
                          " host emission (1 = synchronous)")
    run.add_argument("--n-devices", type=int, default=None,
                     help="local devices of the sweep, one shard each"
                          " (default: every card, one a process under"
                          " several processes; on cpu one)")
    run.add_argument("--sr-reduce", default="auto",
                     choices=["auto", "device", "part", "host"],
                     help="where the spmd backend's SR background reduction"
                          " runs: auto on the device when the reduction's"
                          " measured footprint (sr_reduce.FLAT_PASS_BYTES a"
                          " kept pair) fits LDW_SR_BUDGET or 0.35 of the"
                          " card's memory, over several shards the"
                          " partitioned reduction when it fits there (a"
                          " loud WARNING and the host otherwise); device on"
                          " the device whatever its size; part the"
                          " grid-partitioned reduction over several shards"
                          " (auto on one); host copies the SR table to the"
                          " host.  The TSVs"
                          " are byte-identical in every mode")

    lr = sub.add_parser("lr-analyse",
                        help="standalone long-range analysis "
                             "(analyse_long_range_links())")
    lr.add_argument("--dset", required=True)
    lr.add_argument("--lr-links", required=True)
    lr.add_argument("--sr-links", required=True)
    lr.add_argument("--sr-dist", type=int, default=20000)
    lr.add_argument("--from-spydrpick", action="store_true")

    ld = sub.add_parser("ldmap", help="genomewide LD map (genomewide_LDMap())")
    ld.add_argument("--lr-links", required=True)
    ld.add_argument("--sr-links", required=True)
    ld.add_argument("--out", required=True)
    ld.add_argument("--title")
    ld.add_argument("--reducer", type=int)

    fa = sub.add_parser("snp-fasta",
                        help="export SNP-subset fasta (snpdat_to_fa())")
    fa.add_argument("--snp-npz", required=True)
    fa.add_argument("--out-aln", required=True)
    fa.add_argument("--out-pos", required=True)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "run":
        # multi-process bring-up first, before anything touches CUDA
        if args.num_processes or args.coordinator:
            from ldweaver_tpu_torch.parallel.multihost import initialize_multihost

            initialize_multihost(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
        from ldweaver_tpu_torch.config import LDWeaverConfig
        from ldweaver_tpu_torch.pipeline import ldweaver

        pos = None
        if args.pos:
            pos = np.loadtxt(args.pos, dtype=np.int64)
        cfg = LDWeaverConfig(
            snp_filt_method=args.snp_filt_method,
            gap_freq=args.gap_freq,
            maf_freq=args.maf_freq,
            hdw_threshold=args.hdw_threshold,
            perform_SR_analysis_only=args.sr_only,
            SnpEff_Annotate=not args.no_annotate,
            sr_dist=args.sr_dist,
            lr_retain_links=int(args.lr_retain_links),
            max_tophits=args.max_tophits,
            num_clusts_CDS=args.num_clusts_cds,
            srp_cutoff=args.srp_cutoff,
            max_blk_sz=args.max_blk_sz,
            tanglegram_break_segments=args.tanglegram_segments,
            write_gwesExplorer=not args.no_gwes_explorer,
            save_additional_outputs=args.save_additional_outputs,
            n_devices=args.n_devices,
            device_budget_bytes=args.device_budget_bytes,
            pipeline_depth=args.pipeline_depth,
            sr_reduce=args.sr_reduce,
        )
        ldweaver(
            dset=args.dset,
            aln_path=args.aln_path,
            aln_has_all_bases=pos is None,
            pos=pos,
            gbk_path=args.gbk_path,
            gff3_path=args.gff3_path,
            ref_fasta_path=args.ref_fasta_path,
            validate_ref_ann_lengths=not args.no_length_validation,
            snpeff_jar_path=args.snpeff_jar_path,
            config=cfg,
            backend=args.backend,
            device=args.device,
        )
    elif args.cmd == "lr-analyse":
        from ldweaver_tpu_torch.pipeline import analyse_long_range_links

        analyse_long_range_links(
            args.dset,
            args.lr_links,
            args.sr_links,
            links_from_spydrpick=args.from_spydrpick,
            sr_dist=args.sr_dist,
        )
    elif args.cmd == "ldmap":
        from ldweaver_tpu_torch.io import readers
        from ldweaver_tpu_torch.plots import genomewide_ld_map

        genomewide_ld_map(
            readers.read_long_range_links(args.lr_links),
            readers.read_short_range_links(args.sr_links),
            args.out,
            reducer=args.reducer,
            plot_title=args.title,
        )
    elif args.cmd == "snp-fasta":
        from ldweaver_tpu_torch.core.snp_tensor import SnpData
        from ldweaver_tpu_torch.io.writers import snpdat_to_fa

        snpdat_to_fa(
            SnpData.load_npz(args.snp_npz), args.out_aln, args.out_pos
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
