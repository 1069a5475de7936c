"""GFF3 + reference FASTA input (the GFF3 branch of BLK2: CDS features
from the GFF3's CDS rows, the genome name from its seqid) and BLK8's use
of them, port against the JAX package, on the E2E_SMOKE input of
tests/test_torch_pipeline.py with default config (SnpEff_Annotate=True).
The test writes the GFF3 and the FASTA from the synthetic GenBank
reference.

Temp/sr_annotations.tsv must be equal on the positions both runs
annotate, and the SR and LR tophits agree as in
tests/test_torch_annotate_pipeline.py.  Observed on the CPU: both runs
annotate the same 2,238 SR positions; SR tophits 0 of 250 rows on one
side only, LR tophits 12 of 500 (the tie group at the cut, MI
0.173591628670692)."""

import os

import pandas as pd
import pytest

from tests.test_torch_annotate_pipeline import KW, assert_tophits_agree


def write_gff3_and_fasta(gbk_path, gff_path, fa_path):
    from ldweaver_tpu_torch.io.genbank import parse_genbank

    rec = parse_genbank(gbk_path)
    with open(gff_path, "wt") as fh:
        fh.write("##gff-version 3\n")
        fh.write(f"##sequence-region {rec.name} 1 {len(rec.sequence)}\n")
        for k, f in enumerate(x for x in rec.features if x.type in ("gene", "CDS")):
            strand = "+" if f.strand > 0 else "-"
            attrs = [f"ID={f.type.lower()}{k}", f"gene={f.gene}"]
            if f.type == "CDS":
                attrs += [f"locus_tag={f.locus_tag}", f"product={f.product}"]
            phase = "0" if f.type == "CDS" else "."
            fh.write(f"{rec.name}\tsynthetic\t{f.type}\t{f.start}\t{f.end}\t.\t"
                     f"{strand}\t{phase}\t{';'.join(attrs)}\n")
    with open(fa_path, "wt") as fh:
        fh.write(f">{rec.name}\n")
        for i in range(0, len(rec.sequence), 60):
            fh.write(rec.sequence[i : i + 60] + "\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import ldweaver_tpu
    import ldweaver_tpu_torch
    from examples.bench_e2e import synth_alignment

    d = tmp_path_factory.mktemp("gff3_e2e")
    fa, gbk = str(d / "aln.fa.gz"), str(d / "ref.gbk")
    synth_alignment(fa, gbk, nseq=24, g=100_000, nsnp=2500)
    gff, ref = str(d / "ref.gff3"), str(d / "ref.fa")
    write_gff3_and_fasta(gbk, gff, ref)
    kw = dict(aln_path=fa, gff3_path=gff, ref_fasta_path=ref, **KW)
    ldweaver_tpu.ldweaver(dset=str(d / "jax"), **kw)
    ldweaver_tpu_torch.ldweaver(dset=str(d / "torch"), device="cpu", **kw)
    return d


def test_gff3_sr_annotations_equal_on_shared_positions(runs):
    path = os.path.join("Temp", "sr_annotations.tsv")
    aj = pd.read_csv(runs / "jax" / path, sep="\t").set_index("pos")
    at = pd.read_csv(runs / "torch" / path, sep="\t").set_index("pos")
    shared = aj.index.intersection(at.index)
    assert len(shared) > 0.99 * len(aj)
    assert aj.loc[shared].equals(at.loc[shared])
    # the GFF3's CDS rows were read: coding SNPs, named by the GFF3's genes
    assert {"ns", "sy"} <= set(at["code"])
    assert at["description"].str.startswith("g").all()
    vcf = open(runs / "torch" / "Temp" / "sr_snps.vcf").read().splitlines()
    assert vcf[4].startswith("SYNPNEUMO.1\t")  # genome name: the GFF3 seqid


@pytest.mark.parametrize("kind", ["sr", "lr"])
def test_gff3_tophits_agree(runs, kind):
    assert_tophits_agree(str(runs / "jax"), str(runs / "torch"), kind)
