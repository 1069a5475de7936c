"""BLK8-BLK12 of the port (annotation, tophits, tanglegram, GWESExplorer
export, network plots, long-range analysis) against the JAX package's, on
the E2E_SMOKE input of tests/test_torch_pipeline.py (24 genomes x 100 kb x
2,500 planted SNPs, backend="spmd", max_blk_sz=1000) with the default
config, SnpEff_Annotate=True.  No snpEff jar: both packages take the
built-in annotator.

Exact part: the JAX package's BLK5 output (Temp/sr_links.tsv and
Temp/lr_links.tsv, plus its Additional_Outputs npz) is copied into two
fresh dsets, and each package resumes from it.  Every data file of
BLK8-BLK12 must then be byte-identical.  Both runs use the same relative
dset name, since the network pages carry it in their titles.

End-to-end part: both packages from the alignment.  On the (pos1, pos2)
rows the SR and LR tophits share, every annotation column is equal.  Top
hits are ARACNE-direct links, so a label flipped by an f32 MI difference
moves a row in or out: the rows on one side only are at most
fringe_bound(n) plus the ARACNE labels that differ between the two runs'
sr_links.tsv.  Observed on the CPU: 13 labels differ on the 3,927 shared
SR rows; SR tophits 0 of 250 rows on one side only; LR tophits 12 of 500,
all in one group of rows tied at the cut (MI 0.173591628670692 in both
runs), which the two runs' LR tables list in another order."""

import json
import os
import shutil

import pandas as pd
import pytest

from tests.test_torch_pipeline import fringe_bound, read_sr

KW = dict(backend="spmd", max_blk_sz=1000)
ANN_COLS = ["pos1_ann", "pos2_ann", "pos1_genreg", "pos2_genreg", "links",
            "pos1_ad", "pos2_ad"]
# (cleanup's folders: Tophits, Annotated_links, Temp, GWESExplorer; BLK9
# writes SR_Tanglegram)
EXACT = [
    "Tophits/sr_tophits.tsv", "Tophits/lr_tophits.tsv",
    "Annotated_links/sr_links_annotated.tsv",
    "Annotated_links/lr_links_annotated.tsv",
    "Temp/sr_annotations.tsv", "Temp/lr_annotations.tsv",
    "Temp/sr_snps.vcf", "Temp/lr_snps.vcf",
    *[f"GWESExplorer/{k}_GWESExplorer/snps.{ext}"
      for k in ("SR", "LR") for ext in ("loci", "aln", "outliers")],
    "SR_Tanglegram/tanglegram_segments.tsv", "SR_Tanglegram/tanglegram.html",
    "Tophits/SR_network_plot.html", "Tophits/lr_network_plot.html",
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import ldweaver_tpu
    import ldweaver_tpu_torch
    from examples.bench_e2e import synth_alignment

    d = tmp_path_factory.mktemp("annotate_e2e")
    fa, gbk = str(d / "aln.fa.gz"), str(d / "ref.gbk")
    synth_alignment(fa, gbk, nseq=24, g=100_000, nsnp=2500)
    kw = dict(aln_path=fa, gbk_path=gbk, **KW)
    ldweaver_tpu.ldweaver(dset=str(d / "jax"), save_additional_outputs=True, **kw)
    ldweaver_tpu_torch.ldweaver(dset=str(d / "torch"), device="cpu", **kw)

    cwd = os.getcwd()
    try:
        for pkg, fn, extra in (("jax", ldweaver_tpu.ldweaver, {}),
                               ("torch", ldweaver_tpu_torch.ldweaver,
                                dict(device="cpu"))):
            (d / f"resume_{pkg}").mkdir()
            os.chdir(d / f"resume_{pkg}")
            for sub, names in (("Temp", ("sr_links.tsv", "lr_links.tsv")),
                               ("Additional_Outputs", ("snp_ACGTN.npz",
                                                       "cds_var.npz", "hdw.npz"))):
                os.makedirs(os.path.join("out", sub))
                for name in names:  # never parsed_gbk.pkl: it pickles classes
                    shutil.copy(d / "jax" / sub / name, os.path.join("out", sub))
            fn(dset="out", **kw, **extra)
    finally:
        os.chdir(cwd)
    return d


@pytest.mark.parametrize("name", EXACT)
def test_blk6_to_blk12_byte_identical(runs, name):
    a = open(runs / "resume_jax" / "out" / name, "rb").read()
    b = open(runs / "resume_torch" / "out" / name, "rb").read()
    assert len(a) > 0 and a == b


def test_default_config_runs_blk1_to_blk12(runs):
    t = json.load(open(runs / "torch" / "timings.json"))
    for blk in ("blk8_annotation_tophits", "blk9_tanglegram",
                "blk10_gwes_explorer", "blk11_network_plot",
                "blk12_lr_analysis"):
        assert blk in t
    for name in EXACT:
        assert os.path.getsize(runs / "torch" / name) > 0, name


def aracne_flips(jax_dset, torch_dset):
    key_j, _, ar_j = read_sr(os.path.join(jax_dset, "Temp", "sr_links.tsv"))
    key_t, _, ar_t = read_sr(os.path.join(torch_dset, "Temp", "sr_links.tsv"))
    lab = dict(zip(key_t, ar_t))
    return sum(lab[k] != a for k, a in zip(key_j, ar_j) if k in lab)


def assert_tophits_agree(jax_dset, torch_dset, kind):
    """Equal annotations on shared rows; rows on one side only within the
    fringe plus the ARACNE flips (module docstring)."""
    path = os.path.join("Tophits", f"{kind}_tophits.tsv")
    tj = pd.read_csv(os.path.join(jax_dset, path), sep="\t").set_index(["pos1", "pos2"])
    tt = pd.read_csv(os.path.join(torch_dset, path), sep="\t").set_index(["pos1", "pos2"])
    assert len(tj) > 100
    shared = tj.index.intersection(tt.index)
    assert tj.loc[shared, ANN_COLS].equals(tt.loc[shared, ANN_COLS])
    one_side = len(tj.index.symmetric_difference(tt.index))
    assert one_side <= fringe_bound(len(tj)) + aracne_flips(jax_dset, torch_dset)


@pytest.mark.parametrize("kind", ["sr", "lr"])
def test_end_to_end_tophits_agree(runs, kind):
    assert_tophits_agree(str(runs / "jax"), str(runs / "torch"), kind)
