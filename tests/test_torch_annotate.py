"""The port's annotation subsystem (`ldweaver_tpu_torch.annotate`) against
the JAX package's on the same numpy-seeded inputs: the built-in
annotator, the snpEff ANN parser, the link join, the tophit filter, the
files of perform_annotations, and the snpEff subprocess path through the
fake `java` of tests/test_snpeff_subprocess.py.  Everything must be
equal: the module is host code, copied."""

import importlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

import ldweaver_tpu.annotate as jann
import ldweaver_tpu_torch.annotate as tann
from tests.test_annotate import _ANN_CORPUS
from tests.test_snpeff_subprocess import fake_java  # noqa: F401  (fixture)

PKGS = (("jax", jann), ("torch", tann))
G = 3000


def reference(seed=0):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=G))


def features(pkg, kind):
    """A plus-strand CDS, a complement() CDS, a join() CDS (segments
    1200-1299 and 1310-1509), a complement(join()) CDS and a CDS named by
    its locus tag only; GFF features have plain spans and '+'/'-'."""
    root = "ldweaver_tpu" if pkg == "jax" else "ldweaver_tpu_torch"
    spans = [((100, 399), 1, "gA", "T1"), ((600, 899), -1, "gB", "T2"),
             ((1200, 1299), (1310, 1509), 1, "gJ", "T3"),
             ((1700, 1799), (1803, 2002), -1, "gR", "T4"),
             ((2300, 2599), 1, None, "T5")]
    out = []
    for *segs, strand, gene, tag in spans:
        named = {"gene": gene} if gene else {}
        if kind == "genbank":
            Feature = importlib.import_module(f"{root}.io.genbank").Feature
            out.append(Feature(type="CDS", start=segs[0][0], end=segs[-1][1],
                               strand=strand, segments=list(segs),
                               qualifiers={"locus_tag": tag, **named}))
        else:
            GffFeature = importlib.import_module(f"{root}.io.gff").GffFeature
            out.append(GffFeature(seqid="SYN.1", source="synthetic", type="CDS",
                                  start=segs[0][0], end=segs[-1][1], score=None,
                                  strand="+" if strand > 0 else "-", phase=0,
                                  attributes={"ID": f"cds-{tag}", "locus_tag": tag,
                                              **named}))
    return out


def snp_inputs(ref, seed=1):
    """Sorted SNP positions in every CDS, in the join gaps and between
    genes; ALT strings with one, two (multi-allelic) and no allele and an N
    call; a random allele table."""
    rng = np.random.default_rng(seed)
    pos = np.unique(np.concatenate([
        rng.choice(np.arange(100, 400), 12, replace=False),
        rng.choice(np.arange(600, 900), 12, replace=False),
        rng.choice(np.arange(1200, 1510), 12, replace=False),
        np.array([1300, 1305, 1309, 1800, 1802]),  # join gaps
        rng.choice(np.arange(1700, 2003), 12, replace=False),
        rng.choice(np.arange(2300, 2600), 6, replace=False),
        np.array([20, 450, 1000, 2100, 2900]),  # intergenic
    ]))
    ref_a = np.array([ref[p - 1] for p in pos])
    alt = []
    for k, r in enumerate(ref_a):
        others = [b for b in "ACGT" if b != r]
        picks = rng.choice(others, size=1 + (k % 4 == 0), replace=False)
        a = ",".join(sorted(picks))
        if k % 9 == 0:
            a += ",N"
        alt.append("" if k % 17 == 5 else a)
    table = rng.integers(0, 30, size=(5, pos.size)).astype(np.int64)
    table[0] += 1
    return pos, ref_a, np.array(alt), table


@pytest.mark.parametrize("kind", ["genbank", "gff"])
def test_annotate_internal_equal(kind):
    ref = reference()
    pos, ref_a, alt, table = snp_inputs(ref)
    out = {}
    for pkg, mod in PKGS:
        out[pkg] = mod.annotate_internal(pos, np.arange(pos.size), ref_a, alt,
                                         features(pkg, kind), ref, table, 50)
    pd.testing.assert_frame_equal(out["jax"], out["torch"])
    ann = out["torch"]
    assert {"ns", "sy", "ig"} <= set(ann["code"])
    assert (ann["annotation"] == "intron_variant").any() == (kind == "genbank")
    assert (ann["ALT"].str.count(",") >= 1).any()


def test_convert_vcfann_to_table_equal(tmp_path):
    vcf = tmp_path / "ann.vcf"
    lines = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for i, (ref, alt, info, *_exp) in enumerate(_ANN_CORPUS):
        lines.append(f"CHR\t{100 + i}\t.\t{ref}\t{alt}\t.\t.\t{info}")
    vcf.write_text("\n".join(lines) + "\n")
    n = len(_ANN_CORPUS)
    table = np.random.default_rng(2).integers(1, 40, size=(5, n)).astype(np.int64)
    out = [mod.convert_vcfann_to_table(str(vcf), np.arange(n), table, 100)
           for _, mod in PKGS]
    pd.testing.assert_frame_equal(*out)


def random_links(seed, n_links=400, n_snps=120):
    """Links over n_snps positions with tied srp and MI values, and their
    per-SNP annotation table."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(np.arange(1, 100_000), n_snps, replace=False))
    i = rng.integers(0, n_snps - 1, n_links)
    j = np.minimum(i + rng.integers(1, 10, n_links), n_snps - 1)
    links = pd.DataFrame(dict(
        pos1=pos[i], pos2=pos[j], len=(pos[j] - pos[i]).astype(float),
        MI=np.round(rng.random(n_links), 2), srp_max=np.round(rng.random(n_links) * 8, 1),
        ARACNE=rng.integers(0, 2, n_links),
    ))
    ann = pd.DataFrame(dict(
        pos=pos, REF=rng.choice(list("ACGT"), n_snps),
        ALT=rng.choice(list("ACGT"), n_snps),
        annotation=rng.choice(["missense_variant", "synonymous_variant"], n_snps),
        description=[f"d{p}" for p in pos],
        cds=rng.choice([f"g{k}" for k in range(15)], n_snps),
        code=rng.choice(["ns", "sy", "ig"], n_snps),
        allele_dist=["A:0.5, C:0.5"] * n_snps,
    ))
    return links, ann


@pytest.mark.parametrize("links_type", ["SR", "LR"])
def test_add_annotations_and_detect_top_hits_equal(links_type):
    links, ann = random_links(3)
    joined = [mod.add_annotations_to_links(links, ann, links_type) for _, mod in PKGS]
    pd.testing.assert_frame_equal(*joined)
    top = [mod.detect_top_hits(joined[0], max_tophits=60) for _, mod in PKGS]
    pd.testing.assert_frame_equal(*top)
    assert len(top[1]) == 60


def annotation_inputs():
    ref = reference()
    pos, ref_a, alt, table = snp_inputs(ref)
    snp_data = SimpleNamespace(pos=pos, nseq=50, g=G)
    cds_var = SimpleNamespace(ref=ref_a, alt=alt, allele_table=table)
    rng = np.random.default_rng(4)
    i = rng.integers(0, pos.size - 1, 150)
    j = np.minimum(i + rng.integers(1, 20, 150), pos.size - 1)
    keep = i != j
    links = pd.DataFrame(dict(
        pos1=pos[i][keep], pos2=pos[j][keep],
        len=(pos[j] - pos[i])[keep].astype(float),
        MI=rng.random(keep.sum()), srp_max=rng.random(keep.sum()) * 8,
        ARACNE=rng.integers(0, 2, keep.sum()),
    ))
    return ref, snp_data, cds_var, links


@pytest.mark.parametrize("links_type", ["SR", "LR"])
def test_perform_annotations_files_equal(tmp_path, links_type):
    ref, snp_data, cds_var, links = annotation_inputs()
    prefix = links_type.lower()
    for pkg, mod in PKGS:
        mod.perform_annotations(
            dset_name="dset", annotation_folder=str(tmp_path / pkg),
            snp_data=snp_data, cds_var=cds_var, links_df=links,
            genome_name="SYN.1", g=G, cds_features=features(pkg, "genbank"),
            ref_seq=ref, max_tophits=50, links_type=links_type,
        )
    for name in (f"{prefix}_snps.vcf", f"{prefix}_annotations.tsv",
                 f"{prefix}_links_annotated.tsv", f"{prefix}_tophits.tsv"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert len(a) > 0 and a == b, name


def test_snpeff_subprocess_path_equal(tmp_path, fake_java):  # noqa: F811
    """Both packages drive the same java command lines and write the same
    tables; each runs in the same folder in turn, so the logged paths
    match."""
    jar = tmp_path / "snpEff.jar"
    jar.write_bytes(b"fake jar")
    gbk = tmp_path / "toy.gbk"
    gbk.write_text("LOCUS TOY 10 bp\n//\n")
    _, snp_data, cds_var, links = annotation_inputs()
    work = tmp_path / "ann"
    calls, tables = {}, {}
    for pkg, mod in PKGS:
        fake_java.write_text("")
        mod.perform_annotations(
            dset_name="toydset", annotation_folder=str(work), snp_data=snp_data,
            cds_var=cds_var, links_df=links, genome_name="TOYGENOME.1", g=G,
            cds_features=[], ref_seq="A" * G, snpeff_jar=str(jar),
            gbk_path=str(gbk), links_type="SR",
        )
        calls[pkg] = fake_java.read_text().splitlines()
        tables[pkg] = {name: (work / name).read_bytes() for name in (
            "sr_snps_ann.vcf", "sr_annotations.tsv", "sr_links_annotated.tsv",
            "sr_tophits.tsv")}
        tables[pkg]["config"] = (work / "snpEff.config").read_bytes()
        shutil.move(str(work), str(tmp_path / pkg))
    assert len(calls["torch"]) == 2 and calls["jax"] == calls["torch"]
    assert tables["jax"] == tables["torch"]
    assert tables["torch"]["sr_links_annotated.tsv"].count(b"\n") == len(links) + 1
    assert os.path.exists(tmp_path / "torch" / "snpEff_data" / "toydset" / "genes.gbk")
