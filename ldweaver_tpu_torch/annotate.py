"""SNP annotation subsystem (PyTorch port; host code, a copy of the
reference package's `annotate.py`).

Reference: R/SnpEffAnnotations.R (perform_snpEff_annotations, prep_snpEff,
VCF writer, ANN parsing, tophit detection).  The reference shells out to a
bundled snpEff.jar, which this repository does not carry, so this module
provides BOTH:

  * the full snpEff subprocess wrapper (config + data dir + build +
    annotate + ANN-field parsing), used when a jar + java are available
    (R/SnpEffAnnotations.R:106-270); and
  * a built-in codon-aware annotator (`annotate_internal`) producing the
    same downstream fields (annotation, description, cds, ns/sy/ig code)
    from the GenBank/GFF CDS ranges + reference sequence directly - the
    standard bacterial codon table, matching snpEff's
    Bacterial_and_Plant_Plastid table for coding effects.

Downstream consumers only use: pos, REF, ALT, annotation, description,
cds, code, allele_dist (R/SnpEffAnnotations.R:281-311, 324-391).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np
import pandas as pd

from ldweaver_tpu_torch.io.writers import format_float


def df_to_tsv(df: "pd.DataFrame", path: str) -> None:
    """Write a DataFrame as TSV with R write.table-style number formatting
    (integral doubles without trailing .0, 15 significant digits)."""
    out = df.copy()
    for col in out.columns:
        if pd.api.types.is_float_dtype(out[col]):
            out[col] = out[col].map(format_float)
    out.to_csv(path, sep="\t", index=False)

# Bacterial_and_Plant_Plastid codon table (NCBI transl_table=11): standard
# code with ATG/GTG/TTG/CTG/ATT/ATC/ATA as possible starts; coding effects
# for substitutions only need the amino-acid map, identical to standard.
_CODON = {}
_BASES = "TCAG"
_AA = (
    "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
)
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            _CODON[_b1 + _b2 + _b3] = _AA[16 * _i + 4 * _j + _k]

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "*": "*"}


def _revcomp(s: str) -> str:
    return "".join(_COMP.get(c, "N") for c in reversed(s))


def _feature_segments(f) -> List:
    """The feature's exon segments, ascending: the parsed join() list for
    GBK features (io/genbank.py Feature.segments), the plain span
    otherwise (GFF features have no compound locations)."""
    segs = getattr(f, "segments", None) or [(f.start, f.end)]
    return sorted(segs)


def _coding_context(f, ref_seq: str, p: int):
    """(codon, ci, minus) for genome position p inside feature f, walking
    the segment list so join() CDSs get the correct reading frame on both
    strands (the span-based frame was wrong for any position after an
    intron-like gap).  Returns None when p falls in a join gap (snpEff
    would report intron_variant there).

    Mirrors snpEff's transcript model as consumed through
    R/SnpEffAnnotations.R:272-311: the coding sequence is the
    concatenation of segments (reverse-complemented on the minus strand,
    so translation runs last-segment-end -> first-segment-start)."""
    segs = _feature_segments(f)
    off_fwd = 0  # offset of p in the forward-strand concatenation
    for s, e in segs:
        if s <= p <= e:
            off_fwd += p - s
            break
        off_fwd += e - s + 1
    else:
        return None  # inside the span but in a join gap
    cds_seq = "".join(ref_seq[s - 1 : e] for s, e in segs).upper()
    minus = _strand_sign(f) < 0
    off = (len(cds_seq) - 1 - off_fwd) if minus else off_fwd
    coding = _revcomp(cds_seq) if minus else cds_seq
    ci = off % 3
    codon = coding[off - ci : off - ci + 3]
    return codon, ci, minus


def _strand_sign(f) -> int:
    """Normalise strand across GBK features (int +/-1) and GFF features
    (string '+'/'-')."""
    s = f.strand
    if isinstance(s, str):
        return -1 if s == "-" else 1
    return -1 if s < 0 else 1


# --------------------------------------------------------------------------
# VCF writing (R/SnpEffAnnotations.R:217-234)
# --------------------------------------------------------------------------
def write_vcf(path: str, genome_name: str, g: int, pos, ref, alt) -> None:
    with open(path, "wt") as fh:
        fh.write("##fileformat=VCF4.1\n")
        fh.write(f"##contig=<ID=1,length={g}>\n")
        fh.write(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        )
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for p, r, a in zip(pos, ref, alt):
            fh.write(f"{genome_name}\t{int(p)}\t.\t{r}\t{a}\t.\t.\t.\n")


# --------------------------------------------------------------------------
# Allele distribution strings (R/SnpEffAnnotations.R:313-322)
# --------------------------------------------------------------------------
def allele_distribution(allele_table: np.ndarray, idx: np.ndarray, nseq: int):
    names = np.array(["A", "C", "G", "T", "N"])
    out = []
    for c in idx:
        col = allele_table[:, c]
        nz = np.flatnonzero(col > 0)
        order = nz[np.argsort(-col[nz], kind="stable")]
        out.append(
            ", ".join(
                f"{names[k]}:{format_float(col[k] / nseq)}" for k in order
            )
        )
    return np.array(out, dtype=object)


# --------------------------------------------------------------------------
# Built-in annotator (snpEff-equivalent classification)
# --------------------------------------------------------------------------
def annotate_internal(
    snps_to_ann: np.ndarray,  # genome positions, sorted unique
    snps_to_ann_idx: np.ndarray,  # indices into snp.dat POS
    ref_alleles: np.ndarray,  # cds_var.ref at those indices
    alt_strings: np.ndarray,  # cds_var.alt at those indices
    cds_features: List,  # Feature-like: start/end/strand/gene/locus_tag/product
    ref_seq: str,
    allele_table: np.ndarray,
    nseq: int,
) -> pd.DataFrame:
    """Classify each SNP as ns / sy / ig with gene context.

    Mirrors the downstream semantics of convert_vcfann_to_table
    (R/SnpEffAnnotations.R:272-311): 'sy' for synonymous/stop-retained,
    'ig' for up/downstream (intergenic), 'ns' otherwise.  The description
    field concatenates gene name, locus identifier and position context
    like the reference's unique()d ANN subfields (:282).
    """
    starts = np.array([f.start for f in cds_features], dtype=np.int64)
    ends = np.array([f.end for f in cds_features], dtype=np.int64)

    rows = []
    for p, ref_a, alt_s in zip(snps_to_ann, ref_alleles, alt_strings):
        p = int(p)
        # find containing CDS (first match, like snpEff's primary annotation)
        hit = np.flatnonzero((starts <= p) & (p <= ends))
        alts = [a for a in str(alt_s).split(",") if a]
        if hit.size == 0:
            # intergenic: nearest gene context
            code = "ig"
            annotation = "intergenic_region"
            if starts.size:
                d_up = np.where(starts > p, starts - p, np.iinfo(np.int64).max)
                d_dn = np.where(ends < p, p - ends, np.iinfo(np.int64).max)
                nearest = int(np.argmin(np.minimum(d_up, d_dn)))
                f = cds_features[nearest]
                gene = f.gene or f.locus_tag or ""
                cds_id = f.locus_tag or f.gene or ""
            else:
                gene = cds_id = ""
            desc = f"{gene}:{cds_id}:intergenic"
        else:
            f = cds_features[int(hit[0])]
            gene = f.gene or f.locus_tag or ""
            cds_id = f.locus_tag or f.gene or ""
            # codon position: segment-aware frame (join() CDSs translate
            # across their exon list, not their span)
            ctx = _coding_context(f, ref_seq, p)
            effects = []
            if ctx is None:
                # inside the CDS span but in a join() gap — snpEff calls
                # this intron_variant; the reference's ANN parser maps it
                # to code "ns" (R/SnpEffAnnotations.R:281-311)
                print(
                    f"WARNING: position {p} falls in a join() gap of CDS "
                    f"{cds_id or gene}; annotating as intron_variant"
                )
                effects = ["intron_variant"]
            else:
                codon, ci, minus = ctx
                for alt in alts:
                    if alt not in "ACGT" or len(codon) < 3:
                        effects.append("non_coding")
                        continue
                    sub = _COMP[alt] if minus else alt
                    mut = codon[:ci] + sub + codon[ci + 1 :]
                    aa0 = _CODON.get(codon, "X")
                    aa1 = _CODON.get(mut, "X")
                    if aa0 == aa1:
                        effects.append(
                            "stop_retained_variant"
                            if aa0 == "*"
                            else "synonymous_variant"
                        )
                    else:
                        effects.append("missense_variant")
            # snpEff reports the first ALT's effect as the primary annotation
            annotation = effects[0] if effects else "non_coding"
            syn = {"synonymous_variant", "stop_retained_variant"}
            if all(e in syn for e in effects if e != "non_coding") and any(
                e in syn for e in effects
            ):
                code = "sy"
            else:
                code = "ns"
            desc = f"{gene}:{cds_id}:{annotation}"
        rows.append(
            dict(
                pos=p,
                REF=str(ref_a),
                ALT=str(alt_s),
                annotation=annotation,
                description=desc,
                cds=cds_id if hit.size else f"{gene}-inter",
                code=code,
            )
        )
    ann = pd.DataFrame(rows)
    ann["allele_dist"] = allele_distribution(allele_table, snps_to_ann_idx, nseq)
    return ann


# --------------------------------------------------------------------------
# snpEff subprocess path (used when java + snpEff.jar exist)
# --------------------------------------------------------------------------
def snpeff_available(snpeff_jar: Optional[str]) -> bool:
    return (
        snpeff_jar is not None
        and os.path.exists(snpeff_jar)
        and shutil.which("java") is not None
    )


def prep_snpeff(
    dset: str,
    genome_name: str,
    snpeff_jar: str,
    work_dir: str,
    gbk_path: Optional[str] = None,
    gff_path: Optional[str] = None,
    ref_path: Optional[str] = None,
    snpeff_template: Optional[str] = None,
) -> str:
    """Build the snpEff data dir + config (R/SnpEffAnnotations.R:106-215)."""
    config = os.path.join(work_dir, "snpEff.config")
    with open(config, "wt") as fh:
        if snpeff_template and os.path.exists(snpeff_template):
            fh.write(open(snpeff_template).read())
        fh.write(f"{dset}.genome : {dset}\n")
        fh.write(f"{dset}.{genome_name}.codonTable : Bacterial_and_Plant_Plastid\n")
    data_dir = os.path.join(work_dir, "snpEff_data")
    if os.path.exists(data_dir):
        shutil.rmtree(data_dir)
    os.makedirs(os.path.join(data_dir, dset))
    if ref_path:
        shutil.copy(ref_path, os.path.join(data_dir, dset, "sequences.fa"))
    if gbk_path:
        shutil.copy(gbk_path, os.path.join(data_dir, dset, "genes.gbk"))
        subprocess.run(
            ["java", "-jar", snpeff_jar, "build", "-genbank", "-config",
             config, "-dataDir", data_dir, "-v", dset],
            check=True,
        )
    if gff_path:
        shutil.copy(gff_path, os.path.join(data_dir, dset, "genes.gff"))
        subprocess.run(
            ["java", "-jar", snpeff_jar, "build", "-gff3", "-noCheckCds",
             "-noCheckProtein", "-config", config, "-dataDir", data_dir,
             "-v", dset],
            check=True,
        )
    return config


def run_snpeff(
    dset: str, snpeff_jar: str, work_dir: str, vcf_in: str, vcf_out: str
) -> None:
    """java -Xmx16G -jar snpEff.jar ... (R/SnpEffAnnotations.R:237-270)."""
    config = os.path.join(work_dir, "snpEff.config")
    data_dir = os.path.join(work_dir, "snpEff_data")
    with open(vcf_out, "wt") as out:
        subprocess.run(
            ["java", "-Xmx16G", "-jar", snpeff_jar, "-v", "-dataDir",
             data_dir, "-config", config, dset, vcf_in],
            stdout=out,
            check=True,
        )


def convert_vcfann_to_table(
    vcf_annotated_path: str,
    snps_to_ann_idx: np.ndarray,
    allele_table: np.ndarray,
    nseq: int,
) -> pd.DataFrame:
    """Parse snpEff ANN fields (R/SnpEffAnnotations.R:272-311)."""
    rows = []
    with open(vcf_annotated_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            pos, ref, alt, info = parts[1], parts[3], parts[4], parts[7]
            info = info.replace('"', "")
            fields = info.split("|")
            annotation = fields[1] if len(fields) > 1 else ""
            desc_parts = [
                fields[i] for i in (3, 4, 9, 10) if i < len(fields)
            ]
            seen = []
            for d in desc_parts:
                if d not in seen:
                    seen.append(d)
            description = ":".join(seen)
            cds = fields[4] if len(fields) > 4 else ""
            rows.append(
                dict(
                    pos=int(pos),
                    REF=ref,
                    ALT=alt,
                    annotation=annotation,
                    description=description,
                    cds=cds,
                )
            )
    ann = pd.DataFrame(rows)
    code = np.full(len(ann), "ns", dtype=object)
    code[ann["annotation"].str.contains("synonymous_variant", na=False)] = "sy"
    code[ann["annotation"].str.contains("stop_retained_variant", na=False)] = "sy"
    code[ann["annotation"].str.contains("downstream_gene_variant", na=False)] = "ig"
    code[ann["annotation"].str.contains("upstream_gene_variant", na=False)] = "ig"
    ann["code"] = code
    ann["allele_dist"] = allele_distribution(allele_table, snps_to_ann_idx, nseq)
    return ann


# --------------------------------------------------------------------------
# Annotation joins + tophits (R/SnpEffAnnotations.R:324-403)
# --------------------------------------------------------------------------
def add_annotations_to_links(
    links: pd.DataFrame, ann: pd.DataFrame, links_type: str = "SR"
) -> pd.DataFrame:
    """Join per-SNP annotations onto links (add_annotations_to_links,
    R/SnpEffAnnotations.R:324-391); SR sorts by srp desc, LR by MI desc."""
    pos_to_row = {int(p): i for i, p in enumerate(ann["pos"].to_numpy())}
    i1 = np.array([pos_to_row[int(p)] for p in links["pos1"]], dtype=np.int64)
    i2 = np.array([pos_to_row[int(p)] for p in links["pos2"]], dtype=np.int64)
    out = dict(
        pos1=links["pos1"].to_numpy(),
        pos2=links["pos2"].to_numpy(),
        len=links["len"].to_numpy(),
        ARACNE=links["ARACNE"].to_numpy(),
        MI=links["MI"].to_numpy(),
    )
    if links_type == "SR":
        out["srp"] = links["srp_max"].to_numpy()
    df = pd.DataFrame(out)
    df["pos1_ann"] = ann["description"].to_numpy()[i1]
    df["pos2_ann"] = ann["description"].to_numpy()[i2]
    df["pos1_genreg"] = ann["cds"].to_numpy()[i1]
    df["pos2_genreg"] = ann["cds"].to_numpy()[i2]
    df["links"] = [
        f"{a}X{b}"
        for a, b in zip(ann["code"].to_numpy()[i1], ann["code"].to_numpy()[i2])
    ]
    df["pos1_ad"] = ann["allele_dist"].to_numpy()[i1]
    df["pos2_ad"] = ann["allele_dist"].to_numpy()[i2]
    key = "srp" if links_type == "SR" else "MI"
    df = df.sort_values(key, ascending=False, kind="stable").reset_index(drop=True)
    return df


def detect_top_hits(
    links_annotated: pd.DataFrame, max_tophits: int = 250
) -> pd.DataFrame:
    """Tophit filter (detect_top_hits, R/SnpEffAnnotations.R:393-403):
    ARACNE-direct, not syXsy, not same gene region, truncated."""
    df = links_annotated
    df = df[df["ARACNE"] == 1]
    df = df[df["links"] != "syXsy"]
    df = df[df["pos1_genreg"] != df["pos2_genreg"]]
    if len(df) > max_tophits:
        df = df.iloc[:max_tophits]
    return df.reset_index(drop=True)


def perform_annotations(
    dset_name: str,
    annotation_folder: str,
    snp_data,
    cds_var,
    links_df: pd.DataFrame,
    genome_name: str,
    g: int,
    cds_features: List,
    ref_seq: str,
    snpeff_jar: Optional[str] = None,
    gbk_path: Optional[str] = None,
    gff_path: Optional[str] = None,
    ref_path: Optional[str] = None,
    tophits_path: Optional[str] = None,
    max_tophits: int = 250,
    links_type: str = "SR",
) -> pd.DataFrame:
    """Full annotation block (perform_snpEff_annotations,
    R/SnpEffAnnotations.R:29-103): VCF prep -> annotate (snpEff when
    available, built-in otherwise) -> join -> tophits.  Writes
    {sr,lr}_snps.vcf, {sr,lr}_annotations.tsv, {sr,lr}_links_annotated.tsv
    and the tophits file."""
    os.makedirs(annotation_folder, exist_ok=True)
    prefix = "lr" if links_type == "LR" else "sr"
    vcf_write_path = os.path.join(annotation_folder, f"{prefix}_snps.vcf")
    vcf_ann_path = os.path.join(annotation_folder, f"{prefix}_snps_ann.vcf")
    annotations_path = os.path.join(annotation_folder, f"{prefix}_annotations.tsv")
    links_annotated_path = os.path.join(
        annotation_folder, f"{prefix}_links_annotated.tsv"
    )
    if tophits_path is None:
        tophits_path = os.path.join(annotation_folder, f"{prefix}_tophits.tsv")

    snps_to_ann = np.unique(
        np.concatenate(
            [links_df["pos1"].to_numpy(), links_df["pos2"].to_numpy()]
        )
    ).astype(np.int64)
    idx = np.searchsorted(snp_data.pos, snps_to_ann)  # :70

    write_vcf(
        vcf_write_path,
        genome_name,
        g,
        snps_to_ann,
        cds_var.ref[idx],
        cds_var.alt[idx],
    )

    if snpeff_available(snpeff_jar):
        prep_snpeff(
            dset_name,
            genome_name,
            snpeff_jar,
            annotation_folder,
            gbk_path=gbk_path,
            gff_path=gff_path,
            ref_path=ref_path,
        )
        run_snpeff(
            dset_name, snpeff_jar, annotation_folder, vcf_write_path, vcf_ann_path
        )
        ann = convert_vcfann_to_table(
            vcf_ann_path, idx, cds_var.allele_table, snp_data.nseq
        )
    else:
        ann = annotate_internal(
            snps_to_ann,
            idx,
            cds_var.ref[idx],
            cds_var.alt[idx],
            cds_features,
            ref_seq,
            cds_var.allele_table,
            snp_data.nseq,
        )

    df_to_tsv(ann, annotations_path)
    links_annotated = add_annotations_to_links(links_df, ann, links_type)
    df_to_tsv(links_annotated, links_annotated_path)
    tophits = detect_top_hits(links_annotated, max_tophits)
    df_to_tsv(tophits, tophits_path)
    return tophits
