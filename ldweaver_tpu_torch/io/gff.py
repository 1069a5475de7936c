"""GFF3 + reference-FASTA annotation input.

Reference: `parse_gff_file` (R/parseGFF.R:19-32), `read_ReferenceFasta`
(R/io_functions.R:177-195) and `read_GFF3_Annotation`
(R/io_functions.R:211-218, via ape::read.gff).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional
from urllib.parse import unquote

import numpy as np

from ldweaver_tpu_torch.io.fasta import iter_fasta


@dataclasses.dataclass
class GffFeature:
    seqid: str
    source: str
    type: str
    start: int
    end: int
    score: Optional[float]
    strand: str
    phase: Optional[int]
    attributes: dict

    # annotation accessors aligned with io.genbank.Feature so downstream
    # consumers (annotate.py, tanglegram.py) handle both sources
    @property
    def gene(self) -> Optional[str]:
        return self.attributes.get("gene") or self.attributes.get("Name")

    @property
    def locus_tag(self) -> Optional[str]:
        return (
            self.attributes.get("locus_tag")
            or self.attributes.get("ID")
        )

    @property
    def product(self) -> Optional[str]:
        return self.attributes.get("product")


@dataclasses.dataclass
class GffAnnotation:
    """Equivalent of the reference gff list (R/parseGFF.R:30)."""

    features: List[GffFeature]
    ref: str  # reference sequence (string)
    ref_name: str
    g: int
    gff_path: str
    ref_path: str

    def cds_ranges(self):
        cds = [f for f in self.features if f.type.lower() == "cds"]
        starts = np.array([f.start for f in cds], dtype=np.int64)
        ends = np.array([f.end for f in cds], dtype=np.int64)
        return starts, ends

    @property
    def seqid(self) -> str:
        return self.features[0].seqid if self.features else self.ref_name


def read_reference_fasta(ref_fasta_path: str):
    """First (only) sequence of a fasta file (R/io_functions.R:177-195)."""
    for name, seq in iter_fasta(ref_fasta_path):
        s = seq.decode()
        if len(s) <= 0:
            raise ValueError("empty sequence!")
        return s, name, len(s)
    raise ValueError("empty sequence!")


def _parse_attributes(s: str) -> dict:
    out = {}
    for item in s.split(";"):
        item = item.strip()
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = unquote(v)
    return out


def read_gff3(gff3_path: str) -> List[GffFeature]:
    feats: List[GffFeature] = []
    with open(gff3_path, "rt") as fh:
        for line in fh:
            if line.startswith("##FASTA"):
                break
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            feats.append(
                GffFeature(
                    seqid=parts[0],
                    source=parts[1],
                    type=parts[2],
                    start=int(parts[3]),
                    end=int(parts[4]),
                    score=None if parts[5] == "." else float(parts[5]),
                    strand=parts[6],
                    phase=None if parts[7] == "." else int(parts[7]),
                    attributes=_parse_attributes(parts[8]),
                )
            )
    return feats


def parse_gff_file(
    gff3_path: str, ref_fasta_path: str, perform_length_check: bool = True
) -> GffAnnotation:
    """R/parseGFF.R:19-32 with the same range sanity checks."""
    ref, ref_name, g = read_reference_fasta(ref_fasta_path)
    feats = read_gff3(gff3_path)
    if perform_length_check and feats:
        starts = np.array([f.start for f in feats])
        ends = np.array([f.end for f in feats])
        if min(starts.min(), ends.min()) < 0:
            raise ValueError("Invalid start position found!")  # :25
        if max(starts.max(), ends.max()) > g:
            raise ValueError("Invalid stop position found!")  # :26
        if (ends < starts).any():
            raise ValueError("Invalid start-stop pair found!")  # :27
    return GffAnnotation(
        features=feats,
        ref=ref,
        ref_name=ref_name,
        g=g,
        gff_path=gff3_path,
        ref_path=ref_fasta_path,
    )
