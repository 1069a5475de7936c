"""Minimal GenBank parser for the fields the pipeline actually uses.

The reference vendors the full genbankr parser (R/parseGBK.R, 1077 lines),
but the pipeline only consumes:
  * CDS ranges + strand + gene/locus_tag/product  (R/estimateCDSDiversity.R:42-44,
    R/createTanglegram.R:88-137, annotation joins)
  * gene ranges (tanglegram locus lookup)
  * the ORIGIN reference sequence  (R/estimateCDSDiversity.R:47)
  * the genome/locus name  (R/SnpEffAnnotations.R:57)
  * the sequence length for the g sanity check  (R/BacGWES.R:311,341)

This is a from-scratch flat-file parser for exactly that subset.  Compound
`join(...)` locations are recorded with their overall span (start of first
segment .. end of last) plus the raw segment list; bacterial CDS joins are
rare and the diversity statistic only needs the span.
"""

from __future__ import annotations

import dataclasses
import gzip
import re
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Feature:
    type: str
    start: int  # 1-based inclusive span start
    end: int  # 1-based inclusive span end
    strand: int  # +1 / -1
    segments: List[Tuple[int, int]]
    qualifiers: dict

    @property
    def gene(self) -> Optional[str]:
        return self.qualifiers.get("gene")

    @property
    def locus_tag(self) -> Optional[str]:
        return self.qualifiers.get("locus_tag")

    @property
    def product(self) -> Optional[str]:
        return self.qualifiers.get("product")


@dataclasses.dataclass
class GenBankRecord:
    """Stand-in for the reference GenBankRecord S4 object
    (R/parseGBK.R:963-975) restricted to load-bearing slots."""

    name: str  # LOCUS / accession (genome name)
    length: int
    sequence: str
    features: List[Feature]
    definition: str = ""

    @property
    def cds(self) -> List[Feature]:
        return [f for f in self.features if f.type == "CDS"]

    @property
    def genes(self) -> List[Feature]:
        return [f for f in self.features if f.type == "gene"]

    def cds_ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        starts = np.array([f.start for f in self.cds], dtype=np.int64)
        ends = np.array([f.end for f in self.cds], dtype=np.int64)
        return starts, ends


_LOCATION_NUM = re.compile(r"[<>]?(\d+)")


def _parse_location(loc: str) -> Tuple[int, int, int, List[Tuple[int, int]]]:
    """Parse a GenBank location string -> (start, end, strand, segments)."""
    strand = 1
    s = loc.strip()
    # strip nested complement(...) / join(...) / order(...)
    changed = True
    while changed:
        changed = False
        if s.startswith("complement(") and s.endswith(")"):
            strand = -strand
            s = s[len("complement(") : -1]
            changed = True
        for kw in ("join(", "order("):
            if s.startswith(kw) and s.endswith(")"):
                s = s[len(kw) : -1]
                changed = True
    segments = []
    for part in s.split(","):
        part = part.strip()
        if part.startswith("complement(") and part.endswith(")"):
            part = part[len("complement(") : -1]
        nums = _LOCATION_NUM.findall(part)
        if not nums:
            continue
        a = int(nums[0])
        b = int(nums[-1])
        segments.append((min(a, b), max(a, b)))
    if not segments:
        raise ValueError(f"unparseable GenBank location: {loc!r}")
    start = min(a for a, _ in segments)
    end = max(b for _, b in segments)
    return start, end, strand, segments


def _open_text(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def parse_genbank(path: str) -> GenBankRecord:
    name = ""
    definition = ""
    length = 0
    features: List[Feature] = []
    seq_chunks: List[str] = []

    with _open_text(path) as fh:
        lines = fh.read().splitlines()

    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if line.startswith("LOCUS"):
            parts = line.split()
            if len(parts) >= 2:
                name = parts[1]
            for j, p in enumerate(parts):
                if p == "bp" and j >= 1 and parts[j - 1].isdigit():
                    length = int(parts[j - 1])
        elif line.startswith("DEFINITION"):
            definition = line[10:].strip()
        elif line.startswith("VERSION"):
            parts = line.split()
            if len(parts) >= 2:
                name = parts[1]  # genbankr uses the versioned accession
        elif line.startswith("FEATURES"):
            i += 1
            # feature table: 5-space indent = new feature; 21-space = continuation
            cur_type = None
            cur_loc: List[str] = []
            quals: dict = {}
            pending_qual: Optional[str] = None

            def flush():
                if cur_type is None:
                    return
                try:
                    start, end, strand, segs = _parse_location("".join(cur_loc))
                except ValueError:
                    return
                features.append(
                    Feature(cur_type, start, end, strand, segs, dict(quals))
                )

            while i < n:
                line = lines[i]
                if line.startswith("ORIGIN") or (
                    line and not line.startswith(" ")
                ):
                    break
                stripped = line.strip()
                if len(line) > 5 and line[5] != " " and line[:5] == "     ":
                    flush()
                    parts = stripped.split(None, 1)
                    cur_type = parts[0]
                    cur_loc = [parts[1]] if len(parts) > 1 else []
                    quals = {}
                    pending_qual = None
                elif stripped.startswith("/"):
                    m = re.match(r"/([\w\-]+)(?:=(.*))?$", stripped)
                    if m:
                        key, val = m.group(1), m.group(2)
                        if val is None:
                            quals[key] = True
                            pending_qual = None
                        else:
                            val = val.strip()
                            if val.startswith('"') and (
                                not val.endswith('"') or len(val) == 1
                            ):
                                pending_qual = key
                                quals[key] = val[1:]
                            else:
                                quals[key] = val.strip('"')
                                pending_qual = None
                elif pending_qual is not None:
                    v = stripped
                    if v.endswith('"'):
                        quals[pending_qual] += " " + v[:-1]
                        pending_qual = None
                    else:
                        quals[pending_qual] += " " + v
                elif cur_type is not None and not quals and pending_qual is None:
                    cur_loc.append(stripped)  # wrapped location
                i += 1
            flush()
            continue
        elif line.startswith("ORIGIN"):
            i += 1
            while i < n and not lines[i].startswith("//"):
                seq_chunks.append(
                    "".join(c for c in lines[i] if c.isalpha())
                )
                i += 1
            continue
        i += 1

    sequence = "".join(seq_chunks).upper()
    if length == 0:
        length = len(sequence)
    return GenBankRecord(
        name=name,
        length=length,
        sequence=sequence,
        features=features,
        definition=definition,
    )


def parse_genbank_file(
    gbk_path: str, g: Optional[int] = None, length_check: bool = True
):
    """Equivalent of LDWeaver::parse_genbank_file (R/parseGBK.R:27-86):
    parse + optional alignment-length validation.  Returns (record, ref_g).
    """
    rec = parse_genbank(gbk_path)
    ref_g = rec.length if rec.length else len(rec.sequence)
    if length_check and g is not None and ref_g != g:
        raise ValueError(
            f"Alignment length {g} does not match the reference length "
            f"{ref_g} in the GenBank file"
        )
    return rec, ref_g
