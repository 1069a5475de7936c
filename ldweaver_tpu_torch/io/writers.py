"""TSV / artifact writers matching the reference's output formats.

Schemas (reference):
  * lr_links.tsv - no header: pos1 pos2 clust1 clust2 len MI
    (R/computePairwiseMI.R:326-331,362; read back by R/io_functions.R:35)
  * sr_links.tsv - no header:
    clust_c pos1 pos2 clust1 clust2 len MI srp_max ARACNE
    (R/computePairwiseMI.R:140; schema R/BacGWES.R:385)
  * annotated links / tophits - headered TSV (R/SnpEffAnnotations.R:389,399)
  * GWESExplorer: snps.loci / snps.aln / snps.outliers
    (R/createGWESExplorerOutput.R:23-76)

Numbers are written with up to 15 significant digits like R's
write.table (as.character on doubles).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Sequence

import numpy as np


def format_float(x: float) -> str:
    """R as.character() style: up to 15 significant digits, no trailing
    zeros, integral values without a decimal point."""
    if np.isnan(x):
        return "NA"
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    s = f"{x:.15g}"
    return s


def append_tsv_rows(path: str, rows: Iterable[Sequence[str]]) -> None:
    with open(path, "at") as fh:
        for row in rows:
            fh.write("\t".join(row) + "\n")


def write_tsv(path: str, header: Sequence[str], columns: Sequence[np.ndarray]):
    """Headered TSV (write.table(..., col.names=T, row.names=F, quote=F))."""
    n = len(columns[0]) if columns else 0
    with open(path, "wt") as fh:
        fh.write("\t".join(header) + "\n")
        for i in range(n):
            cells = []
            for col in columns:
                v = col[i]
                if isinstance(v, (float, np.floating)):
                    cells.append(format_float(float(v)))
                elif isinstance(v, (int, np.integer)):
                    cells.append(str(int(v)))
                else:
                    cells.append(str(v))
            fh.write("\t".join(cells) + "\n")


def save_cluster_fits(fits: Dict[int, object], plt_folder: str) -> None:
    """Persist per-cluster background-fit data (the reference saves
    cX_fit_data.rds + cX_fit.png, R/computePairwiseMI.R:439-440)."""
    os.makedirs(plt_folder, exist_ok=True)
    for ci, fit in fits.items():
        np.savez_compressed(
            os.path.join(plt_folder, f"c{ci}_fit_data.npz"),
            lens=fit.lens,
            q95=fit.q95,
            fitted=fit.fitted,
            coef=np.asarray(fit.coef),
            beta_shape=np.asarray(fit.beta_shape),
        )
        try:
            from ldweaver_tpu_torch.plots import plot_cluster_fit

            plot_cluster_fit(fit, ci, os.path.join(plt_folder, f"c{ci}_fit.png"))
        except Exception:
            pass


def write_gwes_explorer_output(
    snp_data, tophits: dict, folder: str, links_type: str = "SR"
) -> None:
    """GWESExplorer export (R/createGWESExplorerOutput.R:23-76).

    tophits: dict of column arrays with keys pos1,pos2,len,ARACNE,MI and
    (for SR) srp.
    """
    os.makedirs(folder, exist_ok=True)
    loci_path = os.path.join(folder, "snps.loci")
    aln_path = os.path.join(folder, "snps.aln")
    outliers_path = os.path.join(folder, "snps.outliers")

    gwex_snps = np.unique(
        np.concatenate([tophits["pos1"], tophits["pos2"]])
    ).astype(np.int64)
    # index into snp.dat$POS (:32)
    idx = np.searchsorted(snp_data.pos, gwex_snps)

    with open(loci_path, "wt") as fh:
        for p in gwex_snps:
            fh.write(f"{int(p)}\n")

    chars = snp_data.to_fasta_rows(idx)  # [nseq, nsel]
    with open(aln_path, "wt") as fh:
        for i in range(snp_data.nseq):
            fh.write(f">{snp_data.seq_names[i]}\n")
            fh.write(chars[i].tobytes().decode() + "\n")

    # outliers table (space-separated, col.names=T - write.table default sep)
    if links_type == "SR":
        mi_col = tophits["srp"]
    else:
        mi_col = tophits["MI"]
    with open(outliers_path, "wt") as fh:
        fh.write("Pos_1 Pos_2 Distance Direct MI MI_wogaps\n")
        for i in range(len(tophits["pos1"])):
            fh.write(
                " ".join(
                    [
                        format_float(float(tophits["pos1"][i])),
                        format_float(float(tophits["pos2"][i])),
                        format_float(float(tophits["len"][i])),
                        format_float(float(tophits["ARACNE"][i])),
                        format_float(float(mi_col[i])),
                        format_float(float(tophits["MI"][i])),
                    ]
                )
                + "\n"
            )


def snpdat_to_fa(
    snp_data,
    aln_path: str,
    pos_path: str = None,
    pos: np.ndarray = None,
    format: str = "fasta",
):
    """SNP-subset fasta/tsv export (R/io_functions.R:363-417)."""
    if format not in ("fasta", "tsv"):
        format = "fasta"
    if format == "fasta" and pos_path is None:
        raise ValueError(
            "Saving in fasta format requires a path for the pos file <pos_path>"
        )
    if pos is None:
        snps_idx = np.arange(snp_data.pos.size)
        pos = snp_data.pos
    else:
        pos = np.sort(np.asarray(pos, dtype=np.int64))
        if np.unique(pos).size != pos.size:
            raise ValueError("Duplicated entries found in pos")
        snps_idx = np.searchsorted(snp_data.pos, pos)
        if not np.array_equal(snp_data.pos[snps_idx], pos):
            raise ValueError("pos cannot be extracted from snp.dat")
    chars = snp_data.to_fasta_rows(snps_idx)
    if format == "fasta":
        with open(aln_path, "wt") as fh:
            for i in range(snp_data.nseq):
                fh.write(f">{snp_data.seq_names[i]}\n")
                fh.write(chars[i].tobytes().decode() + "\n")
        with open(pos_path, "wt") as fh:
            for p in pos:
                fh.write(f"{int(p)}\n")
    else:
        with open(aln_path, "wt") as fh:
            fh.write("\t".join(str(int(p)) for p in pos) + "\n")
            for i in range(snp_data.nseq):
                fh.write(
                    snp_data.seq_names[i]
                    + "\t"
                    + "\t".join(chars[i].tobytes().decode())
                    + "\n"
                )


def generate_links_snps_fasta(
    snp_data,
    aln_path: str,
    pos_path: str,
    lr_tophits_path: str = None,
    lr_annotated_links_path: str = None,
    sr_tophits_path: str = None,
    sr_annotated_links_path: str = None,
):
    """SNP fasta restricted to loci appearing in link files - the input
    for detailed tree plots (generate_Links_SNPS_fasta,
    R/io_functions.R:432-460)."""
    from ldweaver_tpu_torch.io import readers

    paths = [
        (lr_tophits_path, readers.read_top_hits),
        (sr_tophits_path, readers.read_top_hits),
        (lr_annotated_links_path, readers.read_annotated_links),
        (sr_annotated_links_path, readers.read_annotated_links),
    ]
    if all(p is None for p, _ in paths):
        raise ValueError("At least one links file must be provided")
    pos = []
    for p, reader in paths:
        if p is not None:
            df = reader(p)
            pos.extend(df["pos1"].tolist())
            pos.extend(df["pos2"].tolist())
    pos = np.unique(np.asarray(pos, dtype=np.int64))
    snpdat_to_fa(snp_data, aln_path, pos_path, pos=pos, format="fasta")
