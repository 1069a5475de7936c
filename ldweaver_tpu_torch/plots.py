"""Visualisation layer (reference L7) - matplotlib equivalents of the
ggplot2/heatmap3/igraph outputs:

  * make_gwes_plots          (R/prepareGWESplots.R:25-126)
  * cluster fit plots        (R/computePairwiseMI.R:430-440)
  * CDS clustering plot      (R/estimateCDSDiversity.R:212-221)
  * genomewide_LDMap         (R/LDSummaryPlot.R:25-131)
  * lr gwes plot             (R/lr_analyser.R:117-127)
  * create_network           (R/createNetworkPlot.R:28-144)

matplotlib is imported when a figure is drawn.  Where it is not installed
the figure is skipped with a note; no data output depends on a figure,
and the network's HTML page is written either way.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot(path: str):
    """matplotlib.pyplot on the Agg backend, or None (with a note naming
    the skipped figure) when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {path} not drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_cluster_fit(fit, cluster_id: int, path: str) -> None:
    """q95-vs-distance decay fit (cX_fit.png, R/computePairwiseMI.R:430-440)."""
    plt = _pyplot(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(7.3, 4.0), dpi=300)
    ax.scatter(fit.lens, fit.q95, s=4, c="black")
    ax.plot(fit.lens, fit.fitted, c="red", lw=1)
    ax.set_title(f"Clust {cluster_id}")
    ax.set_xlabel("Basepair separation")
    ax.set_ylabel("MI (95th percentile)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_cds_clusters(cds_var, path: str) -> None:
    """Diversity-vs-position scatter coloured by cluster
    (R/estimateCDSDiversity.R:212-221)."""
    plt = _pyplot(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(7.3, 4.0), dpi=300)
    labels = cds_var.clusts.km_clst_ord
    for ci in np.unique(labels):
        sel = labels == ci
        ax.scatter(
            cds_var.cds_start[sel],
            cds_var.var_estimate[sel],
            s=6,
            label=f"{ci}",
        )
    ax.set_xlabel("Genomic starting position of CDS")
    ax.set_ylabel("Diversity within CDS")
    ax.legend(title="Cluster", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def make_gwes_plots(sr_links, plt_folder: str, are_srlinks_ordered=False) -> None:
    """SR GWES scatter plots: per-cluster facets + combined
    (R/prepareGWESplots.R:96-124).  ARACNE==0 greyed; colour = srp_max."""
    plt = _pyplot(os.path.join(plt_folder, "sr_gwes_clust.png"))
    if plt is None:
        return
    os.makedirs(plt_folder, exist_ok=True)
    order = np.argsort(-sr_links.srp_max, kind="stable")
    lens = sr_links.len[order][::-1]
    mi = sr_links.MI[order][::-1]
    srp = sr_links.srp_max[order][::-1]
    ar = sr_links.ARACNE[order][::-1]
    cc = sr_links.clust_c[order][::-1]

    def scatter(ax, sel):
        bg = sel & (ar == 0)
        fg = sel & (ar == 1)
        ax.scatter(lens[bg], mi[bg], s=3, c="#C0C0C0")
        sc = ax.scatter(
            lens[fg], mi[fg], s=3, c=srp[fg], cmap="RdYlBu_r"
        )
        ax.set_xlabel("Basepair separation")
        return sc

    clusts = np.unique(cc)
    fig, axes = plt.subplots(
        1, max(1, len(clusts)), figsize=(7.3, 4.0), dpi=300, squeeze=False
    )
    for k, ci in enumerate(clusts):
        sc = scatter(axes[0][k], cc == ci)
        axes[0][k].set_title(f"{ci}")
    if len(clusts):
        fig.colorbar(sc, ax=axes[0][-1], label="srp_max")
    fig.tight_layout()
    fig.savefig(os.path.join(plt_folder, "sr_gwes_clust.png"))
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(7.3, 4.0), dpi=300)
    sc = scatter(ax, np.ones(lens.size, dtype=bool))
    fig.colorbar(sc, ax=ax, label="srp_max")
    fig.tight_layout()
    fig.savefig(os.path.join(plt_folder, "sr_gwes_combi.png"))
    plt.close(fig)


def plot_lr_gwes(lr_links, outer_threshold: float, path: str) -> None:
    """LR GWES plot: indirect grey, direct blue, threshold line
    (R/lr_analyser.R:119-127)."""
    plt = _pyplot(path)
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(12, 3.2), dpi=300)
    ar = lr_links["ARACNE"].to_numpy()
    lens = lr_links["len"].to_numpy()
    mi = lr_links["MI"].to_numpy()
    ax.scatter(lens[ar == 0], mi[ar == 0], s=3, c="#C0C0C0")
    ax.scatter(lens[ar == 1], mi[ar == 1], s=3, c="#0868ac")
    ax.axhline(outer_threshold, color="#db4325", lw=1)
    ax.set_xlabel("Basepair separation")
    ax.set_ylabel("MI")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def genomewide_ld_map(
    lr_links,
    sr_links,
    plot_save_path: str,
    reducer: Optional[int] = None,
    plot_title: Optional[str] = None,
    from_pos: Optional[int] = None,
    to_pos: Optional[int] = None,
) -> None:
    """Bird's-eye LD heatmap (R/LDSummaryPlot.R:25-131): links -> symmetric
    sparse matrix over the involved positions, banded aggregation by
    `reducer`, log10 + 0-1 rescale, heatmap.  from_pos/to_pos restrict the
    plot to a genomic window (R/LDSummaryPlot.R:37-48,59-68).

    Aggregation semantics vs the reference (documented divergence,
    PARITY.md): the reference reduces via X^T M X with X = .mat(n, r)
    (R/LDSummaryPlot.R:99-101,176-178), whose column k carries ones at
    rows [k*r, (k+1)*r) mod (n+r) — identical to the index-div binning
    below (bin = index // r) for every full bin.  They differ only when
    r does not divide n: .mat's recycled column pattern WRAPS for the
    trailing columns (a truncation artifact of
    matrix(c(rep(1,r),rep(0,n)), n, n/r)), whereas we fold the <r
    leftover positions into the last bin.  Axis tick labels also differ:
    the reference labels bins with pos_vec stepped by reducer-1
    (R/LDSummaryPlot.R:102), we step by reducer."""
    plt = _pyplot(plot_save_path)
    if plt is None:
        return
    import matplotlib.colors

    if (from_pos is None) != (to_pos is None):
        raise ValueError(
            "If <from> is provided, <to> must be provided as well!"
        )
    if from_pos is not None:
        if to_pos <= from_pos:
            raise ValueError("<to> must be greater than <from>!")
        lr_links = lr_links[
            (lr_links["pos1"] >= from_pos) & (lr_links["pos1"] <= to_pos)
            & (lr_links["pos2"] >= from_pos) & (lr_links["pos2"] <= to_pos)
        ]
        sr_links = sr_links[
            (sr_links["pos1"] >= from_pos) & (sr_links["pos1"] <= to_pos)
            & (sr_links["pos2"] >= from_pos) & (sr_links["pos2"] <= to_pos)
        ]
    pos_vec = np.unique(
        np.concatenate(
            [
                lr_links["pos1"].to_numpy(),
                lr_links["pos2"].to_numpy(),
                sr_links["pos1"].to_numpy(),
                sr_links["pos2"].to_numpy(),
            ]
        )
    )
    n = pos_vec.size
    lut = {int(p): i for i, p in enumerate(pos_vec)}
    if reducer is None:
        reducer = max(1, int(round(n / 1e3)))  # :89
    nb = max(1, n // reducer)
    acc = np.zeros((nb, nb), dtype=np.float64)

    def accumulate(df):
        i = np.array([lut[int(p)] for p in df["pos1"]]) // reducer
        j = np.array([lut[int(p)] for p in df["pos2"]]) // reducer
        i = np.minimum(i, nb - 1)
        j = np.minimum(j, nb - 1)
        np.add.at(acc, (i, j), df["MI"].to_numpy())
        np.add.at(acc, (j, i), df["MI"].to_numpy())

    if len(lr_links):
        accumulate(lr_links)
    if len(sr_links):
        accumulate(sr_links)
    htm = np.log10(acc / max(reducer, 1) ** 2 + 1e-5)  # :101,116
    rng = htm.max() - htm.min()
    if rng > 0:
        htm = (htm - htm.min()) / rng  # .rescale01, :157-163
    fig, ax = plt.subplots(figsize=(8.3, 8.75), dpi=300)
    cmap = matplotlib.colors.LinearSegmentedColormap.from_list(
        "ld", ["white", "#E1B9B4", "#AE452C", "#802418"]
    )
    ax.imshow(htm, cmap=cmap, origin="upper", interpolation="nearest")
    ax.set_title(plot_title or "Genomewide LD plot")
    ticks = np.linspace(0, nb - 1, min(10, nb)).astype(int)
    ax.set_xticks(ticks)
    ax.set_xticklabels(
        [str(int(pos_vec[min(t * reducer, n - 1)])) for t in ticks],
        rotation=90,
        fontsize=6,
    )
    ax.set_yticks(ticks)
    ax.set_yticklabels(
        [str(int(pos_vec[min(t * reducer, n - 1)])) for t in ticks], fontsize=6
    )
    fig.tight_layout()
    fig.savefig(plot_save_path)
    plt.close(fig)


def create_network_for_gene(
    gene: str,
    annotated_links,
    netplot_path: str,
    hops: int = 1,
    plot_title: str = "",
) -> None:
    """1- or 2-hop neighbourhood of one gene from an annotated link table
    (create_network_for_gene, R/createNetworkPlot.R:169-290)."""
    df = annotated_links
    g1 = df["pos1_genreg"].astype(str)
    g2 = df["pos2_genreg"].astype(str)
    frontier = {gene}
    selected = np.zeros(len(df), dtype=bool)
    for _ in range(max(1, hops)):
        hit = g1.isin(frontier) | g2.isin(frontier)
        selected |= hit.to_numpy()
        frontier = set(g1[hit]) | set(g2[hit])
    sub = df[selected]
    if len(sub) == 0:
        return
    create_network(
        sub, netplot_path, plot_title or f"{hops}-hop neighbourhood of {gene}"
    )


def create_network(tophits, netplot_path: str, plot_title: str = "") -> None:
    """Gene-level arc/network plot of tophits (R/createNetworkPlot.R:28-144):
    aggregate links to gene pairs, drop self-loops, draw an arc diagram with
    node size ~ degree and edge width ~ max MI.  The interactive HTML page
    beside the PNG (same name, .html) is written even where matplotlib is
    not installed."""
    import collections

    pairs = collections.Counter()
    weight: Dict = {}
    for _, row in tophits.iterrows():
        g1 = str(row["pos1_genreg"])
        g2 = str(row["pos2_genreg"])
        if g1 == g2:
            continue  # loop-drop (:76-82)
        key = tuple(sorted((g1, g2)))
        pairs[key] += 1
        weight[key] = max(weight.get(key, 0.0), float(row["MI"]))
    if not pairs:
        return
    plt = _pyplot(netplot_path)
    if plt is not None:
        genes = sorted({g for k in pairs for g in k})
        xpos = {g: i for i, g in enumerate(genes)}
        deg = collections.Counter()
        for (a, b), c in pairs.items():
            deg[a] += c
            deg[b] += c
        fig, ax = plt.subplots(figsize=(max(6, len(genes) * 0.4), 4.0), dpi=300)
        wmax = max(weight.values())
        for (a, b), c in pairs.items():
            x1, x2 = xpos[a], xpos[b]
            xm, r = (x1 + x2) / 2, abs(x2 - x1) / 2
            th = np.linspace(0, np.pi, 50)
            ax.plot(
                xm + r * np.cos(th),
                r * np.sin(th) / max(1, len(genes) / 6),
                lw=0.5 + 2.5 * weight[(a, b)] / wmax,
                c="#0868ac",
                alpha=0.6,
            )
        for g in genes:
            ax.scatter(xpos[g], 0, s=20 + 10 * deg[g], c="#db4325", zorder=3)
            ax.annotate(
                g,
                (xpos[g], 0),
                rotation=90,
                fontsize=6,
                ha="center",
                va="top",
                xytext=(0, -8),
                textcoords="offset points",
            )
        ax.set_title(plot_title, fontsize=9)
        ax.axis("off")
        fig.tight_layout()
        fig.savefig(netplot_path)
        plt.close(fig)

    # interactive companion (the reference ships igraph/ggraph objects a
    # browser can explore; viz_html.py closes that artifact gap)
    from ldweaver_tpu_torch.viz_html import write_network_html

    base, _ = os.path.splitext(netplot_path)
    keys = sorted(pairs)
    write_network_html(
        [a for a, _ in keys],
        [b for _, b in keys],
        np.array([weight[k] for k in keys]),
        base + ".html",
        title=plot_title or "GWES network",
    )
