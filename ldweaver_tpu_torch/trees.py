"""Tree viewer (reference: view_tree, R/preptrees.R:45-215).

The reference combines ape/phytools/ggtree: read a newick tree, optionally
midpoint-root it, and render the phylogeny with an aligned allele-heatmap
panel (SNP columns from chosen links) and an optional metadata panel.
This module re-implements that stack from scratch:

  * a newick parser (names, branch lengths, quoted labels),
  * midpoint rooting (longest tip-tip path; re-root at its midpoint),
  * a ladderized rectangular layout,
  * matplotlib rendering with allele + metadata panels aligned to tips.

Only the rendering imports matplotlib: the parser, rooting and layout work
without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Newick tree structure
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Node:
    name: str = ""
    length: float = 0.0
    children: List["Node"] = dataclasses.field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Node"]:
        if self.is_leaf:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def parse_newick(text: str) -> Node:
    """Parse a newick string (subset: names, :lengths, quoted labels)."""
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = [0]

    def parse_node() -> Node:
        node = Node()
        if text[pos[0]] == "(":
            pos[0] += 1
            while True:
                node.children.append(parse_node())
                if text[pos[0]] == ",":
                    pos[0] += 1
                    continue
                if text[pos[0]] == ")":
                    pos[0] += 1
                    break
        # label
        start = pos[0]
        if pos[0] < len(text) and text[pos[0]] == "'":
            pos[0] += 1
            while pos[0] < len(text) and text[pos[0]] != "'":
                pos[0] += 1
            node.name = text[start + 1 : pos[0]]
            pos[0] += 1
        else:
            while pos[0] < len(text) and text[pos[0]] not in ",():;":
                pos[0] += 1
            node.name = text[start : pos[0]]
        if pos[0] < len(text) and text[pos[0]] == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(text) and text[pos[0]] not in ",();":
                pos[0] += 1
            node.length = float(text[start : pos[0]])
        return node

    return parse_node()


def read_tree(path: str) -> Node:
    with open(path) as fh:
        return parse_newick(fh.read())


# --------------------------------------------------------------------------
# Midpoint rooting (phytools::midpoint.root equivalent)
# --------------------------------------------------------------------------
def _to_edges(root: Node):
    """Flatten to adjacency with edge lengths (undirected)."""
    nodes: List[Node] = []
    adj: Dict[int, List[Tuple[int, float]]] = {}

    def walk(n: Node):
        idx = len(nodes)
        nodes.append(n)
        adj.setdefault(idx, [])
        for c in n.children:
            cidx = walk(c)
            adj[idx].append((cidx, c.length))
            adj.setdefault(cidx, []).append((idx, c.length))
        return idx

    walk(root)
    return nodes, adj


def _farthest(adj, start):
    dist = {start: 0.0}
    prev = {start: None}
    stack = [start]
    while stack:
        u = stack.pop()
        for v, w in adj[u]:
            if v not in dist:
                dist[v] = dist[u] + w
                prev[v] = u
                stack.append(v)
    far = max(dist, key=lambda k: dist[k])
    return far, dist, prev


def midpoint_root(root: Node) -> Node:
    """Re-root at the midpoint of the longest leaf-leaf path."""
    nodes, adj = _to_edges(root)
    leaf_ids = [i for i, n in enumerate(nodes) if n.is_leaf]
    if len(leaf_ids) < 3:
        return root
    a, _, _ = _farthest(adj, leaf_ids[0])
    b, dist, prev = _farthest(adj, a)
    total = dist[b]
    # walk back from b toward a to find the midpoint edge
    path = [b]
    while prev[path[-1]] is not None:
        path.append(prev[path[-1]])
    half = total / 2.0
    acc = 0.0
    for k in range(len(path) - 1):
        u, v = path[k], path[k + 1]
        w = next(wt for (x, wt) in adj[u] if x == v)
        if acc + w >= half:
            # new root on edge (u, v), at distance (half - acc) from u
            du = half - acc
            return _reroot(nodes, adj, u, v, du, w)
        acc += w
    return root


def _reroot(nodes, adj, u, v, du, w_uv) -> Node:
    """Build a new rooted tree with the root placed on edge (u, v)."""
    new = {i: Node(name=nodes[i].name) for i in range(len(nodes))}

    def attach(child_id, parent_id, length, visited):
        cn = new[child_id]
        cn.length = length
        visited.add(child_id)
        for x, wt in adj[child_id]:
            if x != parent_id and x not in visited:
                cn.children.append(attach(x, child_id, wt, visited))
        return cn

    root = Node(name="")
    visited = {u, v}
    root.children.append(attach(u, v, du, set(visited)))
    root.children.append(attach(v, u, w_uv - du, set(visited)))
    return root


# --------------------------------------------------------------------------
# Layout + rendering
# --------------------------------------------------------------------------
def _layout(root: Node):
    """Ladderized rectangular layout -> (tip order, segments)."""
    ys: Dict[int, float] = {}
    segs = []
    tips: List[Tuple[str, float]] = []
    counter = [0]

    def walk(n: Node, x0: float) -> float:
        x = x0 + n.length
        if n.is_leaf:
            y = float(counter[0])
            counter[0] += 1
            tips.append((n.name, y))
        else:
            kids = sorted(n.children, key=lambda c: len(c.leaves()))
            cys = [walk(c, x) for c in kids]
            y = float(np.mean(cys))
            for c, cy in zip(kids, cys):
                segs.append(((x, cy), (x + c.length, cy)))  # horizontal
            segs.append(((x, min(cys)), (x, max(cys))))  # vertical
        segs.append(((x0, y), (x, y)))
        return y

    walk(root, 0.0)
    return tips, segs


ALLELE_COLORS = {
    "A": "#4daf4a",
    "C": "#377eb8",
    "G": "#ff7f00",
    "T": "#e41a1c",
    "N": "#bdbdbd",
}


def view_tree(
    tree_path: str,
    fasta_path: str,
    pos_file_path: str,
    links_df=None,
    perform_midpoint_rooting: bool = True,
    metadata_df=None,
    ntop_links: int = 10,
    plot_save_path: Optional[str] = None,
    plot_height: float = 20,
    plot_width: float = 15,
):
    """Render the tree + allele panels for the SNPs of the top links
    (view_tree, R/preptrees.R:45-215).

    links_df needs pos1/pos2 columns; fasta/pos files come from
    snpdat_to_fa / generate_Links_SNPS_fasta (R/io_functions.R:363-460).
    The figure is the only output, so without matplotlib this raises
    ImportError.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "view_tree draws a figure and needs matplotlib, which is not"
            " installed"
        ) from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ldweaver_tpu_torch.io.fasta import iter_fasta

    tree = read_tree(tree_path)
    if perform_midpoint_rooting:
        tree = midpoint_root(tree)
    tips, segs = _layout(tree)
    tip_order = {name: y for name, y in tips}

    pos = np.loadtxt(pos_file_path, dtype=np.int64)
    seqs = {name: seq.decode() for name, seq in iter_fasta(fasta_path)}
    # validate tips <-> fasta (R/preptrees.R read_fasta checks)
    missing = [n for n in tip_order if n not in seqs]
    if missing:
        raise ValueError(
            f"{len(missing)} tree tips missing from fasta (e.g. {missing[:3]})"
        )

    # choose SNP columns from the top links
    chosen: List[int] = []
    if links_df is not None:
        for _, row in links_df.head(ntop_links).iterrows():
            for p in (int(row["pos1"]), int(row["pos2"])):
                idx = np.searchsorted(pos, p)
                if idx < pos.size and pos[idx] == p and idx not in chosen:
                    chosen.append(int(idx))
    else:
        chosen = list(range(min(2 * ntop_links, pos.size)))

    nmeta = 0 if metadata_df is None else (metadata_df.shape[1] - 1)
    fig, axes = plt.subplots(
        1,
        2 + (1 if nmeta else 0),
        figsize=(plot_width, plot_height),
        dpi=150,
        gridspec_kw={"width_ratios": [3, 1] + ([0.5] if nmeta else [])},
        sharey=True,
    )
    ax_tree = axes[0]
    for (x0, y0), (x1, y1) in segs:
        ax_tree.plot([x0, x1], [y0, y1], c="black", lw=0.6)
    for name, y in tips:
        ax_tree.annotate(
            name, (ax_tree.get_xlim()[1], y), fontsize=3, va="center"
        )
    ax_tree.set_ylim(-1, len(tips))
    ax_tree.axis("off")

    ax_all = axes[1]
    mat = np.zeros((len(tips), len(chosen), 3))
    for name, y in tips:
        s = seqs[name]
        for k, c in enumerate(chosen):
            col = ALLELE_COLORS.get(s[c].upper(), "#bdbdbd")
            mat[int(y), k] = matplotlib.colors.to_rgb(col)
    ax_all.imshow(
        mat, aspect="auto", origin="lower",
        extent=(0, len(chosen), -1, len(tips)), interpolation="nearest",
    )
    ax_all.set_xticks(np.arange(len(chosen)) + 0.5)
    ax_all.set_xticklabels(
        [str(int(pos[c])) for c in chosen], rotation=90, fontsize=4
    )
    ax_all.set_yticks([])
    ax_all.set_title("alleles", fontsize=8)

    if nmeta:
        ax_md = axes[2]
        id_col = [c for c in metadata_df.columns if c.lower() == "id"]
        if len(id_col) != 1:
            raise ValueError("Metadata file must contain an ID column")
        md = metadata_df.set_index(id_col[0])
        cats = {}
        cmap = plt.get_cmap("tab20")
        cols = [c for c in md.columns]
        mmat = np.ones((len(tips), len(cols), 3))
        for name, y in tips:
            if name in md.index:
                for k, c in enumerate(cols):
                    v = md.loc[name, c]
                    if v not in cats:
                        cats[v] = cmap(len(cats) % 20)[:3]
                    mmat[int(y), k] = cats[v]
        ax_md.imshow(
            mmat, aspect="auto", origin="lower",
            extent=(0, len(cols), -1, len(tips)), interpolation="nearest",
        )
        ax_md.set_xticks(np.arange(len(cols)) + 0.5)
        ax_md.set_xticklabels(cols, rotation=90, fontsize=5)
        ax_md.set_yticks([])
        ax_md.set_title("metadata", fontsize=8)

    fig.tight_layout()
    if plot_save_path:
        fig.savefig(plot_save_path)
        plt.close(fig)
        return plot_save_path
    return fig
