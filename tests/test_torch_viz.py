"""The port's output views against the JAX package's on the same
numpy-seeded inputs: the tanglegram (segment TSV and HTML page), the
network pages of create_network and create_network_for_gene, and the tree
viewer's Newick parser, midpoint rooting and layout.  With matplotlib
hidden, the port still writes every TSV and HTML page (only the PNGs are
skipped) and view_tree, whose figure is its only output, raises
ImportError."""

import importlib
import re
import sys

import numpy as np
import pandas as pd
import pytest

PKGS = ("ldweaver_tpu", "ldweaver_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def tophits(seed=0, n=40):
    """Annotated tophits over 12 genes; pos1 in four separated regions so
    the tanglegram cuts several segments."""
    rng = np.random.default_rng(seed)
    pos1 = np.concatenate([rng.integers(lo, lo + 5000, n // 4 + 1)
                           for lo in (1_000, 40_000, 90_000, 150_000)])[:n]
    pos2 = pos1 + rng.integers(100, 15_000, n)
    genes = np.array([f"g{k:02d}" for k in range(12)])
    return pd.DataFrame(dict(
        pos1=pos1, pos2=pos2, MI=np.round(rng.random(n), 4),
        pos1_genreg=genes[rng.integers(0, 12, n)],
        pos2_genreg=genes[rng.integers(0, 12, n)],
    ))


def gene_features(pkg, n=60):
    """gene and CDS features tiling 1-180 kb (locus names of the
    tanglegram)."""
    Feature = mod(pkg, "io.genbank").Feature
    out = []
    for k in range(n):
        s, e = 1 + 3000 * k, 2500 + 3000 * k
        for typ in ("gene", "CDS"):
            out.append(Feature(type=typ, start=s, end=e, strand=1, segments=[(s, e)],
                               qualifiers={"gene": f"g{k:02d}", "locus_tag": f"L{k}"}))
    return out


def test_tanglegram_tsv_and_html_byte_identical(tmp_path):
    top = tophits()
    for pkg in PKGS:
        mod(pkg, "tanglegram").create_tanglegram(
            top, gene_features(pkg), str(tmp_path / pkg), break_segments=3)
    for name in ("tanglegram_segments.tsv", "tanglegram.html"):
        a = (tmp_path / PKGS[0] / name).read_bytes()
        b = (tmp_path / PKGS[1] / name).read_bytes()
        assert len(a) > 100 and a == b, name
    assert (tmp_path / PKGS[1] / "segment_3.png").exists()


@pytest.mark.parametrize("hops", [None, 1, 2])
def test_network_html_byte_identical(tmp_path, hops):
    """create_network (hops None) and create_network_for_gene's 1- and
    2-hop neighbourhoods of g00."""
    top = tophits(seed=1)
    for pkg in PKGS:
        plots = mod(pkg, "plots")
        path = str(tmp_path / pkg / "net.png")
        (tmp_path / pkg).mkdir()
        if hops is None:
            plots.create_network(top, path, plot_title="Networks")
        else:
            plots.create_network_for_gene("g00", top, path, hops=hops)
    a = (tmp_path / PKGS[0] / "net.html").read_bytes()
    b = (tmp_path / PKGS[1] / "net.html").read_bytes()
    assert len(a) > 100 and a == b
    assert (tmp_path / PKGS[1] / "net.png").exists()
    pairs = re.findall(r'class="link" data-a="g(\w+)" data-b="g(\w+)"', b.decode())
    touch = [{"g00"} & {x, y} for x, y in pairs]
    if hops == 1:  # every link of a 1-hop neighbourhood touches g00
        assert pairs and all(touch)
    elif hops == 2:  # a 2-hop one reaches beyond g00's own links
        assert any(touch) and not all(touch)


NEWICK = "((A:1,B:2):0.5,('seq C':3,(D:1,E:0.25):1.5):0.25,F:7);"


def tree_shape(node):
    return (node.name, node.length, [tree_shape(c) for c in node.children])


def test_tree_parser_rooting_and_layout_equal():
    out = {}
    for pkg in PKGS:
        trees = mod(pkg, "trees")
        t = trees.parse_newick(NEWICK)
        r = trees.midpoint_root(t)
        out[pkg] = (tree_shape(t), tree_shape(r), trees._layout(r))
    assert out[PKGS[0]] == out[PKGS[1]]
    assert sorted(n for n, _ in out[PKGS[1]][2][0]) == ["A", "B", "D", "E", "F", "seq C"]


def write_tree_inputs(tmp_path, nseq=12, nsnp=30):
    rng = np.random.default_rng(3)
    names = [f"s{k}" for k in range(nseq)]
    core = f"({names[0]}:1,{names[1]}:1)"
    for n in names[2:]:
        core = f"({core}:1,{n}:{rng.random():.3f})"
    (tmp_path / "t.nwk").write_text(core + ";")
    pos = np.sort(rng.choice(np.arange(1, 10_000), nsnp, replace=False))
    with open(tmp_path / "snps.fa", "wt") as fh:
        for n in names:
            fh.write(f">{n}\n" + "".join(rng.choice(list("ACGTN"), nsnp)) + "\n")
    np.savetxt(tmp_path / "snps.pos", pos, fmt="%d")
    links = pd.DataFrame(dict(pos1=pos[[0, 3]], pos2=pos[[10, 20]]))
    meta = pd.DataFrame(dict(id=names, clade=["x", "y"] * (nseq // 2)))
    return [str(tmp_path / f) for f in ("t.nwk", "snps.fa", "snps.pos")], links, meta


def test_view_tree_renders(tmp_path):
    from ldweaver_tpu_torch.trees import view_tree

    paths, links, meta = write_tree_inputs(tmp_path)
    out = view_tree(*paths, links_df=links, metadata_df=meta,
                    plot_save_path=str(tmp_path / "tree.png"),
                    plot_height=6, plot_width=8)
    assert (tmp_path / "tree.png").stat().st_size > 1000 and out.endswith("tree.png")


def test_without_matplotlib_data_outputs_are_written(tmp_path, monkeypatch):
    from ldweaver_tpu_torch.plots import create_network
    from ldweaver_tpu_torch.tanglegram import create_tanglegram
    from ldweaver_tpu_torch.trees import view_tree

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises
    top = tophits()
    create_tanglegram(top, gene_features(PKGS[1]), str(tmp_path / "tg"),
                      break_segments=3)
    assert (tmp_path / "tg" / "tanglegram_segments.tsv").stat().st_size > 100
    assert (tmp_path / "tg" / "tanglegram.html").stat().st_size > 100
    assert not list((tmp_path / "tg").glob("*.png"))
    create_network(top, str(tmp_path / "net.png"))
    assert (tmp_path / "net.html").stat().st_size > 100
    assert not (tmp_path / "net.png").exists()
    paths, links, meta = write_tree_inputs(tmp_path)
    with pytest.raises(ImportError, match="matplotlib"):
        view_tree(*paths, links_df=links, plot_save_path=str(tmp_path / "t.png"))
