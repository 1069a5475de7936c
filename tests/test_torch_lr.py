"""BLK12's long-range analysis, port against the JAX package on the same
numpy-seeded link tables: `core/lr.analyse_long_range_links_core` in its
three cases (Tukey outlier thresholds; the top-5000 fallback when fewer
than 5000 links pass them, core/lr.py:45-51; SpydrPick input that already
carries ARACNE labels) and the standalone `analyse_long_range_links`,
which reads the TSVs and plots lr_gwes.png.  Host code, copied: the
tables must be equal, and the written ones byte-identical."""

import numpy as np
import pandas as pd
import pytest

N_SNPS = 900
G = 2_000_000


def lr_table(case, seed):
    """LR links between N_SNPS positions (so ARACNE finds triangles), len
    >= 20 kb; MI heavy-tailed for the Tukey case, near-normal for the
    fallback, and an ARACNE column for SpydrPick input."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.choice(np.arange(1, G), N_SNPS, replace=False))
    n = {"tukey": 60_000, "fallback": 20_000, "spydrpick": 20_000}[case]
    i, j = rng.integers(0, N_SNPS, (2, 3 * n))
    p1, p2 = pos[np.minimum(i, j)], pos[np.maximum(i, j)]
    keep = p2 - p1 >= 20_000
    pairs = np.unique(np.stack([p1[keep], p2[keep]], 1), axis=0)[:n]
    n = len(pairs)
    mi = (rng.lognormal(-3.0, 1.3, n) if case == "tukey"
          else np.abs(rng.normal(0.05, 0.01, n)))
    df = pd.DataFrame(dict(pos1=pairs[:, 0], pos2=pairs[:, 1],
                           c1=rng.integers(1, 4, n), c2=rng.integers(1, 4, n),
                           len=(pairs[:, 1] - pairs[:, 0]).astype(float),
                           MI=np.round(mi, 9)))
    if case == "spydrpick":
        # SpydrPick's five columns, in its order
        df = df.assign(ARACNE=rng.integers(0, 2, n))[
            ["pos1", "pos2", "len", "ARACNE", "MI"]]
    return df, pos


def sr_table(pos, seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, N_SNPS - 1, 600)
    j = np.minimum(i + rng.integers(1, 4, 600), N_SNPS - 1)
    keep = i != j
    return pd.DataFrame(dict(
        clust_c=1, pos1=pos[i][keep], pos2=pos[j][keep], clust1=1, clust2=1,
        len=(pos[j] - pos[i])[keep].astype(float),
        MI=np.round(rng.lognormal(-2.0, 1.0, keep.sum()), 9), srp_max=4.0,
        ARACNE=1,
    ))


@pytest.mark.parametrize("case", ["tukey", "fallback", "spydrpick"])
def test_analyse_long_range_links_core_equal(case):
    from ldweaver_tpu.core.lr import analyse_long_range_links_core as jax_core
    from ldweaver_tpu_torch.core.lr import analyse_long_range_links_core as core

    lr, pos = lr_table(case, seed=7)
    sr = sr_table(pos, seed=8)
    a = jax_core(lr.copy(), sr.copy())
    b = core(lr.copy(), sr.copy())
    assert a.used_fallback == b.used_fallback == (case != "tukey")
    assert a.thresholds == b.thresholds
    pd.testing.assert_frame_equal(a.links, b.links)
    assert len(b.links) >= 1000
    if case == "spydrpick":  # the input's labels are kept
        lab = dict(zip(zip(lr.pos1, lr.pos2), lr.ARACNE))
        assert all(lab[k] == v for k, v in zip(zip(b.links.pos1, b.links.pos2),
                                               b.links.ARACNE))
    else:
        assert 0 < b.links.ARACNE.sum() < len(b.links)


@pytest.mark.parametrize("case", ["tukey", "spydrpick"])
def test_standalone_analyse_long_range_links_byte_identical(tmp_path, case):
    import ldweaver_tpu
    import ldweaver_tpu_torch

    lr, pos = lr_table(case, seed=9)
    spydrpick = case == "spydrpick"
    lr_path, sr_path = tmp_path / "lr_links.tsv", tmp_path / "sr_links.tsv"
    lr.to_csv(lr_path, sep=" " if spydrpick else "\t", header=False, index=False)
    sr_table(pos, seed=10).to_csv(sr_path, sep="\t", header=False, index=False)
    for pkg, mod in (("jax", ldweaver_tpu), ("torch", ldweaver_tpu_torch)):
        out = mod.analyse_long_range_links(
            str(tmp_path / pkg), str(lr_path), str(sr_path),
            links_from_spydrpick=spydrpick)
        out.to_csv(tmp_path / pkg / "links.tsv", sep="\t", index=False)
    for name in ("links.tsv", "lr_gwes.png"):
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "torch" / name).read_bytes()
        assert len(a) > 1000 and a == b, name
