"""The port's pipeline (BLK1-BLK7, backend="spmd", device="cpu") against
the JAX package's on the same input: the examples/bench_e2e.py generator
at its E2E_SMOKE size (24 genomes x 100 kb x 2,500 planted SNPs, a full
alignment plus a GenBank file), max_blk_sz=1000 (a 3 x 3 block grid).

Hamming weights must be bit-equal.  The link tables are compared as
scripts/chip_parity.py reads them, and the reference's own CPU-vs-TPU
spread is the bound (CHIP_PARITY_r05.json, 400 genomes x 1,268 SNPs:
2 of 972 SR rows and 2 of 20,314 LR rows on one side only, MI max abs
diff 1.17e-4, ARACNE agreement 0.99072, top-10 SR ranking equal).  Rows
on one side only are allowed at that RATE (2 per 970, at least 2): they
sit at the srp cutoff, whose position moves with the Nelder-Mead Beta
fit of the background model, so their number grows with the table.

Observed on the CPU: SR 3 of 3,930 rows on one side only (srp 3.00011 to
3.00014 against the cutoff 3.0; srp max abs diff 1.7e-3), MI max abs
diff 2.8e-07, ARACNE agreement 0.9967, top-10 equal; LR 0 of 1,002,270
rows on one side only, MI max abs diff 5.5e-07.

The same bounds hold the port's SR-only run (perform_SR_analysis_only)
and its run on a SNP-only alignment (io/writers.snpdat_to_fa of the JAX
run's SNP matrix, with `pos`, aln_has_all_bases=False) against the JAX
package's full run; the SNP-only run's Hamming weights are bit-equal.
Observed on the CPU: both 3 of 3,930 SR rows on one side only; the
SNP-only LR table 0 of 1,002,270."""

import os

import numpy as np
import pytest

# one-side-only rows allowed per table row (CHIP_PARITY_r05.json SR fringe)
FRINGE_RATE = 2 / 970


def fringe_bound(n_rows):
    return max(2, int(round(FRINGE_RATE * n_rows)))


def read_sr(path):
    """sr_links.tsv: clust_c pos1 pos2 clust1 clust2 len MI srp ARACNE."""
    rows = [ln.rstrip("\n").split("\t") for ln in open(path)]
    key = [(r[1], r[2]) for r in rows]
    mi = np.array([float(r[6]) for r in rows])
    ar = [r[8] for r in rows]
    return key, mi, ar


def read_lr(path):
    rows = [ln.rstrip("\n").split("\t") for ln in open(path)]
    return {(r[0], r[1]): float(r[5]) for r in rows}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import ldweaver_tpu
    import ldweaver_tpu_torch
    from examples.bench_e2e import synth_alignment

    d = tmp_path_factory.mktemp("e2e_smoke")
    fa, gbk = str(d / "aln.fa.gz"), str(d / "ref.gbk")
    synth_alignment(fa, gbk, nseq=24, g=100_000, nsnp=2500)
    kw = dict(aln_path=fa, gbk_path=gbk, backend="spmd",
              SnpEff_Annotate=False, max_blk_sz=1000,
              save_additional_outputs=True)
    out = {}
    ldweaver_tpu.ldweaver(dset=str(d / "jax"), **kw)
    out["jax"] = str(d / "jax")
    ldweaver_tpu_torch.ldweaver(dset=str(d / "torch"), device="cpu", **kw)
    out["torch"] = str(d / "torch")
    return out


def test_hdw_bit_equal(runs):
    a = np.load(os.path.join(runs["jax"], "Additional_Outputs", "hdw.npz"))["hdw"]
    b = np.load(os.path.join(runs["torch"], "Additional_Outputs", "hdw.npz"))["hdw"]
    assert np.array_equal(a, b)


def assert_sr_within_fringe(jax_dset, torch_dset):
    key_j, mi_j, ar_j = read_sr(os.path.join(jax_dset, "Temp", "sr_links.tsv"))
    key_t, mi_t, ar_t = read_sr(os.path.join(torch_dset, "Temp", "sr_links.tsv"))
    assert len(key_j) > 100
    assert len(set(key_j) ^ set(key_t)) <= fringe_bound(len(key_j))
    idx_j = {k: i for i, k in enumerate(key_j)}
    idx_t = {k: i for i, k in enumerate(key_t)}
    shared = sorted(set(key_j) & set(key_t))
    pj = [idx_j[k] for k in shared]
    pt = [idx_t[k] for k in shared]
    assert np.abs(mi_j[pj] - mi_t[pt]).max() <= 1.2e-4
    agree = np.mean([ar_j[i] == ar_t[j] for i, j in zip(pj, pt)])
    assert agree >= 0.99
    assert key_j[:10] == key_t[:10]


def assert_lr_within_fringe(jax_dset, torch_dset):
    lr_j = read_lr(os.path.join(jax_dset, "Temp", "lr_links.tsv"))
    lr_t = read_lr(os.path.join(torch_dset, "Temp", "lr_links.tsv"))
    assert len(lr_j) > 1000
    assert len(set(lr_j) ^ set(lr_t)) <= 2
    common = set(lr_j) & set(lr_t)
    assert max(abs(lr_j[k] - lr_t[k]) for k in common) <= 1.2e-4


def test_sr_links_within_reference_fringe(runs):
    assert_sr_within_fringe(runs["jax"], runs["torch"])


def test_lr_links_within_reference_fringe(runs):
    assert_lr_within_fringe(runs["jax"], runs["torch"])


@pytest.mark.parametrize("variant", ["sr_only", "snp_only"])
def test_variant_runs_within_reference_fringe(runs, tmp_path, variant):
    """SR-only and SNP-only runs of the port against the JAX package's
    full run (module docstring)."""
    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.core.snp_tensor import SnpData
    from ldweaver_tpu_torch.io.writers import snpdat_to_fa

    d = os.path.dirname(runs["jax"])
    kw = dict(gbk_path=os.path.join(d, "ref.gbk"), backend="spmd",
              SnpEff_Annotate=False, max_blk_sz=1000,
              save_additional_outputs=True, device="cpu")
    dset = str(tmp_path / variant)
    if variant == "sr_only":
        ldweaver_tpu_torch.ldweaver(dset=dset, aln_path=os.path.join(d, "aln.fa.gz"),
                                    perform_SR_analysis_only=True, **kw)
    else:
        sd = SnpData.load_npz(os.path.join(runs["jax"], "Additional_Outputs",
                                           "snp_ACGTN.npz"))
        aln, pos_path = str(tmp_path / "snps.fa"), str(tmp_path / "snps.pos")
        snpdat_to_fa(sd, aln, pos_path)
        ldweaver_tpu_torch.ldweaver(dset=dset, aln_path=aln, aln_has_all_bases=False,
                                    pos=np.loadtxt(pos_path, dtype=np.int64), **kw)
        hdw = {k: np.load(os.path.join(r, "Additional_Outputs", "hdw.npz"))["hdw"]
               for k, r in (("jax", runs["jax"]), ("torch", dset))}
        assert np.array_equal(hdw["jax"], hdw["torch"])
        assert_lr_within_fringe(runs["jax"], dset)
    assert_sr_within_fringe(runs["jax"], dset)


def test_timings_and_unported_options(runs, tmp_path):
    import json

    import ldweaver_tpu_torch

    t = json.load(open(os.path.join(runs["torch"], "timings.json")))
    for blk in ("blk1_parse_alignment", "blk4_hamming_weights",
                "blk5_mi_computation", "blk7_gwes_plots"):
        assert blk in t
    assert t["blk5_phases"]["spmd"]["tiles"] == 6
    assert t["blk5_phases"]["spmd"]["sr_reduce"] == "device"
    # invalid device counts raise, with the default config
    # (SnpEff_Annotate=True) and without it
    for bad in (dict(sr_reduce="part", n_devices=0), dict(n_devices=0)):
        for annotate in (True, False):
            with pytest.raises(ValueError, match="n_devices"):
                ldweaver_tpu_torch.ldweaver(
                    dset=str(tmp_path / "x"), aln_path="unused.fa",
                    gbk_path="u.gbk", device="cpu", SnpEff_Annotate=annotate,
                    **bad,
                )


def tile_thresholds(pkg, ranked, valid, hdw, g, sr_dist, lr_prob):
    """{(bi, bj): (MI tile f64, LR mask, f64 type-7 retention threshold)}
    of every tile of the r-stratified grid, each tile computed by the
    package `pkg` ("jax": its XLA rank tile; "torch": the port's K1 plain
    version); the mask (triangle, validity, f32 length > sr_dist) is the
    extraction's."""
    import torch

    from ldweaver_tpu_torch.parallel import spmd_sweep
    from ldweaver_tpu_torch.parallel.fast_sweep import tile_masks
    from ldweaver_tpu_torch.utils.r_compat import quantile_type7

    B = ranked.block
    nb = ranked.rank_codes.shape[1] // B
    dev = spmd_sweep.device_inputs(ranked, valid, hdw, float(hdw.sum()), "cpu")
    out = {}
    for bi in range(nb):
        for bj in range(bi, nb):
            Rf, Rt = int(ranked.block_rmax[bi]), int(ranked.block_rmax[bj])
            pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
            if pkg == "torch":
                mi = spmd_sweep.tile_mi(dev, bi, bj, B, Rf, Rt, pure)
            else:
                import jax.numpy as jnp

                from ldweaver_tpu.parallel import fast_sweep as jfs

                w32, parts = jfs._wparts(hdw)
                fn = jfs._build_rank_tile(B, B, Rf, Rt, 3, pure=pure)
                sl = lambda b: jnp.asarray(ranked.rank_codes[:, b * B:(b + 1) * B].T)  # noqa: E731
                r = lambda b: jnp.asarray(ranked.r[b * B:(b + 1) * B], jnp.float32)  # noqa: E731
                mi = torch.from_numpy(np.array(fn(
                    sl(bi), sl(bj), jnp.asarray(w32), jnp.asarray(parts),
                    r(bi), r(bj), jnp.asarray(np.float32(hdw.sum())),
                )))
            fs, ts = bi * B, bj * B
            _, ok = tile_masks(dev.pos[fs:fs + B], dev.pos[ts:ts + B],
                               dev.valid[fs:fs + B], dev.valid[ts:ts + B],
                               bi == bj, g, sr_dist)
            ok = ok.numpy()
            mi64 = mi.numpy().astype(np.float64)
            out[bi, bj] = (mi64, ok, quantile_type7(mi64[ok], lr_prob))
    return out


def test_lr_tie_group_sits_at_the_retention_threshold(runs, tmp_path):
    """The LR rows on one side only with lr_retain_links=100_000 (ROADMAP
    section 3's LR tie group) are a boundary tie, not a deviation: each
    such row's MI lies within 1e-6 of its tile's f64 type-7 retention
    threshold in the package that dropped it, and the rows of a tile form
    one group of tied values.  Observed on the CPU: 42 rows of 102,138,
    all in tile (1, 2), all kept by the port at MI 0.0575917810; the JAX
    package's tile holds the same 42 pairs at 0.0575917773, one f32 ulp
    (3.7e-9) under its threshold 0.0575917810, while in the port's tile
    they equal the threshold and pass its >=."""
    import ldweaver_tpu.core.sweep as jsweep
    import ldweaver_tpu_torch.core.sweep as tsweep
    from ldweaver_tpu.core.cds import CdsVar as JaxCdsVar
    from ldweaver_tpu.core.snp_tensor import SnpData as JaxSnpData
    from ldweaver_tpu_torch.core.cds import CdsVar
    from ldweaver_tpu_torch.core.mi import estimate_lr_links
    from ldweaver_tpu_torch.core.snp_tensor import SnpData
    from ldweaver_tpu_torch.parallel.fast_sweep import stratify

    add = os.path.join(runs["jax"], "Additional_Outputs")
    hdw = np.load(os.path.join(add, "hdw.npz"))["hdw"]
    kw = dict(sr_dist=20000, lr_retain_links=100_000, max_blk_sz=1000,
              backend="spmd", verbose=False)
    lr = {}
    for pkg, mod, snp_cls, cds_cls, extra in (
        ("jax", jsweep, JaxSnpData, JaxCdsVar, {}),
        ("torch", tsweep, SnpData, CdsVar, dict(device="cpu")),
    ):
        sd = snp_cls.load_npz(os.path.join(add, "snp_ACGTN.npz"))
        cds_var = cds_cls.load_npz(os.path.join(add, "cds_var.npz"))
        path = str(tmp_path / f"{pkg}_lr.tsv")
        mod.perform_mi_computation(
            sd, hdw, cds_var, lr_save_path=path,
            sr_save_path=str(tmp_path / f"{pkg}_sr.tsv"), **kw, **extra,
        )
        lr[pkg] = read_lr(path)
    one_side = set(lr["jax"]) ^ set(lr["torch"])
    assert len(lr["jax"]) > 50_000
    if not one_side:
        return

    sd = SnpData.load_npz(os.path.join(add, "snp_ACGTN.npz"))
    ranked = stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, 1000)
    valid = np.arange(ranked.pos.size) < sd.nsnp
    lr_prob = max(0.0, 1.0 - 100_000 / estimate_lr_links(sd.pos, sd.g, 20000))
    tiles = {pkg: tile_thresholds(pkg, ranked, valid, hdw, sd.g, 20000, lr_prob)
             for pkg in ("jax", "torch")}
    where = {int(p): i for i, p in enumerate(ranked.pos[valid])}
    groups = {}
    for key in one_side:
        kept = "jax" if key in lr["jax"] else "torch"
        dropped = "torch" if kept == "jax" else "jax"
        a, b = where[int(key[0])], where[int(key[1])]
        a, b = (a, b) if a // 1000 <= b // 1000 else (b, a)
        if a // 1000 == b // 1000 and a < b:
            a, b = b, a  # a diagonal tile holds its pairs at i > j
        tile = (a // 1000, b // 1000)
        mi, ok, q = tiles[dropped][tile]
        i, j = a % 1000, b % 1000
        assert ok[i, j]
        # the dropping package held the pair just under its threshold,
        # the keeping package at or above its own
        assert mi[i, j] < q and q - mi[i, j] <= 1e-6, (key, mi[i, j], q)
        assert abs(lr[kept][key] - q) <= 1e-6, (key, lr[kept][key], q)
        _, _, q_kept = tiles[kept][tile]
        assert lr[kept][key] >= q_kept - 1e-7
        groups.setdefault((dropped, tile), []).append(lr[kept][key])
    for vals in groups.values():  # one group of tied values per tile
        assert max(vals) - min(vals) <= 1e-7, vals
