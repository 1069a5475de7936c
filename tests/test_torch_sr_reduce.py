"""The port's on-device SR background reduction
(`ldweaver_tpu_torch/parallel/sr_reduce.py`, device="cpu") against the
JAX package's (`ldweaver_tpu/parallel/sr_reduce.py`, single-device "flat"
path on a one-device CPU mesh), and the port's device mode against its
own host mode.

Bit-equal: `rank_lo`, the order-preserving f32 bits (incl. +-0, +-inf,
+-denormals), the host fits, threshold tables and candidate tables on the
same arrays, and the group stats (ns, xlo, xhi) on the same segments;
the candidate (gi, gj, mi) equal.  Byte-identical: the port's
sr_links.tsv, lr_links.tsv and cluster fit files in device and host mode
(full and SR-only runs, odd g so distances are half-integers, 3
clusters, 6 tiles).  Within the reference's CPU-vs-TPU fringe
(tests/test_torch_pipeline.py, one-side rows at 2 per 970): the port's
device-mode link tables against the JAX package's device mode.  Observed
on the CPU: LR 3 of 999,895 rows on one side only (ties at a tile's
retention threshold that f32 MI differences of ~3e-7 split, as in
test_torch_pipeline.py's LR tie test)."""

import os

import numpy as np
import pytest
import torch

import ldweaver_tpu.core.sweep as jsweep
import ldweaver_tpu.parallel.sr_reduce as jsr
import ldweaver_tpu_torch.core.sweep as tsweep
import ldweaver_tpu_torch.parallel.sr_reduce as tsr
from ldweaver_tpu_torch.core.cds import CdsVar, Clusters
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.parallel.slabs import panel_pair_order
from tests.test_spmd_sweep import _cds_var as jax_cds_var
from tests.test_stream_sweep import _synth
from tests.test_torch_pipeline import assert_sr_within_fringe, fringe_bound, read_lr

SR_DIST = 2000


def test_rank_lo_and_mono_bits_match_jax():
    import jax
    import jax.numpy as jnp

    n = np.concatenate([
        np.arange(0, 100_001, dtype=np.int64),
        np.random.default_rng(0).integers(1, 2**31 - 20, size=100_000),
    ])
    assert np.array_equal(tsr.rank_lo(n), jsr.rank_lo(n))
    assert np.array_equal(tsr.rank_lo(torch.from_numpy(n)).numpy(), jsr.rank_lo(n))

    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.normal(size=1000).astype(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40,
                  np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                  np.finfo(np.float32).max, -np.finfo(np.float32).max],
                 np.float32),
    ])
    want = np.asarray(jax.jit(jsr._mono_u32)(jnp.asarray(v))).astype(np.int64)
    got = tsr.mono_u32(torch.from_numpy(v))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    back = tsr.unmono_f32(got).numpy()
    assert np.array_equal(back.view(np.uint32), v.view(np.uint32))
    sv = v[np.argsort(got.numpy(), kind="stable")]
    assert np.all(sv[:-1] <= sv[1:])  # numeric order
    zeros = got.numpy()[-12:-10]
    assert zeros[1] + 1 == zeros[0]  # -0.0 just below +0.0


def synthetic_segments(seed=7, B=64, nb=3, g=4001, sr_dist=400, nclust=4):
    """Kept SR outputs (bi, bj, sr_idx, sr_vals) of nb*(nb+1)/2 tiles in
    panel order: 30% of each tile's pairs (strict lower triangle on the
    diagonal), many beyond sr_dist (dead), MI on a 0.01 grid (ties) with
    some -0.0, and a paint that leaves cluster `nclust` without a site."""
    rng = np.random.default_rng(seed)
    n = B * nb
    pos = np.sort(rng.choice(np.arange(1, g + 1), n, replace=False)).astype(np.int32)
    paint = rng.integers(1, nclust, size=n).astype(np.int32)
    segs = []
    flat = np.arange(B * B)
    for bi, bj in panel_pair_order(nb, nb):
        ok = (flat // B > flat % B) if bi == bj else np.ones(B * B, bool)
        idx = flat[ok & (rng.random(B * B) < 0.3)].astype(np.int32)
        vals = (rng.integers(-5, 60, idx.size) / 100).astype(np.float32)
        vals[rng.random(idx.size) < 0.02] = -0.0
        segs.append((bi, bj, idx, vals))
    return dict(B=B, nb=nb, g=g, sr_dist=sr_dist, nclust=nclust, pos=pos,
                paint=paint, segs=segs)


def jax_flat_reduction(case):
    """The JAX package's pass 1 and pass 2 on a one-device CPU mesh,
    registered in `_MESH_STORE` as `run_device_reduction` does; one
    segment of one row per tile, unpadded."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ldweaver_tpu.parallel.fast_sweep import _MESH_STORE

    mesh = Mesh(np.array(jax.devices()[:1]), ("b",))
    key = id(mesh)
    _MESH_STORE[key] = mesh
    segs = tuple(
        (jnp.asarray(idx[None, :]), jnp.asarray(vals[None, :]),
         jnp.asarray(np.array([idx.size], np.int32)),
         jnp.asarray(np.array([[bi, bj]], np.int32)))
        for bi, bj, idx, vals in case["segs"]
    )
    pos, paint = jnp.asarray(case["pos"]), jnp.asarray(case["paint"])
    args = (case["B"], case["g"], case["sr_dist"], case["nclust"])
    sbuf = np.asarray(jsr._build_group_stats(key, *args)(segs, pos, paint))
    ns = sbuf[0].astype(np.int32)
    xlo, xhi = sbuf[1].copy().view(np.float32), sbuf[2].copy().view(np.float32)
    fits = jsr.fits_from_group_stats(ns, xlo, xhi, case["sr_dist"])
    T = jsr.threshold_tables(fits, case["nclust"], case["sr_dist"])
    total = sum(s[2].size for s in case["segs"])
    buf, cnt = jsr._build_candidates(key, *args, total)(segs, pos, paint, T)
    buf, cnt = np.asarray(buf), int(cnt)
    cand = (buf[:cnt, 0].astype(np.int32), buf[:cnt, 1].astype(np.int32),
            np.ascontiguousarray(buf[:cnt, 2]).view(np.float32))
    return (ns, xlo, xhi), T, cand


def test_group_stats_and_candidates_match_jax():
    case = synthetic_segments()
    (ns_j, xlo_j, xhi_j), T, cand_j = jax_flat_reduction(case)
    segs = [(bi, bj, torch.from_numpy(i), torch.from_numpy(v))
            for bi, bj, i, v in case["segs"]]
    flat = tsr.flat_segments(segs, torch.from_numpy(case["pos"]),
                             torch.from_numpy(case["paint"]), case["B"],
                             case["g"], case["sr_dist"])
    ns, xlo, xhi = tsr.group_stats(flat, case["sr_dist"], case["nclust"])
    # the input holds empty groups, groups of one, larger groups, an
    # empty cluster, tied MI values and dead links
    assert (ns == 0).any() and (ns == 1).any() and (ns >= 3).any()
    assert not ns[-1].any()
    assert not bool(flat.live.all())
    assert ns.dtype == np.int32 and xlo.dtype == xhi.dtype == np.float32
    assert np.array_equal(ns, ns_j)
    assert np.array_equal(xlo.view(np.uint32), xlo_j.view(np.uint32))
    assert np.array_equal(xhi.view(np.uint32), xhi_j.view(np.uint32))

    gi, gj, mi = tsr.candidates(flat, T, case["sr_dist"], case["nclust"])
    assert gi.size > 10
    assert np.array_equal(gi, cand_j[0]) and np.array_equal(gj, cand_j[1])
    assert np.array_equal(mi.view(np.uint32), cand_j[2].view(np.uint32))


def test_host_helpers_match_jax():
    """fits_from_group_stats, threshold_tables and candidates_to_tables of
    both packages on the same arrays: bit-equal."""
    case = synthetic_segments(seed=9)
    (ns, xlo, xhi), _, (gi, gj, mi) = jax_flat_reduction(case)
    sr_dist, nclust = case["sr_dist"], case["nclust"]
    fits_t = tsr.fits_from_group_stats(ns, xlo, xhi, sr_dist)
    fits_j = jsr.fits_from_group_stats(ns, xlo, xhi, sr_dist)
    assert fits_t.keys() == fits_j.keys() == {1, 2, 3}
    for c in fits_j:
        for f in ("lens", "q95", "fitted"):
            assert np.array_equal(getattr(fits_t[c], f), getattr(fits_j[c], f))
        assert fits_t[c].coef == fits_j[c].coef
    T_t = tsr.threshold_tables(fits_t, nclust, sr_dist)
    T_j = jsr.threshold_tables(fits_j, nclust, sr_dist)
    assert np.array_equal(T_t.view(np.uint32), T_j.view(np.uint32))

    paint64 = case["paint"].astype(np.int64)
    args = (gi, gj, mi, gi.size, case["pos"].astype(np.int64), paint64,
            case["g"], case["B"], case["nb"], nclust)
    tabs_t, tabs_j = tsr.candidates_to_tables(*args), jsr.candidates_to_tables(*args)
    assert len(tabs_t) == len(tabs_j) == nclust
    assert sum(len(t) for t in tabs_t) >= gi.size
    for a, b in zip(tabs_t, tabs_j):
        for f in ("pos1", "pos2", "clust1", "clust2", "len", "MI"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


# --------------------------------------------------------------------------
# the pipeline: perform_mi_computation(backend="spmd")
# --------------------------------------------------------------------------
def port_case(nsnp=2500, nseq=32, g=399_999, seed=11, nclust=3):
    """tests/test_sr_reduce.py:_synth_case's input as the port's types:
    odd g (half-integer distances), 3 clusters, 2500 SNPs at block 1000
    -> 3 blocks, 6 tiles."""
    jsd, w = _synth(nsnp=nsnp, nseq=nseq, g=g, seed=seed)
    sd = SnpData(codes=jsd.codes, pos=jsd.pos, g=jsd.g, seq_names=jsd.seq_names,
                 acgtn_table=jsd.acgtn_table, uqe=jsd.uqe, r=jsd.r)
    j = jax_cds_var(jsd, nclust=nclust, seed=seed + 1)
    cds = CdsVar(var_estimate=j.var_estimate, cds_start=j.cds_start,
                 cds_end=j.cds_end, clusts=Clusters(np.array([1]), 0.0),
                 paint=j.paint, ref=j.ref, alt=j.alt,
                 allele_table=j.allele_table, nclust=nclust)
    return sd, w, cds, jsd, j


def run_mode(mod, sd, w, cds, out, sr_only=False, **kw):
    """One perform_mi_computation into out/Temp/{sr,lr}_links.tsv and
    out/Fit; returns (links, phases, {file: bytes})."""
    temp, fit = os.path.join(out, "Temp"), os.path.join(out, "Fit")
    os.makedirs(temp)
    phases = {}
    links = mod.perform_mi_computation(
        sd, w, cds, lr_save_path=os.path.join(temp, "lr_links.tsv"),
        sr_save_path=os.path.join(temp, "sr_links.tsv"), plt_folder=fit,
        sr_dist=SR_DIST, max_blk_sz=1000, srp_cutoff=3.0, backend="spmd",
        verbose=False, perform_sr_analysis_only=sr_only,
        phase_timings=phases, **kw,
    )
    files = {}
    for d in (temp, fit):
        for name in sorted(os.listdir(d)):
            with open(os.path.join(d, name), "rb") as fh:
                files[name] = fh.read()
    return links, phases, files


@pytest.fixture(scope="module")
def pipeline_case():
    return port_case()


@pytest.mark.parametrize("sr_only", [False, True])
def test_device_mode_byte_identical_to_host(pipeline_case, tmp_path, sr_only):
    sd, w, cds, _, _ = pipeline_case
    out = {mode: run_mode(tsweep, sd, w, cds, str(tmp_path / mode), sr_only,
                          sr_reduce=mode, device="cpu")
           for mode in ("host", "device")}
    (host, ph_h, f_h), (dev, ph_d, f_d) = out["host"], out["device"]
    assert ph_h["spmd"]["sr_reduce"] == "host"
    assert ph_d["spmd"]["sr_reduce"] == "device"
    assert ph_d["spmd"]["tiles"] == 6 and ph_d["spmd"]["cand_count"] > 0
    assert ph_d["spmd"]["cand_count"] < ph_d["spmd"]["sr_pairs"]
    names = {"sr_links.tsv", "c1_fit_data.npz", "c2_fit_data.npz",
             "c3_fit_data.npz"} | (set() if sr_only else {"lr_links.tsv"})
    assert names <= set(f_h) and f_h.keys() == f_d.keys()
    assert f_h["sr_links.tsv"].count(b"\n") > 100
    for name in f_h:
        assert f_d[name] == f_h[name], name
    assert np.array_equal(dev.srp_max, host.srp_max)
    assert np.array_equal(dev.ARACNE, host.ARACNE)


def test_device_mode_within_jax_fringe(pipeline_case, tmp_path):
    """The port's and the JAX package's device modes, link tables within
    the reference's fringe; both took the device path."""
    sd, w, cds, jsd, jcds = pipeline_case
    _, ph_t, _ = run_mode(tsweep, sd, w, cds, str(tmp_path / "torch"),
                          sr_reduce="device", device="cpu")
    _, ph_j, _ = run_mode(jsweep, jsd, w, jcds, str(tmp_path / "jax"),
                          sr_reduce="device", n_devices=1)
    assert ph_t["spmd"]["sr_reduce"] == ph_j["spmd"]["sr_reduce"] == "device"
    assert ph_t["spmd"]["sr_pairs"] == ph_j["spmd"]["sr_pairs"]
    assert_sr_within_fringe(str(tmp_path / "jax"), str(tmp_path / "torch"))
    lr_j, lr_t = (read_lr(str(tmp_path / k / "Temp" / "lr_links.tsv"))
                  for k in ("jax", "torch"))
    assert len(lr_j) > 1000
    assert len(set(lr_j) ^ set(lr_t)) <= fringe_bound(len(lr_j))
    assert max(abs(lr_j[k] - lr_t[k]) for k in set(lr_j) & set(lr_t)) <= 1.2e-4


def test_auto_over_budget_warns_and_takes_host(tmp_path, capsys, monkeypatch):
    sd, w, cds, _, _ = port_case(nsnp=1200, nseq=16)
    monkeypatch.setenv("LDW_SR_BUDGET", "1")
    _, phases, _ = run_mode(tsweep, sd, w, cds, str(tmp_path / "warn"),
                            sr_only=True, sr_reduce="auto", device="cpu")
    assert phases["spmd"]["sr_reduce"] == "host"
    assert "WARNING" in capsys.readouterr().out


@pytest.mark.parametrize("sr_reduce, total_sr, g, budget, want", [
    ("auto", 1000, 399_999, None, "device"),
    ("auto", 1000, 399_999, str(tsr.flat_peak_bytes(1000) - 1), "host"),
    ("auto", 1000, 399_999, str(tsr.flat_peak_bytes(1000)), "device"),
    ("device", 1000, 399_999, "1", "device"),
    ("part", 1000, 399_999, None, "device"),
    ("part", 1000, 399_999, "1", "host"),
    ("host", 1000, 399_999, None, "host"),
    ("device", 1000, 1 << 30, None, "host"),
    ("auto", 1000, (1 << 30) - 1, None, "device"),
    ("auto", 1000, 1 << 30, None, "host"),
])
def test_select_mode(monkeypatch, sr_reduce, total_sr, g, budget, want):
    """The JAX package's selection on one device, with the port's
    measured bytes a kept pair (`flat_peak_bytes`, not the JAX package's
    8) against LDW_SR_BUDGET (else 4 GiB without a card), g >= 2^30
    always on the host."""
    if budget is None:
        monkeypatch.delenv("LDW_SR_BUDGET", raising=False)
    else:
        monkeypatch.setenv("LDW_SR_BUDGET", budget)
    assert tsr.select_mode(sr_reduce, total_sr, g, "cpu", verbose=False) == want


def test_flat_model_counts_at_least_the_jax_rule():
    """`flat_peak_bytes` grows with the pairs and never counts fewer than
    the JAX package's 8 bytes a pair, so "auto" never admits a table to
    the card that the JAX rule would keep off it."""
    ns = [0, 1, 1000, 1 << 20, 156_118_853, 1 << 32]
    got = [tsr.flat_peak_bytes(n) for n in ns]
    assert got == sorted(got) and got[0] == 0
    assert all(b >= 8 * n for n, b in zip(ns, got))


def test_auto_warning_counts_the_flat_model(monkeypatch, capsys):
    """The host fallback's warning gives the bytes the flat model counts."""
    n = 10_000_000
    monkeypatch.setenv("LDW_SR_BUDGET", str(8 * n))
    assert tsr.select_mode("auto", n, 2_200_000, "cpu", verbose=False) == "host"
    out = capsys.readouterr().out
    assert f"({tsr.flat_peak_bytes(n) / 1e9:.1f} GB," in out and "WARNING" in out


def test_flat_and_part_footprints_run_on_the_cpu():
    """chip_smoke's footprint helpers run their passes on the CPU at the
    smallest shard (one segment of 2^19 pairs); memory statistics exist
    only on a card, so every byte count is 0 here."""
    import chip_smoke

    flat = chip_smoke.flat_footprint(1 << 19, "cpu", nclust=2)
    assert flat["pairs"] == 1 << 19 and flat["clusters"] == 2
    assert 0 < flat["candidates"] < flat["pairs"]
    assert {k: v for k, v in flat.items() if k.endswith("_a_pair")} == {
        "pass_bytes_a_pair": 0, "flatten_bytes_a_pair": 0,
        "stats_bytes_a_pair": 0, "candidates_bytes_a_pair": 0}
    part = chip_smoke.part_footprint(1 << 19, "cpu", nclust=2)
    assert part["pairs"] == 1 << 19 and part["candidates"] == flat["candidates"]
    assert part["range_bytes"] > 0 and part["range_pass_bytes"] == 0
    assert part["pass_bytes_a_pair"] == part["flat_bytes_a_pair"] == 0
