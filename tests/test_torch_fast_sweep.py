"""The port's fast backend at the tile level (`core/sweep.FastTileRunner`,
device="cpu": the kernels' plain versions): the cases of the JAX
package's tests/test_fast_sweep.py:84-227 and tests/test_pipelined_sweep.py
on in-repo synthetic data (the JAX tests read toy data that is not in the
repository).

  * the three transfer modes emit the same links: 'summary' and 'extract'
    equal 'full' exactly (SR pair sets, LR pair sets), also when the
    summary top-K saturates (the exact full-tile fallback), per row or
    globally, and after the runner demotes itself to full transfers;
  * the port's full-transfer tiles against the JAX package's: the same SR
    pair set, LR sets within the boundary noise its own summary test
    allows (<= max(4, 2%));
  * perform_mi_computation(backend="fast"): pipeline depth 1 and 7 write
    byte-identical TSVs, and equal those of backend="spmd" in both SR
    reduction modes; a tiny device budget (slabs streamed) keeps the SR
    TSV byte-identical and the LR lines as a set; against the JAX
    package's fast run within the fringe of tests/test_torch_pipeline.py."""

import os

import numpy as np
import pytest
import torch

import ldweaver_tpu.core.sweep as jsweep
import ldweaver_tpu_torch.core.sweep as tsweep
from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu_torch.core.cds import CdsVar, Clusters
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.parallel import fast_sweep as tfs
from ldweaver_tpu_torch.parallel import spmd_sweep as tspmd
from tests.test_pipelined_sweep import _dup_heavy_synth
from tests.test_sr_reduce import _synth_case
from tests.test_torch_pipeline import assert_lr_within_fringe

SR_DIST = 2000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module's tests run: the test files run in
    parallel processes, and torch's default of a thread a core would
    oversubscribe the machine (the plain versions' products spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_data(sd):
    return SnpData(codes=sd.codes, pos=sd.pos, g=sd.g, seq_names=sd.seq_names,
                   acgtn_table=sd.acgtn_table, uqe=sd.uqe, r=sd.r)


def port_cds(cv, sd):
    return CdsVar(var_estimate=np.zeros(1), cds_start=np.zeros(1, np.int64),
                  cds_end=np.zeros(1, np.int64), clusts=Clusters(np.array([1]), 0.0),
                  paint=cv.paint, ref=cv.ref, alt=cv.alt,
                  allele_table=sd.acgtn_table, nclust=cv.nclust)


def run_tiles(sd, hdw, transfer, topk, retain, approx, block=512, pkg="torch"):
    """Every tile of the grid through a runner, synchronously: LR {pair:
    MI}, SR pair set, the runner, the count of full-tile dispatches."""
    strat = tfs.stratify if pkg == "torch" else jfs.stratify
    ranked = strat(sd.codes, sd.acgtn_table, sd.pos, sd.r, block)
    paint = np.ones(sd.nsnp, dtype=np.int64)
    paint_sorted = np.concatenate(
        [paint[ranked.perm], np.zeros(ranked.pos.size - sd.nsnp, np.int64)])
    valid = np.arange(ranked.pos.size) < sd.nsnp
    nb = ranked.rank_codes.shape[1] // block
    sr_links, lr = [[]], []

    def sink(p1, p2, c1, c2, ln, mi):
        lr.extend(zip(np.asarray(p1).tolist(), np.asarray(p2).tolist(),
                      np.asarray(mi).tolist()))

    if pkg == "torch":
        runner = tsweep.FastTileRunner(
            ranked, paint_sorted, valid, hdw, float(hdw.sum()), sd.g, SR_DIST,
            retain, approx, sr_links, transfer=transfer, topk=topk,
            devices=["cpu"])
    else:
        runner = jsweep.FastTileRunner(
            ranked, paint_sorted, valid, hdw, float(hdw.sum()), sd.g, SR_DIST,
            retain, approx, sr_links, transfer=transfer, topk=topk)
    fulls = [0]
    orig = tspmd.full_tile_emit

    def spy(*a, **k):
        fulls[0] += 1
        return orig(*a, **k)

    # the runner's full transfers and the fallback of spmd_sweep both
    # extract through full_tile_emit
    tsweep.full_tile_emit = tspmd.full_tile_emit = spy
    try:
        for bi in range(nb):
            for bj in range(bi, nb):
                if pkg == "torch":
                    runner.emit_sr(bi, bj, *runner.finish(runner.dispatch(bi, bj), sink))
                else:
                    runner.finish(runner.dispatch(bi, bj), sink)
    finally:
        tsweep.full_tile_emit = tspmd.full_tile_emit = orig
    srk = {(int(a), int(b)) for parts in sr_links for t in parts
           for a, b in zip(t.pos1, t.pos2)}
    return {(a, b): m for a, b, m in lr}, srk, runner, fulls[0], nb * (nb + 1) // 2


@pytest.fixture(scope="module")
def synth():
    sd, w, _ = _synth_case(nsnp=1500, nseq=32, seed=11)
    return port_data(sd), w


def test_transfer_modes_agree(synth):
    """extract, summary and full emit the same pairs and values on a
    selective retention (~0.3% of the LR pairs kept)."""
    sd, w = synth
    approx, retain = 700_000.0, 2_000.0
    lr_f, sr_f, _, fulls, ntiles = run_tiles(sd, w, "full", 8192, retain, approx)
    assert fulls == ntiles and len(lr_f) > 500 and len(sr_f) > 1000
    for transfer in ("summary", "auto"):
        lr, sr, run, _, _ = run_tiles(sd, w, transfer, 8192, retain, approx)
        assert run.fallbacks == 0, transfer
        assert sr == sr_f and lr == lr_f, transfer
    # the synchronous one-tile entry point, tile by tile
    ranked = tfs.stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, 512)
    paint_sorted = np.ones(ranked.pos.size, np.int64)
    valid = np.arange(ranked.pos.size) < sd.nsnp
    sr_links, lr = [[]], {}

    def sink(p1, p2, c1, c2, ln, mi):
        lr.update(zip(zip(p1.tolist(), p2.tolist()), mi.tolist()))

    nb = ranked.rank_codes.shape[1] // 512
    for bi in range(nb):
        for bj in range(bi, nb):
            tsweep.sweep_block_pair_fast(
                ranked, paint_sorted, valid, w, float(w.sum()), sd.g, bi, bj,
                SR_DIST, retain, approx, sr_links, sink, device="cpu")
    assert lr == lr_f
    assert {(int(a), int(b)) for t in sr_links[0] for a, b in zip(t.pos1, t.pos2)} == sr_f


def test_runner_devices_default_to_the_first_card(synth, monkeypatch):
    """FastTileRunner(devices=None) runs one lane on the first card, as the
    JAX runner's default does (`jax.devices()[0]`); the card's resolution
    is stubbed to the CPU here."""
    sd, w = synth
    asked = []
    monkeypatch.setattr(tsweep, "resolve_device",
                        lambda d: asked.append(d) or torch.device("cpu"))
    ranked = tfs.stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, 512)
    runner = tsweep.FastTileRunner(
        ranked, np.ones(ranked.pos.size, np.int64),
        np.arange(ranked.pos.size) < sd.nsnp, w, float(w.sum()), sd.g, SR_DIST,
        2_000.0, 700_000.0, [[]])
    assert asked == ["cuda"] and len(runner.devs) == len(runner.caches) == 1


def test_full_transfer_matches_jax(synth):
    sd, w = synth
    approx, retain = 700_000.0, 2_000.0
    lr_t, sr_t, *_ = run_tiles(sd, w, "full", 8192, retain, approx)
    lr_j, sr_j, *_ = run_tiles(sd, w, "full", 8192, retain, approx, pkg="jax")
    assert sr_t == sr_j
    assert len(set(lr_t) ^ set(lr_j)) <= max(4, int(0.02 * len(lr_j)))
    common = set(lr_t) & set(lr_j)
    np.testing.assert_allclose([lr_t[k] for k in common], [lr_j[k] for k in common],
                               rtol=2e-4, atol=2e-5)


def test_summary_saturation_falls_back_to_full(synth):
    """A tiny top-K forces the summary path to saturate; the runner re-runs
    the tile full and emits exactly the full-transfer links."""
    sd, w = synth
    approx, retain = 700_000.0, 20_000.0  # ~30 kept a tile >> 16-row top-K
    lr_s, sr_s, run, _, _ = run_tiles(sd, w, "summary", 16, retain, approx)
    lr_f, sr_f, *_ = run_tiles(sd, w, "full", 16, retain, approx)
    assert run.fallbacks >= 1
    assert sr_s == sr_f and lr_s == lr_f and len(lr_f) > 1000


def test_per_row_saturation_exact_and_bounded():
    """Duplicated SNP patterns give single rows > 16 LR candidates above a
    selective threshold (per-row saturation, not a global overflow): the
    fallback is exact and costs at most one full dispatch a tile."""
    sd, w = _dup_heavy_synth()
    sd = port_data(sd)
    retain, approx = 500.0, 500_000.0
    lr_s, sr_s, run_s, fulls_s, ntiles = run_tiles(sd, w, "summary", 32768, retain, approx)
    lr_f, sr_f, _, fulls_f, _ = run_tiles(sd, w, "full", 32768, retain, approx)
    assert run_s.fallbacks >= 1, "expected per-row saturation"
    assert sr_s == sr_f and lr_s == lr_f
    assert fulls_s <= ntiles and fulls_f == ntiles


def test_saturation_demotes_to_full_transfers():
    """When every tile saturates (retention below all values) the runner
    demotes itself after 4 wasted summary dispatches."""
    sd, w = _dup_heavy_synth(nsnp=1280)
    sd = port_data(sd)
    lr_s, sr_s, run_s, fulls_s, ntiles = run_tiles(
        sd, w, "summary", 1024, retain=2000.0, approx=1000.0, block=256)
    assert ntiles >= 10 and run_s._demoted
    assert run_s.fallbacks == 4
    assert fulls_s == ntiles  # every tile extracted exactly once in full
    lr_f, sr_f, *_ = run_tiles(sd, w, "full", 1024, retain=2000.0, approx=1000.0,
                               block=256)
    assert sr_s == sr_f and lr_s == lr_f


def run_pmc(tmp_path, tag, sd, w, cds_var, backend, pkg=tsweep, **kw):
    """perform_mi_computation into tmp_path/tag/Temp/{sr,lr}_links.tsv."""
    temp = tmp_path / tag / "Temp"
    temp.mkdir(parents=True)
    if pkg is tsweep:
        kw["device"] = "cpu"
    pt = {}
    pkg.perform_mi_computation(
        sd, w, cds_var, lr_save_path=str(temp / "lr_links.tsv"),
        sr_save_path=str(temp / "sr_links.tsv"), plt_folder=None,
        srp_cutoff=3.0, backend=backend, verbose=False, phase_timings=pt,
        **{"sr_dist": SR_DIST, "max_blk_sz": 512, "lr_retain_links": 20_000, **kw})
    return str(tmp_path / tag), (temp / "sr_links.tsv").read_bytes(), \
        (temp / "lr_links.tsv").read_bytes(), pt


@pytest.fixture(scope="module")
def case():
    sd, w, cv = _synth_case(seed=41)
    return sd, w, cv, port_data(sd), port_cds(cv, sd)


def test_pipeline_depth_and_budget(case, tmp_path):
    _, w, _, sd, cv = case
    _, sr1, lr1, pt1 = run_pmc(tmp_path, "d1", sd, w, cv, "fast", pipeline_depth=1)
    _, sr7, lr7, _ = run_pmc(tmp_path, "d7", sd, w, cv, "fast", pipeline_depth=7)
    assert pt1["fast"]["tiles"] == 15 and len(lr1) > 10_000
    assert sr7 == sr1 and lr7 == lr1
    for mode in ("host", "device"):
        _, sr_s, lr_s, pt = run_pmc(tmp_path, f"spmd_{mode}", sd, w, cv, "spmd",
                                    sr_reduce=mode)
        assert pt["spmd"]["sr_reduce"] == mode
        assert sr_s == sr1 and lr_s == lr1, mode
    # a budget of ~3 of the 5 slabs: streamed in panels
    budget = int(sd.nseq * 512 * 4 / 0.6)
    _, sr_b, lr_b, pt = run_pmc(tmp_path, "slim", sd, w, cv, "fast",
                                pipeline_depth=3, device_budget_bytes=budget)
    fast = pt["fast"]
    assert fast["streaming"] and fast["max_slabs"] == 4 and fast["panel"] == 2
    assert 5 <= fast["uploads"] < 2 * fast["tiles"]
    assert sr_b == sr1
    assert sorted(lr_b.splitlines()) == sorted(lr1.splitlines())
    # the panels visit the tiles in another order, but the rows are
    # emitted in the canonical tile order
    assert lr_b == lr1


def test_fast_matches_jax_fast(case, tmp_path):
    """Port fast vs JAX fast within the fringe of tests/test_torch_pipeline.py.
    The top-10 SR rows are compared as a set: on this input ranks 3 and 4
    sit at a near-tie of srp (6.9115 and 6.9067 in the JAX run), whose
    order the background model's Beta fit decides (the port's spmd run
    orders them as its fast run does: byte-identical TSVs)."""
    from tests.test_torch_pipeline import fringe_bound, read_sr

    sd_j, w, cv_j, sd, cv = case
    a, *_ = run_pmc(tmp_path, "jax", sd_j, w, cv_j, "fast", pkg=jsweep, n_devices=1)
    b, *_ = run_pmc(tmp_path, "torch", sd, w, cv, "fast")
    assert_lr_within_fringe(a, b)
    key_j, mi_j, ar_j = read_sr(os.path.join(a, "Temp", "sr_links.tsv"))
    key_t, mi_t, ar_t = read_sr(os.path.join(b, "Temp", "sr_links.tsv"))
    assert len(key_j) > 100
    assert len(set(key_j) ^ set(key_t)) <= fringe_bound(len(key_j))
    idx_t = {k: i for i, k in enumerate(key_t)}
    shared = [(i, idx_t[k]) for i, k in enumerate(key_j) if k in idx_t]
    assert max(abs(mi_j[i] - mi_t[j]) for i, j in shared) <= 1.2e-4
    assert np.mean([ar_j[i] == ar_t[j] for i, j in shared]) >= 0.99
    assert set(key_j[:10]) == set(key_t[:10])
