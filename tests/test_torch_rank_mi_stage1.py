"""K1's LR stage-1 form (`ops/rank_mi.rank_mi_stage1`): the tile of a
bucket under the LR mask, reduced to the max and first argmax of every
128-column chunk inside the kernel.

On the CPU the wrapper takes the plain version, which must be K1's plain
tile followed by the sweep's `tile_masks`, `torch.where` and `chunk_max`,
bit for bit.  On the card (tests marked `cuda`, skipped without one) the
kernel's (value, column) pairs must be those of K1's store form after the
same torch ops, bit for bit: both forms compute each cell's MI with one
piece of code, and the mask and the reduction are exact.  No JAX here."""

import numpy as np
import pytest
import torch

from ldweaver_tpu_torch.ops import fused_tile, rank_mi
from ldweaver_tpu_torch.parallel import fast_sweep as tfs

G = 2_200_000
SR = 20000


def stage1_case(device, seed, nf, nt, S, Rf, Rt, pure, same, aligned=True,
                terms=3, npad=5):
    """(tile args of `rank_mi_tile`, LR args) of one tile on `device`: rows
    at column fs and columns at ts (ts = fs on a diagonal block pair, which
    needs Rf == Rt and nf == nt) of a sequence-major code tensor whose other
    columns hold stray codes 0..4.  Per-site r in 1..R (r == R everywhere
    when pure), the last `npad` sites of each side pads (r = 1, code 0,
    invalid, as `stratify` leaves them), positions sorted over the genome
    so that both short- and long-range cells occur."""
    rng = np.random.default_rng(seed)
    if aligned:
        fs = 16
        ts = fs if same else fs + 16 * (-(-nf // 16)) + 16
        ld = 16 * (-(-max(fs + nf, ts + nt) // 16))
    else:
        fs = 3
        ts = fs if same else fs + nf + 5
        ld = max(fs + nf, ts + nt) + 1
    codes = rng.integers(0, 5, (S, ld)).astype(np.uint8)
    r = np.ones(ld, np.int64)
    valid = np.ones(ld, bool)
    for lo, n, R in ((fs, nf, Rf), (ts, nt, Rt)):
        rr = np.full(n, R) if pure else rng.integers(1, R + 1, n)
        rr[0] = R
        c = (rng.random((S, n)) * rr[None, :]).astype(np.uint8)
        c[:R, 0] = np.arange(R)
        k = min(npad, n - 1)
        rr[n - k:] = 1
        c[:, n - k:] = 0
        valid[lo + n - k : lo + n] = False
        codes[:, lo : lo + n] = c
        r[lo : lo + n] = rr
    pos = np.sort(rng.choice(np.arange(1, G + 1), ld, replace=False)).astype(np.int32)
    w = rng.uniform(0.05, 0.5, S)
    codes = torch.from_numpy(codes).to(device)
    w32, parts = tfs.wparts(w)
    w32, parts = w32.to(device), parts[:terms].contiguous().to(device)
    f32 = torch.from_numpy(r.astype(np.float32)).to(device)
    pos = torch.from_numpy(pos).to(device)
    valid = torch.from_numpy(valid).to(device)
    tile = (codes, fs, ts, nf, nt, parts,
            tfs.rank_marginals(codes, fs, nf, w32, Rf),
            tfs.rank_marginals(codes, ts, nt, w32, Rt),
            f32[fs : fs + nf], f32[ts : ts + nt],
            float(np.float32(w.sum())), Rf, Rt, pure)
    lr = (pos[fs : fs + nf], pos[ts : ts + nt], valid[fs : fs + nf],
          valid[ts : ts + nt], same)
    return tile, lr


def stored_stage1(tile, lr):
    """K1's stored tile, then the sweep's mask and `chunk_max` in torch ops:
    what the stage-1 form replaces."""
    mi = rank_mi.rank_mi_tile(*tile)
    _, lr_ok = tfs.tile_masks(*lr, G, SR)
    return fused_tile.chunk_max(torch.where(lr_ok, mi, float("-inf")))


def assert_bit_equal(got, want):
    (gv, gc), (wv, wc) = got, want
    assert gv.dtype == torch.float32 and gc.dtype == torch.int32
    assert gv.shape == gc.shape == wv.shape == wc.shape
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(gc, wc)


# the r = 3 buckets of the LR screen: (Rf, Rt, diagonal block pair)
TILES = [(2, 3, False), (3, 3, False), (3, 3, True)]


@pytest.mark.parametrize("pure", [True, False])
@pytest.mark.parametrize("Rf,Rt,same", TILES)
def test_plain_stage1_is_the_tile_masked_and_chunk_maxed(Rf, Rt, same, pure):
    """At a block of 1,152 (> 1024, nine chunks) the plain version equals
    the plain tile after `tile_masks`, `torch.where` and `chunk_max` bit
    for bit, with live and all -inf chunks, and launches no kernel."""
    tile, lr = stage1_case("cpu", Rf * 10 + Rt + 100 * pure + 1000 * same,
                           1152, 1152, 40, Rf, Rt, pure, same)
    before = (rank_mi.K1.launches, rank_mi.K1_STAGE1.launches)
    got = rank_mi.rank_mi_stage1(*tile, *lr, g=G, sr_dist=SR)
    assert (rank_mi.K1.launches, rank_mi.K1_STAGE1.launches) == before
    assert got[0].shape == (1152, 9)
    assert_bit_equal(got, stored_stage1(tile, lr))
    fin = torch.isfinite(got[0])
    assert fin.any() and not fin.all()
    # pad rows: every chunk -inf at its first column
    first = torch.arange(9, dtype=torch.int32) * 128
    assert torch.equal(got[1][-1], first) and bool(torch.isneginf(got[0][-1]).all())


@pytest.mark.parametrize("block", [1024, 1152, 1200, 2048])
def test_kernel_stage1_takes_wide_whole_chunks(block):
    """The stage-1 forms take tiles wider than 1024 columns in whole
    128-column chunks; K2 of those the (2, 2, pure) ones alone."""
    wide = block > 1024 and block % 128 == 0
    assert tfs.kernel_stage1(block) == wide
    assert tfs.uses_fused_tile((2, 2, True), block) == wide
    for key in ((2, 2, False), (2, 3, True), (3, 3, False), (1, 2, False)):
        assert not tfs.uses_fused_tile(key, block)


def test_launch_counter_resets_both_forms():
    """K1's two forms count on counters of their own, each reset alone."""
    store, stage1 = rank_mi.LaunchCounter(), rank_mi.LaunchCounter()
    store.launches, stage1.launches = 3, 4
    store.by_bucket[(2, 3, True)] += 3
    stage1.by_bucket[(3, 3, False)] += 4
    store.reset()
    assert (store.launches, stage1.launches) == (0, 4)
    assert not store.by_bucket and stage1.by_bucket == {(3, 3, False): 4}
    stage1.reset()
    assert stage1.launches == 0 and not stage1.by_bucket
    assert rank_mi.K1 is not rank_mi.K1_STAGE1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def card_stage1(tile, lr):
    before = (rank_mi.K1.launches, rank_mi.K1_STAGE1.launches)
    got = rank_mi.rank_mi_stage1(*tile, *lr, g=G, sr_dist=SR)
    torch.cuda.synchronize()
    assert (rank_mi.K1.launches, rank_mi.K1_STAGE1.launches) == (before[0], before[1] + 1)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("pure", [True, False])
@pytest.mark.parametrize("Rf,Rt,same", TILES)
def test_stage1_kernel_is_the_store_form_on_card(cuda_device, Rf, Rt, same,
                                                 pure, terms):
    """The screen's shape: B = 4096, S = 616, every term count."""
    tile, lr = stage1_case(cuda_device, Rf * 10 + Rt + 100 * pure + terms,
                           4096, 4096, 616, Rf, Rt, pure, same, terms=terms)
    got = card_stage1(tile, lr)
    assert_bit_equal(got, stored_stage1(tile, lr))
    assert bool(torch.isfinite(got[0]).any())


# every warp-tile geometry of mma_planes::Planes (block tiles 32 to 128
# columns wide: one to four sub-tiles a chunk) and the marginals-only
# buckets
CARD_BUCKETS = [
    (1, 2, False), (2, 1, False), (2, 2, False), (2, 2, True), (3, 2, False),
    (2, 3, True), (2, 4, False), (4, 3, False), (3, 5, False), (4, 4, False),
    (5, 5, False), (5, 2, False),
]
# (nf, nt, S, aligned): ragged row blocks, a single row, several chunks; S
# below one 64-genome chunk and off the 8-genome copy width (plain loads)
EDGE_SHAPES = [(129, 384, 200, True), (1, 128, 15, False), (17, 256, 616, True),
               (100, 256, 70, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("nf,nt,S,aligned", EDGE_SHAPES)
@pytest.mark.parametrize("Rf,Rt,pure", CARD_BUCKETS)
def test_stage1_kernel_edge_shapes_on_card(cuda_device, Rf, Rt, pure, nf, nt,
                                           S, aligned):
    same = Rf == Rt and nf == nt
    tile, lr = stage1_case(cuda_device, Rf * 10 + Rt + nf + nt + S, nf, nt, S,
                           Rf, Rt, pure, same, aligned=aligned)
    assert_bit_equal(card_stage1(tile, lr), stored_stage1(tile, lr))


@pytest.mark.cuda
def test_screen_call_takes_stage1_on_card(cuda_device):
    """On the benchmark cell's shapes (616 genomes x 131,072 SNPs, block
    4096, top-1024): every K1 tile of a `fast_lr_topk` call takes the
    stage-1 form (150 launches, none of the store form) and gives the
    stored tile's candidates bit for bit; K2 takes the other 378."""
    from benchmark import harness
    from ldweaver_tpu_torch.core.snp_tensor import SnpData, derive_site_stats

    _, config, traffic, _ = harness.find_cell(harness.load_spec(), "spn616.screen")
    inputs = harness.load_module("gen", traffic["generator"]).make_inputs(
        config, 2147483659, cuda_device)
    uqe, r = derive_site_stats(inputs.acgtn)
    sd = SnpData(codes=inputs.codes, pos=inputs.pos, g=inputs.g,
                 seq_names=[str(s) for s in range(inputs.nseq)],
                 acgtn_table=inputs.acgtn, uqe=uqe, r=r)
    B, topk = int(config["block"]), int(traffic["topk"])
    state = tfs.prepare_fast_sweep(sd, inputs.w, block=B, device=cuda_device)
    kw = dict(state=state, sr_dist=int(config["sr_dist"]), topk=topk,
              precision_terms=int(traffic["precision_terms"]))
    tfs.fast_lr_topk(**kw)
    rank_mi.K1.reset()
    rank_mi.K1_STAGE1.reset()
    fused_tile.K2.reset()
    tfs.fast_lr_topk(**kw)
    torch.cuda.synchronize()
    k1_tiles = {key: len(t) for key, t in state.buckets.items()
                if not tfs.uses_fused_tile(key, B)}
    assert rank_mi.K1.launches == 0
    assert rank_mi.K1_STAGE1.launches == sum(k1_tiles.values()) == 150
    assert dict(rank_mi.K1_STAGE1.by_bucket) == k1_tiles
    assert fused_tile.K2.launches == 528 - 150
    dev = state.dev
    for key, tiles in state.buckets.items():
        if tfs.uses_fused_tile(key, B):
            continue
        Rf, Rt, pure = key
        for bi, bj in tiles:
            fs, ts = bi * B, bj * B
            tile = (dev.codes, fs, ts, B, B, dev.wparts, state.marg[bi, :Rf],
                    state.marg[bj, :Rt], dev.r[fs : fs + B], dev.r[ts : ts + B],
                    dev.neff, Rf, Rt, pure)
            lr = (dev.pos[fs : fs + B], dev.pos[ts : ts + B],
                  dev.valid[fs : fs + B], dev.valid[ts : ts + B], bi == bj)
            got = rank_mi.rank_mi_stage1(*tile, *lr, g=inputs.g, sr_dist=kw["sr_dist"])
            mi = rank_mi.rank_mi_tile(*tile)
            _, lr_ok = tfs.tile_masks(*lr, inputs.g, kw["sr_dist"])
            assert_bit_equal(got, fused_tile.chunk_max(
                torch.where(lr_ok, mi, float("-inf"))))


def _smoke_row(S, terms=3, **key):
    return dict(key, S=S, n_terms=terms, max_abs_err=0.0, ms=1.0, plain_ms=2.0,
                stored_ms=1.5, bound_ms=0.5, bound_by="operations",
                bound_frac=0.5, library_ms=0.25)


def _smoke_rows(S, buckets, terms=3):
    return {(Rf, Rt, pure): _smoke_row(S, terms, Rf=Rf, Rt=Rt, pure=pure)
            for Rf, Rt, pure in buckets}


@pytest.mark.parametrize("stray", [False, True])
def test_smoke_kernels_line_keeps_k1_forms_apart(monkeypatch, tmp_path, capsys,
                                                 stray):
    """chip_smoke's kernels line, every phase stubbed: `rank_mi_stage1[...]`
    rows carry the stage-1 form's launches, `rank_mi_tile[...]` rows the
    store form's alone; a stage-1 launch in a bucket that no stage-1 row
    measured at the sweep's depth raises."""
    import json

    import chip_smoke as cs

    lr_b = cs.LR_BUCKETS
    s1_lr = {b: 10 + i for i, b in enumerate(lr_b)}
    if stray:
        s1_lr[(4, 4, False)] = 1
    stubs = dict(
        probe=lambda: ("card", "card, 700 W"), build=lambda: None,
        kernel_phase=lambda S, buckets, seed, terms=3: _smoke_rows(S, buckets, terms),
        stage1_phase=lambda S, buckets, seed, terms=3: _smoke_rows(S, buckets, terms),
        fused_phase=lambda terms=3, nseq=cs.K2_S: _smoke_row(nseq, terms),
        compat_kernel_phase=lambda: {(cs.SHARDED_B, cs.SHARDED_B): _smoke_row(cs.S)},
        slice_phase=lambda: (5, {(2, 3, False): 5}),
        headline_phase=lambda: ({(2, 3, False): 7}, {}, 0, {}),
        headline_fast_phase=lambda inputs: {(2, 3, False): 7},
        lr_phase=lambda: ({"k2_launches": 378, "stream_k2_launches": 378},
                          ({}, s1_lr), ({}, {b: 20 + i for i, b in enumerate(lr_b)})),
        pipeline_leg_phase=lambda: ({(2, 3, False): 9}, {}),
        streaming_leg_phase=lambda: (
            _smoke_rows(16384, lr_b), _smoke_rows(16384, lr_b), _smoke_row(16384),
            {"k1_by_bucket": {}, "resident_k1_by_bucket": {},
             "k1_stage1_by_bucket": {b: 30 + i for i, b in enumerate(lr_b)},
             "resident_k1_stage1_by_bucket": {b: 40 + i for i, b in enumerate(lr_b)},
             "k2_launches": 3, "resident_k2_launches": 3}, {}),
        compat_phase=lambda: {}, sharded_phase=lambda: 36,
        multi_big_phase=lambda inputs: ({(2, 3, False): 7},
                                        {b: 50 + i for i, b in enumerate(lr_b)}, 378, 36),
        terms_phase=lambda: (
            {t: {"k1": _smoke_rows(cs.K2_S, cs.TERMS_K1_BUCKETS, t),
                 "k1s1": _smoke_rows(cs.K2_S, lr_b, t), "k2": _smoke_row(cs.K2_S, t),
                 "k3": {}, "k3_host_launches": 0} for t in cs.TERMS},
            {t: {"k1_by_bucket": {}, "k2_launches": 378,
                 "k1_stage1_by_bucket": {b: 60 + 10 * t + i for i, b in enumerate(lr_b)}}
             for t in cs.TERMS}),
    )
    for name, fn in stubs.items():
        monkeypatch.setattr(cs, name, fn)
    for name in ("small_phase", "resume_phase", "cli_phase", "one_card_phase",
                 "part_footprint_phase", "flat_footprint_phase", "multi_small_phase",
                 "multi_cli_phase", "multi_auto_phase"):
        monkeypatch.setattr(cs, name, lambda *a: None)
    monkeypatch.setattr(cs, "WORK", str(tmp_path / "work"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if stray:
        with pytest.raises(RuntimeError, match="stage-1 form launched on the LR sweep"):
            cs.main()
        return
    cs.main()
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith('{"kernels"'))["kernels"]
    rows = {r["name"]: r for r in line}
    for i, (Rf, Rt, pure) in enumerate(lr_b):
        b = f"Rf={Rf},Rt={Rt},{'pure' if pure else 'general'}"
        assert rows[f"rank_mi_tile[{b},S={cs.K2_S}]"]["launches"] == 0
        s1 = rows[f"rank_mi_stage1[{b},S={cs.K2_S}]"]
        assert (s1["launches"], s1["launches_lr_streamed"],
                s1["launches_multi_lr"]) == (10 + i, 20 + i, 50 + i)
        assert s1["stored_ms"] == 1.5
        assert rows[f"rank_mi_stage1[{b},S={cs.S}]"]["launches"] == 0
        s1 = rows[f"rank_mi_stage1[{b},S=16384]"]
        assert (s1["launches"], s1["launches_resident"]) == (30 + i, 40 + i)
        assert rows[f"rank_mi_tile[{b},S=16384]"]["launches"] == 0
        for t in cs.TERMS:
            assert rows[f"rank_mi_stage1[{b},S={cs.K2_S},t={t}]"]["launches"] == 60 + 10 * t + i
            assert rows[f"rank_mi_tile[{b},S={cs.K2_S},t={t}]"]["launches"] == 0
    assert rows[f"rank_mi_tile[Rf=2,Rt=3,general,S={cs.S}]"]["launches"] == 5
