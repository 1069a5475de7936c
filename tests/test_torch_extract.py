"""Per-tile link extraction in the port (`spmd_sweep.extract_tile`, on
the CPU) against the JAX package's `_build_tile_extract` on the same
stratified inputs, and the port's whole BLK5 sweep against the JAX SPMD
sweep when retention is unselective enough to force the retry and the
full-tile fallback.

Equal: n_sr, the SR flat indices, n_lr, the certificate and the max per-
row LR count.  Within 2e-5: SR and LR values.  The LR flat indices agree
wherever the value is not within 2e-5 of a neighbour in the sorted list
(f32 differences may swap near-ties)."""

import numpy as np
import pytest
import torch

from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu.parallel import spmd_sweep as jss
from ldweaver_tpu_torch.parallel import spmd_sweep as tss
from tests.test_stream_sweep import _synth

ATOL = 2e-5


def setup(nsnp, nseq, g, seed, block):
    sd, w = _synth(nsnp=nsnp, nseq=nseq, g=g, seed=seed)
    ranked = jfs.stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, block)
    valid = np.arange(ranked.pos.size) < sd.nsnp
    return sd, w, ranked, valid


def jax_extract(ranked, valid, w, bi, bj, *, sr_dist, g, K, k_row, P_sr,
                prob):
    import jax.numpy as jnp

    B = ranked.block
    f_sl = slice(bi * B, (bi + 1) * B)
    t_sl = slice(bj * B, (bj + 1) * B)
    r_f = np.asarray(ranked.r[f_sl], np.float32)
    r_t = np.asarray(ranked.r[t_sl], np.float32)
    pure = bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj])
    fn = jss._build_tile_extract(
        B, sr_dist, g, K, k_row, P_sr, int(ranked.block_rmax[bi]),
        int(ranked.block_rmax[bj]), 3, pure,
    )
    w32, parts = jfs._wparts(w)
    outs = fn(
        jnp.asarray(np.ascontiguousarray(ranked.rank_codes[:, f_sl].T)),
        jnp.asarray(np.ascontiguousarray(ranked.rank_codes[:, t_sl].T)),
        jnp.asarray(w32), jnp.asarray(parts), r_f, r_t,
        jnp.asarray(np.float32(w.sum())),
        np.asarray(ranked.pos[f_sl], np.int32),
        np.asarray(ranked.pos[t_sl], np.int32),
        valid[f_sl], valid[t_sl], np.asarray([bi, bj], np.int32), np.True_,
        np.float32(prob),
    )
    n_lr, exact, row_max, vals, idx, n_sr, sr_idx, sr_vals = (
        np.asarray(o) for o in outs
    )
    return dict(n_lr=int(n_lr), exact=bool(exact), row_max=int(row_max),
                vals=vals, idx=idx, n_sr=int(n_sr), sr_idx=sr_idx,
                sr_vals=sr_vals)


def compare_tile(sd, w, ranked, valid, bi, bj, sr_dist, lr_prob):
    B = ranked.block
    K, k_row = jss.extract_dims(B, lr_prob)
    counts = jss.sr_pair_counts(ranked, valid, sd.g, sr_dist)
    ladder = jss.sr_cap_ladder(jss._next_pow2(int(counts.max())))
    ref = jax_extract(
        ranked, valid, w, bi, bj, sr_dist=sr_dist, g=sd.g, K=K, k_row=k_row,
        P_sr=jss.sr_cap_class(int(counts[bi, bj]), ladder), prob=lr_prob,
    )
    dev = tss.device_inputs(ranked, valid, w, float(w.sum()), "cpu")
    got = tss.extract_tile(
        dev, bi, bj, block=B, sr_dist=sr_dist, g=sd.g, K=K, k_row=k_row,
        prob=lr_prob, Rf=int(ranked.block_rmax[bi]),
        Rt=int(ranked.block_rmax[bj]),
        pure=bool(ranked.block_pure[bi]) and bool(ranked.block_pure[bj]),
    )
    assert got.n_sr == ref["n_sr"] == counts[bi, bj]
    assert np.array_equal(got.sr_idx, ref["sr_idx"][: ref["n_sr"]])
    np.testing.assert_allclose(
        got.sr_vals, ref["sr_vals"][: ref["n_sr"]], rtol=0, atol=ATOL
    )
    assert got.n_lr == ref["n_lr"]
    assert got.exact == ref["exact"]
    assert got.row_max == ref["row_max"]
    n = min(got.n_lr, got.vals.size)
    assert got.vals.size == ref["vals"].size
    np.testing.assert_allclose(got.vals[:n], ref["vals"][:n], rtol=0, atol=ATOL)
    v = ref["vals"][:n].astype(np.float64)
    gap = np.full(n, np.inf)
    if n > 1:
        with np.errstate(invalid="ignore"):  # -inf - -inf past a lossy row
            d = np.abs(np.diff(v))
        gap[:-1] = d
        gap[1:] = np.minimum(gap[1:], d)
    isolated = gap > 2 * ATOL
    assert np.array_equal(got.idx[:n][isolated], ref["idx"][:n][isolated])
    return got, counts[bi, bj]


def pick_tiles(ranked, valid, g, sr_dist):
    nb = ranked.rank_codes.shape[1] // ranked.block
    counts = jss.sr_pair_counts(ranked, valid, g, sr_dist)
    off = [(i, j) for i in range(nb) for j in range(i + 1, nb)]
    return dict(
        diagonal=(0, 0),
        off_diagonal=next(p for p in off if counts[p] > 0),
        zero_sr=next(p for p in off if counts[p] == 0),
    )


@pytest.mark.parametrize("kind", ["diagonal", "off_diagonal", "zero_sr"])
def test_tile_matches_jax(kind):
    sd, w, ranked, valid = setup(1400, 48, 2_000_000, 5, 256)
    bi, bj = pick_tiles(ranked, valid, sd.g, 20000)[kind]
    got, n_sr = compare_tile(sd, w, ranked, valid, bi, bj, 20000, 0.97)
    assert got.n_lr > 0
    assert (n_sr == 0) == (kind == "zero_sr")


def test_non_128_multiple_block():
    """A 1000-multiple tile (what round_blk_sz yields) is no multiple of
    128: every tile of the grid must still agree."""
    sd, w, ranked, valid = setup(700, 40, 400_000, 9, 200)
    nb = ranked.rank_codes.shape[1] // ranked.block
    assert 200 % 128 and valid.size > sd.nsnp  # ragged and padded
    for bi in range(nb):
        for bj in range(bi, nb):
            compare_tile(sd, w, ranked, valid, bi, bj, 5000, 0.99)


def test_sweep_retry_and_fallback_match_jax():
    """lr_prob == 0 keeps every LR pair; with a tiny top-K cap the tiles
    saturate and must be recovered exactly by the boosted retry or the
    full-tile fallback.  Same pairs in the same order as the JAX SPMD
    sweep under the same cap, MI within 2e-5."""
    sd, w = _synth(nsnp=600, nseq=40, g=300_000, seed=4)
    hdw = w.astype(np.float64)
    neff = float(hdw.sum())
    paint = np.ones(sd.nsnp, dtype=np.int64)
    retain, approx = 1e9, 1000.0

    def run(sweep, **kw):
        sr_links, rows = [[]], []

        def sink(p1, p2, c1, c2, ln, mi):
            rows.extend(zip(p1.tolist(), p2.tolist(), mi.tolist()))

        out = sweep(sd, hdw, paint, neff, 2000, retain, approx, sr_links,
                    sink, block=256, topk_cap=64, verbose=False, **kw)
        return rows, sr_links, out

    rows_t, sr_t, (stats, _) = run(tss.blk5_sweep, device=torch.device("cpu"),
                                   sr_reduce="host")
    rows_j, sr_j, _ = run(jss.spmd_blk5_sweep, sr_reduce="host")
    assert stats["retries"] >= 1 and stats["fallbacks"] >= 1, stats
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    np.testing.assert_allclose(
        [r[2] for r in rows_t], [r[2] for r in rows_j], rtol=0, atol=ATOL
    )

    def flat(lst):
        return [(t.pos1.tolist(), t.pos2.tolist()) for parts in lst for t in parts]

    assert flat(sr_t) == flat(sr_j)
    mi = lambda lst: np.concatenate([t.MI for parts in lst for t in parts])  # noqa: E731
    np.testing.assert_allclose(mi(sr_t), mi(sr_j), rtol=0, atol=ATOL)
