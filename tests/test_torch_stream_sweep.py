"""Slab streaming in the port (`parallel/slabs.py`, and the streamed
LR-only sweep, `parallel/fast_sweep.fast_lr_topk` on a slab pool; device="cpu":
the kernels' plain versions): the cases of the JAX package's
tests/test_stream_sweep.py.

  * panel order, `plan_budget` and `pack_nibbles` equal the JAX package's;
  * the slab cache's LRU and pinning as the JAX cache counts them, its
    pool strips holding the blocks' codes;
  * the streamed LR-only top-k equals the port's resident one: the same
    pairs with the same values (canonical pair order; streaming visits
    the tiles in another order, so only the order of exact ties could
    move), on the JAX test's data, on random data x cache capacities, and
    on a block that takes K2's plain version; uploads stay far below two
    per tile;
  * the streamed top-k against the JAX package's streamed sweep: the
    agreement of tests/test_torch_lr_sweep.py (near-ties at the k-th
    value, MI rtol 2e-4, atol 2e-5)."""

import numpy as np
import pytest
import torch

from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu.parallel import slabs as jslabs
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.ops import fused_tile
from ldweaver_tpu_torch.parallel import fast_sweep as tfs
from ldweaver_tpu_torch.parallel import slabs as tslabs
from tests.test_stream_sweep import _synth
from tests.test_torch_fast_sweep import one_torch_thread  # noqa: F401


def synth(**kw):
    sd, w = _synth(**kw)
    return SnpData(codes=sd.codes, pos=sd.pos, g=sd.g, seq_names=sd.seq_names,
                   acgtn_table=sd.acgtn_table, uqe=sd.uqe, r=sd.r), w, sd


def canon(t):
    lo = np.minimum(t[0], t[1])
    hi = np.maximum(t[0], t[1])
    o = np.lexsort((hi, lo))
    return lo[o], hi[o], t[2][o]


def assert_same_topk(a, b):
    for x, y in zip(canon(a), canon(b)):
        np.testing.assert_array_equal(x, y)


def test_panel_order_and_plan_budget_match_jax():
    nb = 9
    for panel in (1, 2, 4, 9, 16):
        pairs = list(tslabs.panel_pair_order(nb, panel))
        assert pairs == list(jslabs.panel_pair_order(nb, panel))
        assert sorted(pairs) == [(i, j) for i in range(nb) for j in range(i, nb)]
    for args in [(64, 128, 8, None), (64, 128, 8, 10 ** 9), (64, 128, 8, 64 * 128 * 5),
                 (616, 4096, 32, 50_331_648), (40, 64, 10, 25_000), (7, 3, 5, 30)]:
        assert tslabs.plan_budget(*args) == jslabs.plan_budget(*args), args
    # 48 MiB at the headline shape: 11 slots, panels of 9
    assert tslabs.plan_budget(616, 4096, 32, 50_331_648) == (True, 11, 9)
    # floor of 4 slabs: panel rows pinned + current column + a spare
    assert tslabs.plan_budget(64, 128, 8, 64 * 128 * 5) == (True, 4, 2)


@pytest.mark.parametrize("n", [8, 9])
def test_nibble_pack_roundtrip(n):
    rng = np.random.default_rng(n)
    host = rng.integers(0, 5, size=(13, n)).astype(np.uint8)
    packed = tslabs.pack_nibbles(host)
    assert np.array_equal(packed, jslabs.pack_nibbles(host))
    out = tslabs.unpack_nibbles(torch.from_numpy(packed), n)
    assert np.array_equal(out.numpy(), host)


def test_slab_cache_lru_and_pinning():
    rng = np.random.default_rng(0)
    rank_codes = rng.integers(0, 3, size=(16, 8 * 32)).astype(np.uint8)
    cache = tslabs.SlabCache(rank_codes, block=32, max_slabs=3, device="cpu")
    assert tuple(cache.pool.shape) == (16, 3 * 32)

    def strip(bi):
        off = cache.get(bi)
        return cache.pool[:, off : off + 32].numpy()

    assert np.array_equal(strip(0), rank_codes[:, 0:32])
    cache.get(1)
    cache.get(2)
    assert cache.uploads == 3
    cache.get(0)  # hit, becomes MRU
    assert cache.hits == 1
    cache.get(3)  # evicts 1 (LRU)
    cache.get(1)  # miss again
    assert cache.uploads == 5
    cache.pin([0, 1])
    cache.get(0)
    cache.get(1)
    u0 = cache.uploads
    cache.get(4)
    cache.get(5)  # evictions skip the pinned 0 and 1
    assert np.array_equal(strip(0), rank_codes[:, 0:32])
    assert np.array_equal(strip(1), rank_codes[:, 32:64])
    assert np.array_equal(strip(5), rank_codes[:, 160:192])
    assert cache.uploads == u0 + 2  # only 4 and 5 were uploaded
    cache.pin([5])
    with pytest.raises(RuntimeError, match="pinned"):
        cache.get(6)


def test_streaming_matches_resident_sweep():
    sd, w, _ = synth()
    block = 128
    res = tfs.fast_lr_topk(sd, w, block=block, sr_dist=5000, topk=256, device="cpu")
    state = tfs.prepare_fast_sweep(sd, w, block=block, hbm_budget_bytes=64 * 128 * 6,
                                   device="cpu")
    assert state.streaming and state.slab_cache is not None
    stream = tfs.fast_lr_topk(state=state, sr_dist=5000, topk=256)
    assert_same_topk(res, stream)
    nb = state.ranked.rank_codes.shape[1] // block
    uploads = state.slab_cache.uploads
    assert nb <= uploads <= nb + nb * nb // state.panel + nb < nb * (nb + 1)
    # a second sweep on the same state gives the same result
    again = tfs.fast_lr_topk(state=state, sr_dist=5000, topk=256)
    np.testing.assert_array_equal(again[0], stream[0])
    np.testing.assert_array_equal(again[2], stream[2])


@pytest.mark.parametrize("seed,slabs", [(11, 3), (12, 4), (13, 7)])
def test_streaming_equivalence_randomized(seed, slabs):
    sd, w, _ = synth(nsnp=640, nseq=40, g=150_000, seed=seed)
    block = 64
    res = tfs.fast_lr_topk(sd, w, block=block, sr_dist=4000, topk=128, device="cpu")
    budget = int(40 * 64 * (slabs + 1) / 0.6)  # -> max_slabs ~ slabs + 1
    state = tfs.prepare_fast_sweep(sd, w, block=block, hbm_budget_bytes=budget,
                                   device="cpu")
    assert state.streaming
    assert_same_topk(res, tfs.fast_lr_topk(state=state, sr_dist=4000, topk=128))


def test_streaming_fused_tile_branch():
    """A 2048 block takes the chunked stage 1, the (2,2,pure) tiles K2's
    plain version on the pool's columns."""
    from bench import synth as bench_synth

    codes, pos, uqe, r, w = bench_synth(8192, 64, seed=0)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    sd = SnpData(codes=codes, pos=pos, g=2_200_000, seq_names=[str(i) for i in range(64)],
                 acgtn_table=acgtn, uqe=uqe, r=r)
    res = tfs.fast_lr_topk(sd, w, block=2048, sr_dist=20000, topk=1024, device="cpu")
    state = tfs.prepare_fast_sweep(sd, w, block=2048, hbm_budget_bytes=64 * 2048 * 4,
                                   device="cpu")
    assert state.streaming and (2, 2, True) in state.buckets
    assert tfs.uses_fused_tile((2, 2, True), 2048)
    k2 = fused_tile.K2.launches
    got = tfs.fast_lr_topk(state=state, sr_dist=20000, topk=1024)
    assert fused_tile.K2.launches == k2  # CPU tensors: plain versions
    assert got[2].size == 1024
    assert_same_topk(res, got)


def test_streaming_matches_jax_streaming():
    from tests.test_torch_lr_sweep import ATOL, NEAR_TIE, RTOL

    sd, w, sd_j = synth(nsnp=640, nseq=40, g=150_000, seed=21)
    budget = int(40 * 64 * 7 / 0.6)
    ref = jfs.fast_lr_topk(state=jfs.prepare_fast_sweep(
        sd_j, w, block=64, n_devices=1, hbm_budget_bytes=budget),
        sr_dist=4000, topk=128)
    got = tfs.fast_lr_topk(sd, w, block=64, sr_dist=4000, topk=128,
                           hbm_budget_bytes=budget, device="cpu")
    vj = dict(zip(zip(ref[0].tolist(), ref[1].tolist()), ref[2].tolist()))
    vt = dict(zip(zip(got[0].tolist(), got[1].tolist()), got[2].tolist()))
    assert len(vt) == len(vj) == 128
    kth = min(ref[2][-1], got[2][-1])
    for k in set(vj) ^ set(vt):
        assert vj.get(k, vt.get(k)) - kth <= NEAR_TIE, k
    common = sorted(set(vj) & set(vt))
    np.testing.assert_allclose([vt[k] for k in common], [vj[k] for k in common],
                               rtol=RTOL, atol=ATOL)


def test_auto_budget_cpu_keeps_small_data_resident():
    assert tslabs.auto_budget("cpu") is None
    sd, w, _ = synth(nsnp=256, nseq=32)
    state = tfs.prepare_fast_sweep(sd, w, block=64, device="cpu")
    assert not state.streaming and state.slab_cache is None
