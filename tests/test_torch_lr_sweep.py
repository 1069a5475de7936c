"""The port's LR-only sweep (`fast_lr_topk`, device="cpu": the kernels'
plain versions) against the JAX package's `fast_lr_topk` on one device of
the virtual CPU mesh, on the bench.py `synth` recipe at 64 genomes x
8,192 SNPs.

Block 2048 takes the chunked stage 1: the (2, 2, pure) tiles go through
K2's plain version, the r = 3 buckets through K1's stage-1 form, whose
candidates must be those of K1's stored tile after `tile_masks` and
`tile_lr_topk` bit for bit, resident and streaming.
Block 512 takes the per-row top-k branch everywhere.  The top-k must hold
the same pairs in the same order apart from near-ties (|dMI| <= 1e-5, at
the k-th value for pairs on one side only), with MI within the tile
tolerance of tests/test_fast_sweep.py:260 (rtol 2e-4, atol 2e-5)."""

import numpy as np
import pytest

from bench import synth
from ldweaver_tpu.core.snp_tensor import SnpData as JaxSnpData
from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.ops import fused_tile, rank_mi
from ldweaver_tpu_torch.parallel import fast_sweep as tfs

G = 2_200_000
RTOL, ATOL = 2e-4, 2e-5
NEAR_TIE = 1e-5
TOPK = 1024


def snp_data(cls, nsnp, nseq, seed=0):
    codes, pos, uqe, r, w = synth(nsnp, nseq, seed=seed)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    sd = cls(codes=codes, pos=pos, g=G,
             seq_names=[str(i) for i in range(nseq)], acgtn_table=acgtn,
             uqe=uqe, r=r)
    return sd, w


@pytest.fixture(scope="module")
def data():
    return {pkg: snp_data(cls, 8192, 64)
            for pkg, cls in (("jax", JaxSnpData), ("torch", SnpData))}


def assert_topk_agree(ref, got):
    p1j, p2j, mj = ref
    p1t, p2t, mt = got
    assert mj.size == TOPK and mt.size == TOPK
    assert np.all(np.diff(mt) <= 0)
    kj = list(zip(p1j.tolist(), p2j.tolist()))
    kt = list(zip(p1t.tolist(), p2t.tolist()))
    # pairs on one side only sit at the k-th value
    vj, vt = dict(zip(kj, mj)), dict(zip(kt, mt))
    for k in set(kj) ^ set(kt):
        v = vj.get(k, vt.get(k))
        assert v - min(mj[-1], mt[-1]) <= NEAR_TIE, (k, v)
    common = sorted(set(kj) & set(kt))
    a = np.array([vj[k] for k in common], np.float64)
    b = np.array([vt[k] for k in common], np.float64)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    # the same order, apart from swaps of near-tied neighbours
    for i in np.flatnonzero([x != y for x, y in zip(kj, kt)]):
        assert abs(float(mj[i]) - float(mt[i])) <= NEAR_TIE, i


@pytest.mark.parametrize("block", [2048, 512])
def test_fast_lr_topk_matches_jax(data, block):
    sd_j, w = data["jax"]
    sd_t, _ = data["torch"]
    ref = jfs.fast_lr_topk(sd_j, w, block=block, sr_dist=20000, topk=TOPK,
                           n_devices=1)
    state = tfs.prepare_fast_sweep(sd_t, w, block=block, device="cpu")
    if block == 2048:  # both stage-1 branches and both tile routes run
        assert (2, 2, True) in state.buckets and len(state.buckets) > 1
        assert tfs.uses_fused_tile((2, 2, True), block)
    else:
        assert not tfs.uses_fused_tile((2, 2, True), block)
    counters = (rank_mi.K1, rank_mi.K1_STAGE1, fused_tile.K2)
    before = [c.launches for c in counters]
    got = tfs.fast_lr_topk(sr_dist=20000, topk=TOPK, state=state)
    # CPU tensors take the plain versions: no kernel launches
    assert [c.launches for c in counters] == before
    assert_topk_agree(ref, got)


@pytest.mark.parametrize("streaming", [False, True])
def test_k1_stage1_tiles_match_the_stored_tile(data, streaming):
    """Every r = 3 tile at block 2048 takes K1's stage-1 form, whose top-k
    candidates are the stored tile's after the mask and `tile_lr_topk`,
    bit for bit (so the sweep's answer is the one it was before the form
    existed); the whole top-k agrees with the JAX package's sweep, resident
    and streaming through a slab pool."""
    import torch

    sd_j, w = data["jax"]
    sd_t, _ = data["torch"]
    budget = 64 * 2048 * 4 if streaming else None
    state = tfs.prepare_fast_sweep(sd_t, w, block=2048, device="cpu",
                                   hbm_budget_bytes=budget)
    assert state.streaming == streaming
    B, g = state.block, int(state.g)
    k1_keys = [k for k in state.buckets if not tfs.uses_fused_tile(k, B)]
    assert tfs.kernel_stage1(B) and any(k[1] == 3 for k in k1_keys)
    dev = state.dev
    for key in k1_keys:
        Rf, Rt, pure = key
        for bi, bj in state.buckets[key]:
            cols = None
            if streaming:
                cache = state.slab_cache
                cache.unpin()
                cache.pin([bi, bj])
                cols = (cache.get(bi), cache.get(bj))
            got = tfs._tile_candidates(state, bi, bj, key, 20000, TOPK, cols)
            fs, ts = bi * B, bj * B
            cf, ct = cols if cols is not None else (fs, ts)
            mi = rank_mi.rank_mi_tile(
                dev.codes, cf, ct, B, B, dev.wparts, state.marg[bi, :Rf],
                state.marg[bj, :Rt], dev.r[fs : fs + B], dev.r[ts : ts + B],
                dev.neff, Rf, Rt, pure)
            _, lr_ok = tfs.tile_masks(dev.pos[fs : fs + B], dev.pos[ts : ts + B],
                                      dev.valid[fs : fs + B],
                                      dev.valid[ts : ts + B], bi == bj, g, 20000)
            want = tfs.tile_lr_topk(torch.where(lr_ok, mi, float("-inf")), B, B, TOPK)
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
    if streaming:
        state.slab_cache.unpin()
    ref = jfs.fast_lr_topk(sd_j, w, block=2048, sr_dist=20000, topk=TOPK,
                           n_devices=1, hbm_budget_bytes=budget)
    assert_topk_agree(ref, tfs.fast_lr_topk(sr_dist=20000, topk=TOPK, state=state))


def test_tile_lr_topk_pads_a_ragged_chunk():
    """A block width that is not a multiple of 128 pads with -inf and
    clamps the pad-only chunk's column (fast_sweep.py:286-300)."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    masked = rng.normal(size=(40, 1100)).astype(np.float32)
    masked[rng.random(masked.shape) < 0.3] = -np.inf
    masked[:, 1000:] = -np.inf  # with the pad, chunk 8 is all -inf
    vj, ij = jfs._tile_lr_topk(jnp.asarray(masked), 40, 1100, 360)
    vt, it = tfs.tile_lr_topk(torch.from_numpy(masked), 40, 1100, 360)
    assert np.array_equal(np.asarray(vj), vt.numpy())
    assert np.array_equal(np.asarray(ij), it.numpy())


def test_streaming_and_multi_device_raise(data):
    """n_devices below one raises; two CPU shards give the one-shard
    top-k."""
    sd_t, w = data["torch"]
    with pytest.raises(ValueError, match="n_devices"):
        tfs.fast_lr_topk(sd_t, w, block=2048, n_devices=0, device="cpu")
    one = tfs.fast_lr_topk(sd_t, w, block=2048, topk=300, device="cpu")
    two = tfs.fast_lr_topk(sd_t, w, block=2048, topk=300, n_devices=2,
                           device="cpu")
    for a, b in zip(one, two):
        assert np.array_equal(a, b)
