"""The port's rank-compacted MI tile (K1's plain version on the CPU)
against the f64 oracle, the JAX package's XLA tile and its Pallas kernel
(interpret mode), plus the bit-exact host pieces: rank encoding,
stratification and the bf16 weight split.

The kernel itself needs a card: the tests marked `cuda` skip without one
(chip_smoke.py holds the kernel against the plain version at the main
path's shapes); they hold it against the plain version run in float64 at
the shapes most likely to break its mma fragments and its padding."""

import numpy as np
import pytest
import torch

from ldweaver_tpu.core.mi import mi_tile_numpy
from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu_torch.ops import rank_mi
from ldweaver_tpu_torch.parallel import fast_sweep as tfs

# the bound tests/test_fast_sweep.py:260 holds the JAX tile to
RTOL, ATOL = 2e-4, 2e-5


def make_tile_case(seed, F, T, S, Rf, Rt, pure=False):
    """Rank codes [F,S] / [T,S] with per-site r in 1..R (every rank below
    r present), or r == R everywhere when pure."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, S)

    def make(B, R):
        codes = np.zeros((B, S), np.uint8)
        r = np.zeros(B, np.int64)
        for i in range(B):
            ri = R if pure else int(rng.integers(1, R + 1))
            r[i] = ri
            codes[i] = rng.integers(0, ri, S)
            codes[i, :ri] = np.arange(ri)
        return codes, r

    codes_f, r_f = make(F, Rf)
    codes_t, r_t = make(T, Rt)
    if not pure:  # make the bucket's static R the block maximum
        r_f[0] = Rf
        codes_f[0, :Rf] = np.arange(Rf)
        r_t[0] = Rt
        codes_t[0, :Rt] = np.arange(Rt)
    return codes_f, codes_t, w, r_f, r_t


def port_tile(codes_f, codes_t, w, r_f, r_t, Rf, Rt, pure):
    """The port's tile on the CPU, from one sequence-major code tensor
    holding the rows' SNPs then the columns' SNPs."""
    codes = torch.from_numpy(
        np.ascontiguousarray(np.concatenate([codes_f.T, codes_t.T], axis=1))
    )
    w32, parts = tfs.wparts(w)
    F, T = codes_f.shape[0], codes_t.shape[0]
    out = tfs.rank_tile_mi(
        codes, 0, F, F, T, w32, parts,
        torch.tensor(r_f, dtype=torch.float32),
        torch.tensor(r_t, dtype=torch.float32),
        float(np.float32(w.sum())), Rf, Rt, pure,
    )
    return out.numpy().astype(np.float64)


def oracle_tile(codes_f, codes_t, w, r_f, r_t):
    uq_f = (np.arange(5)[None, :] < r_f[:, None]).astype(np.uint8)
    uq_t = (np.arange(5)[None, :] < r_t[:, None]).astype(np.uint8)
    return mi_tile_numpy(
        codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, float(w.sum()),
        rxy_compat=False,
    )


def jax_tile(codes_f, codes_t, w, r_f, r_t, Rf, Rt, pure):
    import jax.numpy as jnp

    w32, parts = jfs._wparts(w)
    fn = jfs._build_rank_tile(
        codes_f.shape[0], codes_t.shape[0], Rf, Rt, 3, pure=pure
    )
    return np.asarray(fn(
        jnp.asarray(codes_f), jnp.asarray(codes_t), jnp.asarray(w32),
        jnp.asarray(parts), jnp.asarray(r_f, jnp.float32),
        jnp.asarray(r_t, jnp.float32), jnp.asarray(np.float32(w.sum())),
    ), np.float64)


BUCKETS = [
    (1, 2, False), (2, 1, False), (2, 2, False), (3, 2, False),
    (3, 3, False), (2, 4, False), (5, 5, False), (2, 2, True), (3, 3, True),
]


@pytest.mark.parametrize("Rf,Rt,pure", BUCKETS)
def test_rank_tile_matches_oracle_and_jax(Rf, Rt, pure):
    case = make_tile_case(Rf * 10 + Rt + 100 * pure, 40, 36, 200, Rf, Rt, pure)
    got = port_tile(*case, Rf, Rt, pure)
    oracle = oracle_tile(*case)
    assert np.allclose(got, oracle, rtol=RTOL, atol=ATOL), (
        np.abs(got - oracle).max()
    )
    ref = jax_tile(*case, Rf, Rt, pure)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("Rf,Rt,pure", BUCKETS)
def test_plain_version_in_float64_is_the_exact_tile(Rf, Rt, pure):
    """With dtype=torch.float64 the plain version is the f64 oracle's tile
    of the same inputs (the weights its three bf16 terms sum to) up to f64
    rounding: the reference chip_smoke.py holds the kernel against."""
    codes_f, codes_t, w, r_f, r_t = make_tile_case(
        Rf * 10 + Rt + 100 * pure, 40, 36, 200, Rf, Rt, pure)
    codes = torch.from_numpy(
        np.ascontiguousarray(np.concatenate([codes_f.T, codes_t.T], axis=1))
    )
    _, parts = tfs.wparts(w)
    w_eff = parts.double().sum(0).numpy()
    F, T = codes_f.shape[0], codes_t.shape[0]

    def marginals(c, R):
        return torch.from_numpy(np.stack([((c == x) * w_eff).sum(1) for x in range(R)]))

    got = rank_mi.rank_mi_tile_reference(
        codes, 0, F, F, T, parts, marginals(codes_f, Rf), marginals(codes_t, Rt),
        torch.tensor(r_f, dtype=torch.float64), torch.tensor(r_t, dtype=torch.float64),
        float(w_eff.sum()), Rf, Rt, pure, dtype=torch.float64,
    )
    assert got.dtype == torch.float64
    oracle = oracle_tile(codes_f, codes_t, w_eff, r_f, r_t)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-10)


@pytest.mark.parametrize("R", [2, 3])
def test_rank_tile_matches_pallas_interpret(R):
    from ldweaver_tpu.ops.pallas_rank_mi import mi_tile_rank_pallas

    codes_f, codes_t, w, r_f, r_t = make_tile_case(7 * R, 70, 60, 150, R, R)
    got = port_tile(codes_f, codes_t, w, r_f, r_t, R, R, False)
    pal = mi_tile_rank_pallas(
        codes_f, codes_t, w, r_f, r_t, float(w.sum()),
        tile_f=128, tile_t=128, chunk_s=128,
    )
    np.testing.assert_allclose(got, pal, rtol=0, atol=ATOL)


@pytest.mark.parametrize("terms", [1, 2, 3, 4, 5])
def test_wparts_bit_equal(terms):
    rng = np.random.default_rng(1)
    w = np.concatenate([rng.uniform(0.0, 1.0, 997), [0.5, 1.0 / 3.0, 1e-8]])
    w32_j, parts_j = jfs._wparts(w, terms)
    w32_t, parts_t = tfs.wparts(w, terms)
    assert np.array_equal(w32_t.numpy().view(np.uint32), w32_j.view(np.uint32))
    assert parts_t.dtype == torch.bfloat16 and tuple(parts_t.shape) == (terms, w.size)
    assert np.array_equal(
        parts_t.view(torch.int16).numpy().view(np.uint16),
        np.asarray(parts_j).view(np.uint16),
    )


def test_rank_encode_and_stratify_equal():
    from tests.test_stream_sweep import _synth

    sd, _ = _synth(nsnp=900, nseq=40, seed=8)
    assert np.array_equal(
        tfs.rank_encode(sd.codes, sd.acgtn_table),
        jfs.rank_encode(sd.codes, sd.acgtn_table),
    )
    a = jfs.stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, 256)
    b = tfs.stratify(sd.codes, sd.acgtn_table, sd.pos, sd.r, 256)
    for f in ("rank_codes", "pos", "r", "perm", "block_rmax", "block_pure"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.block == b.block


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes the plain version and launches no
    kernel, whatever the bucket."""
    before = rank_mi.K1.launches
    case = make_tile_case(3, 20, 20, 64, 2, 2)
    port_tile(*case, 2, 2, False)
    assert rank_mi.K1.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Rf,Rt,pure", BUCKETS)
def test_kernel_matches_plain_on_card(cuda_device, Rf, Rt, pure):
    codes_f, codes_t, w, r_f, r_t = make_tile_case(5, 300, 260, 616, Rf, Rt, pure)
    codes = torch.from_numpy(
        np.ascontiguousarray(np.concatenate([codes_f.T, codes_t.T], axis=1))
    ).to(cuda_device)
    w32, parts = tfs.wparts(w)
    w32, parts = w32.to(cuda_device), parts.to(cuda_device)
    F, T = codes_f.shape[0], codes_t.shape[0]
    px = tfs.rank_marginals(codes, 0, F, w32, Rf)
    py = tfs.rank_marginals(codes, F, T, w32, Rt)
    args = (
        codes, 0, F, F, T, parts, px, py,
        torch.tensor(r_f, dtype=torch.float32, device=cuda_device),
        torch.tensor(r_t, dtype=torch.float32, device=cuda_device),
        float(np.float32(w.sum())), Rf, Rt, pure,
    )
    before = rank_mi.K1.launches
    got = rank_mi.rank_mi_tile(*args)
    torch.cuda.synchronize()
    assert rank_mi.K1.launches == before + 1
    plain = rank_mi.rank_mi_tile_reference(*args)
    assert torch.allclose(got, plain, rtol=0, atol=ATOL)


# every warp-tile geometry of the kernel (mma_planes::Planes) and the
# marginals-only buckets
CARD_BUCKETS = BUCKETS + [(2, 3, True), (4, 3, False), (3, 5, False),
                          (4, 4, False), (5, 2, False)]
# (nf, nt, S): one mma fragment, single rows / columns, ragged edges; S
# below one 64-genome chunk and past whole chunks, and off the 8-genome
# copy width (S = 1, 15 take plain loads)
EDGE_SHAPES = [(16, 16, 16), (1, 129, 200), (129, 1, 15), (17, 40, 616),
               (40, 17, 1), (129, 129, 616)]


def edge_args(device, seed, nf, nt, S, Rf, Rt, pure, aligned):
    """Kernel arguments on `device`: rows at column fs and columns at ts of
    a sequence-major code tensor whose other columns hold stray codes 0..4.
    Aligned: fs, ts and the row length multiples of 16; else odd offsets."""
    rng = np.random.default_rng(seed)

    def side(n, R):
        r = np.full(n, R) if pure else rng.integers(1, R + 1, n)
        r[0] = R
        return (rng.random((S, n)) * r[None, :]).astype(np.uint8), r

    cf, r_f = side(nf, Rf)
    ct, r_t = side(nt, Rt)
    if aligned:
        fs = 16
        ts = fs + 16 * (-(-nf // 16)) + 16
        ld = 16 * (-(-(ts + nt) // 16))
    else:
        fs, ts = 3, 3 + nf + 5
        ld = ts + nt + 1
    codes = rng.integers(0, 5, (S, ld)).astype(np.uint8)
    codes[:, fs : fs + nf] = cf
    codes[:, ts : ts + nt] = ct
    w = 1.0 / rng.integers(1, 12, S)
    codes = torch.from_numpy(codes).to(device)
    w32, parts = tfs.wparts(w)
    w32, parts = w32.to(device), parts.to(device)
    return (
        codes, fs, ts, nf, nt, parts,
        tfs.rank_marginals(codes, fs, nf, w32, Rf),
        tfs.rank_marginals(codes, ts, nt, w32, Rt),
        torch.tensor(r_f, dtype=torch.float32, device=device),
        torch.tensor(r_t, dtype=torch.float32, device=device),
        float(np.float32(w.sum())), Rf, Rt, pure,
    )


def check_against_exact(args):
    got = rank_mi.rank_mi_tile(*args)
    if got.is_cuda:
        torch.cuda.synchronize()
    exact = rank_mi.rank_mi_tile_reference(*args, dtype=torch.float64)
    assert got.shape == exact.shape and bool(torch.isfinite(got).all())
    err = float((got.double() - exact).abs().max())
    assert err <= ATOL, err


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
def test_edge_shapes_take_the_plain_version_on_cpu(nf, nt, S, aligned):
    """The card tests' inputs on the CPU, where the wrapper runs the plain
    version: offsets, stray columns and tiny S leave it within ATOL of the
    exact tile."""
    check_against_exact(edge_args("cpu", S, nf, nt, S, 3, 3, False, aligned))


@pytest.mark.cuda
def test_kernel_fragment_layout_on_card(cuda_device):
    """The smallest tile: one (2, 2) plane of one 16 x 16 mma tile over 16
    genomes, the first thing to hold on a new card."""
    check_against_exact(edge_args(cuda_device, 0, 16, 16, 16, 2, 2, False, True))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
@pytest.mark.parametrize("Rf,Rt,pure", CARD_BUCKETS)
def test_kernel_edge_shapes_on_card(cuda_device, Rf, Rt, pure, nf, nt, S,
                                    aligned):
    seed = Rf * 10 + Rt + 100 * pure + 1000 * nf + 7 * nt + S
    check_against_exact(
        edge_args(cuda_device, seed, nf, nt, S, Rf, Rt, pure, aligned))
