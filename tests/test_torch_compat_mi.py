"""The port's compat tiles on the CPU: K3's plain version (`mi_tile_pallas`,
device="cpu") against the float64 oracle `mi_tile_numpy` and the JAX
package's Pallas kernel `mi_tile_pallas` (interpret mode, as
tests/test_pallas.py runs it), and the port's `mi_tile_jax` against the
JAX package's, on tests/test_pallas.py's small, multi-tile and
ragged-`rxy_compat` cases, at that file's bound (rtol 5e-5, atol 5e-6).

The kernel itself needs a card: `test_kernel_matches_plain_on_card` is
marked `cuda` and skips without one (chip_smoke.py holds the kernel
against the plain version and the oracle at the compat tile's shape)."""

import numpy as np
import pytest
import torch

from ldweaver_tpu.core import mi as jmi
from ldweaver_tpu.ops.pallas_mi import mi_tile_pallas as jax_pallas
from ldweaver_tpu_torch.core import mi as tmi
from ldweaver_tpu_torch.ops import compat_mi
from ldweaver_tpu_torch.parallel.fast_sweep import wparts

RTOL, ATOL = 5e-5, 5e-6


def make_case(seed, F, T, S, varied=False):
    """tests/test_pallas.py `_case`: ACGTN codes, the sites' uq gates and r.
    With `varied` each site draws from its own 2..5 alleles, so r varies
    and the compat RXY alias differs from the outer product."""
    rng = np.random.default_rng(seed)

    def codes(n):
        if not varied:
            return rng.integers(0, 5, (n, S)).astype(np.uint8)
        out = np.empty((n, S), np.uint8)
        for i in range(n):
            alleles = rng.permutation(5)[: rng.integers(2, 6)]
            out[i] = rng.choice(alleles, S)
        return out

    codes_f = codes(F)
    codes_t = codes(T)
    w = rng.uniform(0.1, 1.0, S)
    uq_f = np.stack([(codes_f == a).any(1) for a in range(5)], 1).astype(np.uint8)
    uq_t = np.stack([(codes_t == a).any(1) for a in range(5)], 1).astype(np.uint8)
    r_f = uq_f.sum(1).astype(np.int64)
    r_t = uq_t.sum(1).astype(np.int64)
    return codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, float(w.sum())


# (seed, F, T, S, rxy_compat, varied): test_pallas.py's three cases, and
# the ragged one again with varied r under both RXY forms
CASES = {
    "small": (3, 24, 16, 120, True, False),
    "multi_tile": (9, 150, 140, 300, True, False),
    "ragged_rxy_compat": (12, 60, 33, 64, True, False),
    "ragged_varied_r_rxy_compat": (13, 60, 33, 64, True, True),
    "ragged_varied_r_plain_rxy": (13, 60, 33, 64, False, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_oracle_and_pallas(name):
    seed, F, T, S, compat, varied = CASES[name]
    args = make_case(seed, F, T, S, varied)
    before = compat_mi.K3.launches
    got = compat_mi.mi_tile_pallas(*args, rxy_compat=compat, device="cpu")
    assert compat_mi.K3.launches == before  # CPU: the plain version
    oracle = tmi.mi_tile_numpy(*args, rxy_compat=compat)
    assert np.array_equal(oracle, jmi.mi_tile_numpy(*args, rxy_compat=compat))
    assert np.allclose(got, oracle, rtol=RTOL, atol=ATOL), np.abs(got - oracle).max()
    pal = jax_pallas(*args, rxy_compat=compat, tile_f=128, tile_t=128, chunk_s=128)
    assert np.allclose(got, pal, rtol=RTOL, atol=ATOL), np.abs(got - pal).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_mi_tile_jax_matches_jax_package(name):
    seed, F, T, S, compat, varied = CASES[name]
    args = make_case(seed, F, T, S, varied)
    got = tmi.mi_tile_jax(*args, rxy_compat=compat, device="cpu")
    ref = jmi.mi_tile_jax(*args, rxy_compat=compat)
    assert np.allclose(got, ref, rtol=RTOL, atol=ATOL), np.abs(got - ref).max()
    oracle = tmi.mi_tile_numpy(*args, rxy_compat=compat)
    assert np.allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_in_float64_is_the_exact_tile(name):
    """With dtype=torch.float64 the plain version is `mi_tile_numpy` of the
    same inputs (the weights its three bf16 terms sum to, their f64
    marginals, the f64 RXY tile) up to f64 rounding: the reference
    chip_smoke.py holds the kernel against."""
    seed, F, T, S, compat, varied = CASES[name]
    codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, _ = make_case(seed, F, T, S, varied)
    args = list(compat_mi.tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t,
                                      float(w.sum()), compat, device="cpu"))
    w_eff = args[5].double().sum(0).numpy()
    for i, c in ((6, codes_f), (7, codes_t)):
        args[i] = torch.from_numpy(np.stack([((c == a) * w_eff).sum(1) for a in range(5)]))
    args[12] = float(w_eff.sum())
    args[13] = torch.from_numpy(np.asarray(tmi.rxy_term(r_f, r_t, compat=compat), np.float64))
    got = compat_mi.compat_mi_tile_reference(*args, dtype=torch.float64)
    assert got.dtype == torch.float64
    oracle = tmi.mi_tile_numpy(codes_f, codes_t, w_eff, r_f, r_t, uq_f, uq_t,
                               float(w_eff.sum()), rxy_compat=compat)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-10)


def test_rxy_alias_wraps_column_major():
    """On a ragged tile the compat RXY is the column-major alias, not the
    outer product, and the tile depends on it."""
    args = make_case(13, 60, 33, 64, varied=True)
    r_f, r_t = args[3], args[4]
    alias = tmi.rxy_term(r_f, r_t, compat=True)
    assert not np.array_equal(alias, 0.25 * np.outer(r_f, r_t))
    a = compat_mi.mi_tile_pallas(*args, rxy_compat=True, device="cpu")
    b = compat_mi.mi_tile_pallas(*args, rxy_compat=False, device="cpu")
    assert np.abs(a - b).max() > 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    seed, F, T, S, compat, varied = CASES[name]
    args = make_case(seed, F, T, S, varied)
    before = compat_mi.K3.launches
    got = compat_mi.mi_tile_pallas(*args, rxy_compat=compat, device=cuda_device)
    torch.cuda.synchronize()
    assert compat_mi.K3.launches == before + 1
    plain = compat_mi.mi_tile_pallas_reference(*args, rxy_compat=compat,
                                               device=cuda_device)
    assert np.abs(got - plain).max() <= 2e-5
    oracle = tmi.mi_tile_numpy(*args, rxy_compat=compat)
    assert np.allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_padded_tile_inputs_give_the_same_plain_tile(name):
    """`tile_inputs` starts the column SNPs and ends the rows on multiples
    of 16 columns; the plain version's tile is bit for bit the one of the
    unpadded [S, F + T] code tensor with the columns at F."""
    seed, F, T, S, compat, varied = CASES[name]
    codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, neff = make_case(seed, F, T, S, varied)
    args = list(compat_mi.tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t,
                                      neff, compat, device="cpu"))
    codes, ts = args[0], args[2]
    assert ts % 16 == 0 and codes.shape[1] % 16 == 0 and ts >= F
    padded = compat_mi.compat_mi_tile_reference(*args)
    args[0] = torch.from_numpy(np.ascontiguousarray(
        np.concatenate([codes_f.T, codes_t.T], axis=1)))
    args[2] = F
    assert torch.equal(padded, compat_mi.compat_mi_tile_reference(*args))


# (nf, nt, S) as tests/test_torch_rank_mi.py: one mma fragment, single rows
# / columns, ragged edges of the 32 x 32 block tile; S below one 64-genome
# chunk, past whole chunks, and off the 8-genome copy width
EDGE_SHAPES = [(16, 16, 16), (1, 129, 200), (129, 1, 15), (17, 40, 616),
               (40, 17, 1), (129, 129, 616)]
ATOL_EXACT = 2e-5  # chip_smoke.py's bound for K3 against the f64 plain


def edge_args(device, seed, nf, nt, S, aligned, rxy_compat):
    """Kernel arguments on `device`: ACGTN codes (each site drawing from
    its own 1..5 of them, N included) for rows at column fs and columns at
    ts of a sequence-major code tensor whose other columns hold stray
    codes 0..4.  Aligned: fs, ts and the row length multiples of 16; else
    odd offsets."""
    rng = np.random.default_rng(seed)

    def side(n):
        out = np.empty((S, n), np.uint8)
        for i in range(n):
            alleles = rng.permutation(5)[: rng.integers(1, 6)]
            out[:, i] = rng.choice(alleles, S)
        uq = np.stack([(out == a).any(0) for a in range(5)])
        return out, uq.astype(np.float32), uq.sum(0)

    cf, uq_f, r_f = side(nf)
    ct, uq_t, r_t = side(nt)
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
    _, parts = wparts(w)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return (
        torch.from_numpy(codes).to(device), fs, ts, nf, nt, parts.to(device),
        t([((cf == a) * w[:, None]).sum(0) for a in range(5)]),
        t([((ct == a) * w[:, None]).sum(0) for a in range(5)]),
        t(r_f), t(r_t), t(uq_f), t(uq_t), float(np.float32(w.sum())),
        t(tmi.rxy_term(r_f, r_t, compat=rxy_compat)),
    )


def check_against_exact(args):
    got = compat_mi.compat_mi_tile(*args)
    if got.is_cuda:
        torch.cuda.synchronize()
    exact = compat_mi.compat_mi_tile_reference(*args, dtype=torch.float64)
    assert got.shape == exact.shape and bool(torch.isfinite(got).all())
    err = float((got.double() - exact).abs().max())
    assert err <= ATOL_EXACT, err


@pytest.mark.parametrize("rxy_compat", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
def test_edge_shapes_take_the_plain_version_on_cpu(nf, nt, S, aligned, rxy_compat):
    """The card tests' inputs on the CPU, where the wrapper runs the plain
    version: offsets, stray columns, N codes and tiny S leave it within
    ATOL_EXACT of the exact tile."""
    before = compat_mi.K3.launches
    check_against_exact(edge_args("cpu", nf + nt + S, nf, nt, S, aligned, rxy_compat))
    assert compat_mi.K3.launches == before


@pytest.mark.cuda
def test_kernel_fragment_layout_on_card(cuda_device):
    """The smallest tile: one 16 x 16 mma tile of all 16 planes over 16
    genomes, the first thing to hold on a new card."""
    check_against_exact(edge_args(cuda_device, 0, 16, 16, 16, True, True))


@pytest.mark.cuda
@pytest.mark.parametrize("rxy_compat", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
def test_kernel_edge_shapes_on_card(cuda_device, nf, nt, S, aligned, rxy_compat):
    before = compat_mi.K3.launches
    check_against_exact(
        edge_args(cuda_device, nf + nt + S, nf, nt, S, aligned, rxy_compat))
    assert compat_mi.K3.launches == before + 1
