"""The weight-term count (`precision_terms` of the sweeps, `n_terms` of the
kernels) in the port against the JAX package, at t = 1, 2 and 4 (t = 3,
the default, is what the other test files run).

The kernels count over the first t bf16 terms of the f32 weights, while
the marginals and neff stay exact sums of the weights, so at t = 1 the
closure cells carry the bf16 rounding of the weights: both packages do the
same, and each case is held against the JAX package at the same t.  Past
three terms the split's later terms are zero (three bf16 terms hold an
f32), so the port sums the first three after checking that.

On the CPU every wrapper takes its plain version; the cases marked `cuda`
hold the kernels against their plain versions at t = 1 and 2 and skip
without a card (chip_smoke.py's `terms` phase does the same at the main
path's shapes)."""

import contextlib

import numpy as np
import pytest
import torch

from ldweaver_tpu.core.mi import mi_tile_numpy
from ldweaver_tpu.parallel import fast_sweep as jfs
from ldweaver_tpu_torch.core.snp_tensor import SnpData
from ldweaver_tpu_torch.ops import compat_mi, fused_tile, rank_mi
from ldweaver_tpu_torch.parallel import fast_sweep as tfs
from test_torch_compat_mi import make_case as compat_case
from test_torch_fused_tile import make_case as fused_case
from test_torch_fused_tile import port_args as fused_args
from test_torch_lr_sweep import assert_topk_agree, snp_data
from test_torch_rank_mi import make_tile_case

TERMS = [1, 2, 4]
RTOL, ATOL = 2e-4, 2e-5  # the rank tile (tests/test_fast_sweep.py:260)
RTOL_K2, ATOL_K2 = 1e-4, 1e-5  # tests/test_torch_fused_tile.py
RTOL_K3, ATOL_K3 = 5e-5, 5e-6  # tests/test_torch_compat_mi.py
G, SR = 2_200_000, 20000


def uq_of(r):
    return (np.arange(5)[None, :] < r[:, None]).astype(np.uint8)


@pytest.mark.parametrize("t", TERMS)
@pytest.mark.parametrize("R", [2, 3])
def test_rank_tile_matches_jax_at_t_terms(R, t):
    """K1's plain version, through `mi_tile_rank_pallas(n_terms=t)` and
    `mi_tile_rank(precision_terms=t)`, against the JAX package's Pallas
    kernel (interpret mode, tile 128) and its XLA tile at the same t."""
    from ldweaver_tpu.ops.pallas_rank_mi import mi_tile_rank_pallas as jax_pallas

    codes_f, codes_t, w, r_f, r_t = make_tile_case(7 * R + t, 70, 60, 150, R, R)
    neff = float(w.sum())
    before = rank_mi.K1.launches
    got = rank_mi.mi_tile_rank_pallas(codes_f, codes_t, w, r_f, r_t, neff,
                                      n_terms=t, device="cpu")
    assert rank_mi.K1.launches == before  # CPU: the plain version
    pal = jax_pallas(codes_f, codes_t, w, r_f, r_t, neff, n_terms=t,
                     tile_f=128, tile_t=128, chunk_s=128)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    xla = jfs.mi_tile_rank(codes_f, codes_t, w, r_f, r_t, neff,
                           precision_terms=t)
    port = tfs.mi_tile_rank(codes_f, codes_t, w, r_f, r_t, neff,
                            precision_terms=t, device="cpu")
    assert port.dtype == np.float64 and port.shape == (70, 60)
    np.testing.assert_allclose(port, xla, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", TERMS)
def test_term_count_changes_the_tile_below_three(t):
    """The count changes the tile below three terms; from three terms on
    the tile is the three-term one, which holds the f64 oracle's bound."""
    codes_f, codes_t, w, r_f, r_t = make_tile_case(5, 40, 36, 200, 2, 3)
    neff = float(w.sum())
    three = rank_mi.mi_tile_rank_pallas(codes_f, codes_t, w, r_f, r_t, neff,
                                        device="cpu")
    got = rank_mi.mi_tile_rank_pallas(codes_f, codes_t, w, r_f, r_t, neff,
                                      n_terms=t, device="cpu")
    if t >= 3:
        assert np.array_equal(got, three)
    else:
        assert not np.array_equal(got, three)
    oracle = mi_tile_numpy(codes_f, codes_t, w, r_f, r_t, uq_of(r_f), uq_of(r_t),
                           neff, rxy_compat=False)
    assert np.allclose(three, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", TERMS)
@pytest.mark.parametrize("Rf,Rt,pure", [(2, 3, False), (3, 3, True)])
def test_plain_rank_tile_in_float64_is_the_exact_tile(Rf, Rt, pure, t):
    """With dtype=torch.float64 K1's plain version over t terms is the f64
    oracle of the weights those t terms sum to."""
    codes_f, codes_t, w, r_f, r_t = make_tile_case(Rf + t, 40, 36, 200, Rf, Rt, pure)
    parts = tfs.split_terms(w, t)
    w_eff = parts.double().sum(0).numpy()
    codes, ts = rank_mi.pair_codes(codes_f, codes_t, "cpu")

    def marg(c, R):
        return torch.from_numpy(np.stack([((c == x) * w_eff).sum(1) for x in range(R)]))

    got = rank_mi.rank_mi_tile_reference(
        codes, 0, ts, 40, 36, parts, marg(codes_f, Rf), marg(codes_t, Rt),
        torch.tensor(r_f, dtype=torch.float64), torch.tensor(r_t, dtype=torch.float64),
        float(w_eff.sum()), Rf, Rt, pure, dtype=torch.float64,
    )
    oracle = mi_tile_numpy(codes_f, codes_t, w_eff, r_f, r_t, uq_of(r_f),
                           uq_of(r_t), float(w_eff.sum()), rxy_compat=False)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-10)


@pytest.mark.parametrize("t", TERMS)
def test_fused_tile_matches_jax_at_t_terms(t):
    """K2's plain version over the first t terms against the JAX package's
    `fused_tile_stage1(n_terms=t)` in interpret mode: the same -inf chunks,
    values within tests/test_torch_fused_tile.py's bound, columns equal
    except at near-ties."""
    import jax.numpy as jnp

    from ldweaver_tpu.ops.pallas_fused_tile import fused_tile_stage1 as jax_fused

    c = fused_case(False, B=512, S=512, seed=40 + t)
    jv, jc = jax_fused(
        jnp.asarray(c["codes_f"].T), jnp.asarray(c["codes_t"].T),
        jnp.asarray(np.ascontiguousarray(jfs._wparts(c["w"], t)[1].T)),
        jnp.asarray(c["px"]), jnp.asarray(c["py"]),
        jnp.asarray(c["pos_f"]), jnp.asarray(c["pos_t"]),
        jnp.asarray(c["val_f"]), jnp.asarray(c["val_t"]),
        jnp.asarray(c["neff"]), 0, g=G, sr_dist=SR, n_terms=t,
        tile_f=256, chunk_s=512, section=512, interpret=True,
    )
    jv, jc = np.asarray(jv), np.asarray(jc)
    c["wparts"] = tfs.split_terms(c["w"], t)
    args = fused_args(c, False)
    tv, tc = (a.numpy() for a in fused_tile.fused_tile_stage1(*args, g=G, sr_dist=SR))
    assert (np.isneginf(jv) == np.isneginf(tv)).all()
    both = np.isfinite(jv)
    assert both.any() and (~both).any()
    np.testing.assert_allclose(tv[both], jv[both], rtol=RTOL_K2, atol=ATOL_K2)
    mism = both & (tc != jc)
    if mism.any():
        two = torch.full((c["B"],), 2.0)
        mi = rank_mi.rank_mi_tile_reference(*args[:8], two, two, args[12], 2, 2,
                                            True).numpy()
        rows = np.nonzero(mism)[0]
        assert np.allclose(mi[rows, jc[mism]], mi[rows, tc[mism]],
                           rtol=RTOL_K2, atol=ATOL_K2)


@pytest.mark.parametrize("t", TERMS)
@pytest.mark.parametrize("name", ["multi_tile", "ragged_varied_r_rxy_compat"])
def test_compat_tile_matches_jax_at_t_terms(name, t):
    """K3's plain version through `mi_tile_pallas(n_terms=t)` against the
    JAX package's (interpret mode) at the same t, and `device_get=False`
    returning the f32 tile."""
    from ldweaver_tpu.ops.pallas_mi import mi_tile_pallas as jax_pallas
    from test_torch_compat_mi import CASES

    seed, F, T, S, compat, varied = CASES[name]
    args = compat_case(seed, F, T, S, varied)
    got = compat_mi.mi_tile_pallas(*args, rxy_compat=compat, n_terms=t,
                                   device="cpu")
    pal = jax_pallas(*args, rxy_compat=compat, n_terms=t, tile_f=128,
                     tile_t=128, chunk_s=128)
    assert np.allclose(got, pal, rtol=RTOL_K3, atol=ATOL_K3), np.abs(got - pal).max()
    raw = compat_mi.mi_tile_pallas(*args, rxy_compat=compat, n_terms=t,
                                   device_get=False, device="cpu")
    assert isinstance(raw, torch.Tensor) and raw.dtype == torch.float32
    assert np.array_equal(raw.numpy().astype(np.float64), got)


@pytest.mark.parametrize("t", TERMS)
def test_plain_compat_tile_in_float64_is_the_exact_tile(t):
    """K3's plain version in float64 over t terms is `mi_tile_numpy` of the
    weights those t terms sum to."""
    codes_f, codes_t, w, r_f, r_t, uq_f, uq_t, _ = compat_case(13, 60, 33, 64, True)
    args = list(compat_mi.tile_inputs(codes_f, codes_t, w, r_f, r_t, uq_f, uq_t,
                                      float(w.sum()), True, t, device="cpu"))
    assert len(args[5]) == min(t, 3)
    w_eff = args[5].double().sum(0).numpy()
    for i, c in ((6, codes_f), (7, codes_t)):
        args[i] = torch.from_numpy(np.stack([((c == a) * w_eff).sum(1) for a in range(5)]))
    args[12] = float(w_eff.sum())
    args[13] = torch.from_numpy(np.asarray(
        compat_mi.rxy_term(r_f, r_t, compat=True), np.float64))
    got = compat_mi.compat_mi_tile_reference(*args, dtype=torch.float64)
    oracle = mi_tile_numpy(codes_f, codes_t, w_eff, r_f, r_t, uq_f, uq_t,
                           float(w_eff.sum()), rxy_compat=True)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def lr_data():
    from ldweaver_tpu.core.snp_tensor import SnpData as JaxSnpData

    return {pkg: snp_data(cls, 8192, 64)
            for pkg, cls in (("jax", JaxSnpData), ("torch", SnpData))}


@contextlib.contextmanager
def bf16_dot_in_f32():
    """XLA:CPU has no bf16 x bf16 -> f32 dot thunk, which the JAX package's
    one-term sweep reaches (with two or more terms the concatenated
    operands take another path).  bf16 values are exact in f32, so the
    same dot on f32 operands with f32 accumulation computes the same
    counts; this runs the JAX sweep's one-term program on the CPU."""
    import jax
    import jax.numpy as jnp

    dot = jax.lax.dot

    def f32_dot(a, b, *args, **kw):
        if a.dtype == jnp.bfloat16 and b.dtype == jnp.bfloat16:
            a, b = a.astype(jnp.float32), b.astype(jnp.float32)
        return dot(a, b, *args, **kw)

    jax.lax.dot = f32_dot
    try:
        yield
    finally:
        jax.lax.dot = dot


@pytest.mark.parametrize("t,n_devices", [(1, 1), (2, 1), (4, 1), (1, 2)])
def test_fast_lr_topk_matches_jax_at_t_terms(lr_data, t, n_devices):
    """The LR-only sweep at precision_terms=t (K2's and K1's plain versions
    over t terms) against the JAX package's at the same t, on
    tests/test_torch_lr_sweep.py's input, on one shard and on two.  At
    t = 4 the JAX sweep raises (its state holds three terms, and its tile
    concatenates four copies of the one-hot against them), so the port's
    four-term sweep is held against the JAX three-term one it equals."""
    sd_j, w = lr_data["jax"]
    sd_t, _ = lr_data["torch"]
    with bf16_dot_in_f32() if t == 1 else contextlib.nullcontext():
        ref = jfs.fast_lr_topk(sd_j, w, block=2048, sr_dist=SR, topk=1024,
                               n_devices=1, precision_terms=min(t, 3))
    got = tfs.fast_lr_topk(sd_t, w, block=2048, sr_dist=SR, topk=1024,
                           n_devices=n_devices, precision_terms=t, device="cpu")
    assert_topk_agree(ref, got)


def test_fast_lr_topk_terms_change_the_result(lr_data):
    """One state sweeps at any count: one term moves the MI values off the
    three-term ones, four terms give the three-term result exactly."""
    sd_t, w = lr_data["torch"]
    state = tfs.prepare_fast_sweep(sd_t, w, block=2048, device="cpu")
    assert tfs.uses_fused_tile((2, 2, True), 2048) and (2, 2, True) in state.buckets
    kw = dict(sr_dist=SR, topk=256, state=state)
    three = tfs.fast_lr_topk(**kw)
    four = tfs.fast_lr_topk(precision_terms=4, **kw)
    one = tfs.fast_lr_topk(precision_terms=1, **kw)
    for a, b in zip(three, four):
        assert np.array_equal(a, b)
    assert np.abs(one[2] - three[2]).max() > 1e-7


def test_term_counts_below_one_raise():
    codes_f, codes_t, w, r_f, r_t = make_tile_case(1, 20, 20, 64, 2, 2)
    neff = float(w.sum())
    with pytest.raises(ValueError, match="at least 1"):
        rank_mi.mi_tile_rank_pallas(codes_f, codes_t, w, r_f, r_t, neff,
                                    n_terms=0, device="cpu")
    with pytest.raises(ValueError, match="at least 1"):
        tfs.mi_tile_rank(codes_f, codes_t, w, r_f, r_t, neff,
                         precision_terms=0, device="cpu")
    cargs = compat_case(3, 24, 16, 120)
    with pytest.raises(ValueError, match="at least 1"):
        compat_mi.mi_tile_pallas(*cargs, n_terms=0, device="cpu")
    sd, lw = snp_data(SnpData, 1024, 16)
    with pytest.raises(ValueError, match="at least 1"):
        tfs.fast_lr_topk(sd, lw, block=512, precision_terms=0, device="cpu")


@pytest.mark.parametrize("rows", [0, 4])
def test_kernel_wrappers_take_one_to_three_terms(rows):
    """The tensor wrappers take wparts of 1 to 3 rows on every device; the
    host-facing functions cut longer splits to three first."""
    c = fused_case(False, B=256, S=64)
    c["wparts"] = torch.zeros((rows, 64), dtype=torch.bfloat16)
    args = fused_args(c, False)
    with pytest.raises(ValueError, match="1 to 3 weight terms"):
        fused_tile.fused_tile_stage1(*args, g=G, sr_dist=SR)
    two = torch.full((256,), 2.0)
    with pytest.raises(ValueError, match="1 to 3 weight terms"):
        rank_mi.rank_mi_tile(*args[:8], two, two, args[12], 2, 2, True)


def test_terms_past_three_are_zero_and_checked(monkeypatch):
    """Past three terms the split is zero in both packages, down to f32
    subnormals below bf16's least (they never enter any term), so four or
    five terms give the three-term split; a split whose fourth term were
    not zero would raise rather than be cut."""
    rng = np.random.default_rng(3)
    w = np.concatenate([rng.uniform(0.0, 1.0, 1001),
                        [1e-30, 1e-38, 1.4e-45, 3e38, 0.0]])
    assert not np.asarray(jfs._wparts(w, 5)[1][3:], np.float32).any()
    assert torch.equal(tfs.split_terms(w, 5), tfs.wparts(w, 3)[1])
    split = tfs.wparts

    def with_fourth_term(w, terms):
        w32, parts = split(w, terms)
        parts[3:, 0] = 1.0
        return w32, parts

    monkeypatch.setattr(tfs, "wparts", with_fourth_term)
    with pytest.raises(ValueError, match="past the third"):
        tfs.split_terms(w, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("Rf,Rt,pure", [(2, 2, True), (2, 3, False), (3, 3, True),
                                        (5, 5, False)])
def test_rank_kernel_matches_plain_on_card(cuda_device, Rf, Rt, pure, t):
    from test_torch_rank_mi import check_against_exact, edge_args

    args = list(edge_args(cuda_device, 11 * t + Rf, 129, 129, 616, Rf, Rt, pure, True))
    args[5] = args[5][:t]
    before = rank_mi.K1.launches
    check_against_exact(args)
    assert rank_mi.K1.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2])
def test_fused_kernel_matches_plain_on_card(cuda_device, t):
    from test_torch_fused_tile import check_against_exact, edge_args

    args, masked_row = edge_args(cuda_device, 5 + t, 129, 256, 616, False, True)
    args = list(args)
    args[5] = args[5][:t]
    before = fused_tile.K2.launches
    check_against_exact(args, masked_row)
    assert fused_tile.K2.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("name", ["multi_tile", "ragged_varied_r_rxy_compat"])
def test_compat_kernel_matches_plain_on_card(cuda_device, name, t):
    from test_torch_compat_mi import CASES

    seed, F, T, S, compat, varied = CASES[name]
    args = compat_case(seed, F, T, S, varied)
    before = compat_mi.K3.launches
    got = compat_mi.mi_tile_pallas(*args, rxy_compat=compat, n_terms=t,
                                   device=cuda_device)
    assert compat_mi.K3.launches == before + 1
    plain = compat_mi.mi_tile_pallas_reference(*args, rxy_compat=compat, n_terms=t,
                                               device=cuda_device)
    assert np.abs(got - plain).max() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2])
def test_fast_lr_topk_card_matches_cpu(cuda_device, lr_data, t):
    sd_t, w = lr_data["torch"]
    cpu = tfs.fast_lr_topk(sd_t, w, block=2048, sr_dist=SR, topk=1024,
                           precision_terms=t, device="cpu")
    card = tfs.fast_lr_topk(sd_t, w, block=2048, sr_dist=SR, topk=1024,
                            precision_terms=t, device=cuda_device)
    assert_topk_agree(cpu, card)
