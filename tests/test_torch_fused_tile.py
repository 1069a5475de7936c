"""K2's plain version (the port's fused LR stage-1 tile on the CPU) against
the JAX package's Pallas kernel `fused_tile_stage1` in interpret mode, on
the cases of tests/test_pallas_fused.py: B = 1024 SNPs, S = 512 genomes,
same-block and cross-block, pad sites on both sides.

Candidate values within rtol 1e-4, atol 1e-5 (the bound that file holds
the Pallas kernel to against the XLA scan body), the same all -inf chunks,
and chosen columns equal except at near-ties of the tile (values within
the same bound).  The kernel itself needs a card:
`test_kernel_matches_plain_on_card` is marked `cuda` and skips without
one (chip_smoke.py holds the kernel against the plain version at the
sweep's shape)."""

import numpy as np
import pytest
import torch

from ldweaver_tpu.ops.pallas_fused_tile import fused_tile_stage1 as jax_fused
from ldweaver_tpu.parallel.fast_sweep import _wparts
from ldweaver_tpu_torch.ops import fused_tile
from ldweaver_tpu_torch.ops.rank_mi import rank_mi_tile_reference
from ldweaver_tpu_torch.parallel import fast_sweep as tfs

G = 2_200_000
SR = 20000
RTOL, ATOL = 1e-4, 1e-5


def make_case(same, B=1024, S=512, seed=17):
    """tests/test_pallas_fused.py's case, with the port's sequence-major
    code tensor (rows' SNPs, then the columns' SNPs unless same)."""
    rng = np.random.default_rng(seed + same)
    codes_f = rng.integers(0, 2, (B, S)).astype(np.uint8)
    codes_t = codes_f if same else rng.integers(0, 2, (B, S)).astype(np.uint8)
    val_f = np.ones(B, bool)
    val_t = np.ones(B, bool)
    val_f[-7:] = False
    val_t[-3:] = False
    w = rng.uniform(0.05, 0.5, S)
    w32, wparts = tfs.wparts(w)  # bit-equal to the JAX package's _wparts
    w32 = w32.numpy()
    neff = np.float32(w32.sum())
    pos_f = np.sort(rng.choice(np.arange(1, G + 1), B, replace=False)).astype(np.int32)
    pos_t = pos_f if same else np.sort(
        rng.choice(np.arange(1, G + 1), B, replace=False)
    ).astype(np.int32)
    px = np.stack([((codes_f == x) * w32).sum(1).astype(np.float32) for x in range(2)])
    py = np.stack([((codes_t == y) * w32).sum(1).astype(np.float32) for y in range(2)])
    seq_major = codes_f.T if same else np.concatenate([codes_f.T, codes_t.T], axis=1)
    return dict(
        codes_f=codes_f, codes_t=codes_t, w=w, wparts=wparts, px=px, py=py,
        pos_f=pos_f, pos_t=pos_t, val_f=val_f, val_t=val_t, neff=neff,
        seq_major=np.ascontiguousarray(seq_major), B=B,
    )


def port_args(c, same, device="cpu"):
    B = c["B"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (
        t(c["seq_major"]), 0, 0 if same else B, B, B,
        c["wparts"].to(device), t(c["px"]),
        t(c["py"]), t(c["pos_f"]), t(c["pos_t"]), t(c["val_f"]),
        t(c["val_t"]), float(c["neff"]), same,
    )


def plain_tile(c, same):
    """The port's plain (2, 2, pure) MI tile, for judging near-ties."""
    args = port_args(c, same)
    two = torch.full((c["B"],), 2.0)
    return rank_mi_tile_reference(
        *args[:8], two, two, args[12], 2, 2, True
    ).numpy()


@pytest.mark.parametrize("same", [False, True])
def test_plain_version_matches_pallas_interpret(same):
    import jax.numpy as jnp

    c = make_case(same)
    jv, jc = jax_fused(
        jnp.asarray(c["codes_f"].T), jnp.asarray(c["codes_t"].T),
        jnp.asarray(np.ascontiguousarray(_wparts(c["w"])[1].T)),
        jnp.asarray(c["px"]), jnp.asarray(c["py"]),
        jnp.asarray(c["pos_f"]), jnp.asarray(c["pos_t"]),
        jnp.asarray(c["val_f"]), jnp.asarray(c["val_t"]),
        jnp.asarray(c["neff"]), int(same),
        g=G, sr_dist=SR, tile_f=256, chunk_s=512, section=512, interpret=True,
    )
    jv, jc = np.asarray(jv), np.asarray(jc)
    before = fused_tile.K2.launches
    tv, tc = fused_tile.fused_tile_stage1(*port_args(c, same), g=G, sr_dist=SR)
    assert fused_tile.K2.launches == before  # a CPU tensor: plain version
    tv, tc = tv.numpy(), tc.numpy()
    assert tv.shape == jv.shape == (c["B"], c["B"] // 128)
    assert tc.dtype == np.int32
    both = np.isfinite(jv) & np.isfinite(tv)
    assert (np.isneginf(jv) == np.isneginf(tv)).all()
    assert (~both).any() and both.any()  # masked and live chunks both occur
    assert np.allclose(tv[both], jv[both], rtol=RTOL, atol=ATOL)
    assert (tc[~both] == jc[~both]).all()  # all -inf: the chunk's first column
    mism = both & (tc != jc)
    if mism.any():
        mi = plain_tile(c, same)
        rows = np.nonzero(mism)[0]
        assert np.allclose(mi[rows, jc[mism]], mi[rows, tc[mism]],
                           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("same", [False, True])
def test_plain_version_in_float64_is_the_exact_tile(same):
    """With dtype=torch.float64 the plain version's candidates are the chunk
    maxima of the masked f64 oracle tile of the same inputs (the weights its
    three bf16 terms sum to, their f64 marginals) up to f64 rounding: the
    reference chip_smoke.py holds the kernel against."""
    from ldweaver_tpu_torch.core.mi import mi_tile_numpy

    c = make_case(same, B=256, S=200)
    B = c["B"]
    w_eff = c["wparts"].double().sum(0).numpy()
    args = list(port_args(c, same))
    for i, codes in ((6, c["codes_f"]), (7, c["codes_t"])):
        args[i] = torch.from_numpy(np.stack([((codes == x) * w_eff).sum(1) for x in range(2)]))
    args[12] = float(w_eff.sum())
    tv, tc = fused_tile.fused_tile_stage1_reference(*args, g=G, sr_dist=SR,
                                                    dtype=torch.float64)
    assert tv.dtype == torch.float64
    two = np.full(B, 2)
    uq = np.zeros((B, 5), np.uint8)
    uq[:, :2] = 1
    oracle = torch.from_numpy(mi_tile_numpy(
        c["codes_f"], c["codes_t"], w_eff, two, two, uq, uq, float(w_eff.sum()),
        rxy_compat=False))
    _, lr_ok = tfs.tile_masks(*args[8:12], same, G, SR)
    ov, oc = fused_tile.chunk_max(torch.where(lr_ok, oracle, float("-inf")))
    fin = torch.isfinite(ov)
    assert (torch.isneginf(tv) == torch.isneginf(ov)).all() and fin.any()
    np.testing.assert_allclose(tv[fin].numpy(), ov[fin].numpy(), rtol=0, atol=1e-10)
    assert (tc == oc).all()


def test_chunk_max_takes_the_first_column():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, -np.inf, -np.inf, -np.inf, -np.inf]])
    vals, cols = fused_tile.chunk_max(x, chunk=4)
    assert vals.tolist() == [[3.0, -np.inf]]
    assert cols.tolist() == [[1, 4]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("same", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, same):
    c = make_case(same, S=616)
    args = port_args(c, same, cuda_device)
    before = fused_tile.K2.launches
    kv, kc = fused_tile.fused_tile_stage1(*args, g=G, sr_dist=SR)
    torch.cuda.synchronize()
    assert fused_tile.K2.launches == before + 1
    pv, pc = fused_tile.fused_tile_stage1_reference(*args, g=G, sr_dist=SR)
    kv, kc, pv, pc = (t.cpu().numpy() for t in (kv, kc, pv, pc))
    assert (np.isneginf(kv) == np.isneginf(pv)).all()
    fin = np.isfinite(pv)
    assert np.abs(kv[fin] - pv[fin]).max() <= 2e-5
    mism = kc != pc
    if mism.any():  # near-ties, judged on the plain tile
        tile = plain_tile(c, same)
        rows = np.nonzero(mism)[0]
        assert np.abs(tile[rows, kc[mism]] - tile[rows, pc[mism]]).max() <= 1e-5


# (nf, nt, S): one mma fragment of rows, a single row, ragged row blocks,
# several chunks; S below one 64-genome chunk, past whole chunks, and off
# the 8-genome copy width (S = 1, 15 take plain loads)
EDGE_SHAPES = [(16, 128, 16), (1, 128, 200), (129, 128, 15), (17, 256, 616),
               (128, 384, 1), (129, 128, 1024)]
ATOL_EXACT, NEAR_TIE = 2e-5, 1e-5  # chip_smoke.py's rule for K2


def edge_args(device, seed, nf, nt, S, same, aligned):
    """Kernel arguments on `device`: rows at column fs and columns at ts
    (ts = fs on a diagonal block pair) of a sequence-major code tensor
    whose other columns hold stray codes 0..4.  Aligned: fs, ts and the
    row length multiples of 16; else odd offsets.  Per-site positions and
    validity: pad sites at the ends of both sides, one invalid row
    (`masked_row`, so all its chunks are -inf), and in the first chunk
    column 2k + 1 a copy of column 2k (codes, position, validity), so every
    value there is tied with the column before it."""
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
    pos = np.sort(rng.choice(np.arange(1, G + 1), ld, replace=False)).astype(np.int32)
    valid = np.ones(ld, bool)
    for lo, n in ((fs, nf), (ts, nt)):
        maf = rng.uniform(0.02, 0.5, n)
        codes[:, lo : lo + n] = rng.random((S, n)) < maf[None, :]
        valid[lo + n - 1] = False
    masked_row = nf // 2
    valid[fs + masked_row] = False
    pair = np.arange(ts, ts + 128, 2)
    codes[:, pair + 1] = codes[:, pair]
    pos[pair + 1] = pos[pair]
    valid[pair + 1] = valid[pair]
    w = 1.0 / rng.integers(1, 12, S)
    codes = torch.from_numpy(codes).to(device)
    pos = torch.from_numpy(pos).to(device)
    valid = torch.from_numpy(valid).to(device)
    w32, parts = tfs.wparts(w)
    w32, parts = w32.to(device), parts.to(device)
    args = (
        codes, fs, ts, nf, nt, parts,
        tfs.rank_marginals(codes, fs, nf, w32, 2),
        tfs.rank_marginals(codes, ts, nt, w32, 2),
        pos[fs : fs + nf], pos[ts : ts + nt],
        valid[fs : fs + nf], valid[ts : ts + nt],
        float(np.float32(w.sum())), same,
    )
    return args, masked_row


def check_against_exact(args, masked_row):
    """The wrapper's candidates against the plain version in float64: the
    same -inf chunks, values within ATOL_EXACT, columns equal except at
    near-ties of the f64 tile; -inf chunks and exact ties report their
    first column."""
    codes, fs, ts, nf, nt, parts, px, py = args[:8]
    kv, kc = fused_tile.fused_tile_stage1(*args, g=G, sr_dist=SR)
    if kv.is_cuda:
        torch.cuda.synchronize()
    ev, ec = fused_tile.fused_tile_stage1_reference(*args, g=G, sr_dist=SR,
                                                    dtype=torch.float64)
    nch = nt // 128
    assert kv.shape == kc.shape == (nf, nch) and kc.dtype == torch.int32
    assert not bool(torch.isnan(kv).any())
    assert torch.equal(torch.isneginf(kv), torch.isneginf(ev))
    fin = torch.isfinite(ev)
    if fin.any():
        err = float((kv[fin].double() - ev[fin]).abs().max())
        assert err <= ATOL_EXACT, err
    first = (torch.arange(nch, device=kc.device) * 128).to(torch.int32)
    assert torch.equal(kc[masked_row], first)
    assert torch.equal(kc[~fin], first.expand(nf, nch)[~fin])
    assert bool((kc[:, 0] % 2 == 0).all())  # exact ties: the first column
    mism = kc != ec
    if mism.any():  # near-ties, judged on the exact tile
        two = torch.full((max(nf, nt),), 2.0, device=kc.device)
        tile = rank_mi_tile_reference(codes, fs, ts, nf, nt, parts, px, py,
                                      two[:nf], two[:nt], args[12], 2, 2, True,
                                      dtype=torch.float64)
        rows = torch.nonzero(mism)[:, 0]
        gap = float((tile[rows, kc[mism].long()] - tile[rows, ec[mism].long()]).abs().max())
        assert gap <= NEAR_TIE, gap


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
def test_edge_shapes_take_the_plain_version_on_cpu(nf, nt, S, aligned, same):
    """The card tests' inputs on the CPU, where the wrapper runs the plain
    version: offsets, stray columns, ties and tiny S leave it within
    ATOL_EXACT of the exact candidates."""
    before = fused_tile.K2.launches
    check_against_exact(*edge_args("cpu", nf + nt + S, nf, nt, S, same, aligned))
    assert fused_tile.K2.launches == before


@pytest.mark.cuda
def test_kernel_fragment_layout_on_card(cuda_device):
    """The smallest tile: 16 rows of one 128-column chunk over 16 genomes,
    the first thing to hold on a new card."""
    check_against_exact(*edge_args(cuda_device, 0, 16, 128, 16, False, True))


@pytest.mark.cuda
@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("nf,nt,S", EDGE_SHAPES)
def test_kernel_edge_shapes_on_card(cuda_device, nf, nt, S, aligned, same):
    before = fused_tile.K2.launches
    check_against_exact(*edge_args(cuda_device, nf + nt + S, nf, nt, S, same, aligned))
    assert fused_tile.K2.launches == before + 1
