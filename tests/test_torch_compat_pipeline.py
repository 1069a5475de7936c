"""The compat backends of `perform_mi_computation` (contiguous `make_blocks`
tiling, the RXY alias, the dropped in-block-diagonal pairs), port against
JAX package on the CPU, on the bench.py pipeline-leg recipe (`synth`, a
random paint over 3 clusters) at 64 genomes x 2,048 SNPs, max_blk_sz=1000
(3 blocks, 6 tiles; the last block holds 48 SNPs, so 4 tiles are ragged).

  * "numpy": the float64 oracle tile in both packages -> byte-identical
    sr_links.tsv and lr_links.tsv.
  * "jax" (the port's f32 PyTorch tile) and "pallas" (K3's plain version
    on the CPU) against the JAX package's "jax", with
    tests/test_torch_pipeline.py's MI bound (1.2e-4) and the same top-10
    SR links, in the same order apart from neighbours whose srp differ by
    less than 0.1 in the reference.  Rows on one side only: LR at the
    reference's CPU-vs-TPU
    fringe rate; SR at most as many as the JAX package's own "numpy"
    (f64) and "jax" (f32) backends put on one side only on this input,
    each with srp within 0.1 of the cutoff.  On this random input 680 SR
    links crowd the cutoff, and the Nelder-Mead Beta fit of the
    background model turns MI differences of ~3e-7 into srp differences
    of up to 0.08 between those two JAX backends: 29 of 709 SR rows on
    one side only, srp 3.0008-3.0495 (observed on the CPU).  Observed,
    port "jax" against JAX "jax": 7 of 680 SR rows (srp 3.0009-3.0113),
    MI max abs diff 4.0e-7, 1 of 99,987 LR rows; SR ranks 8 and 9 swap
    (srp 7.0910 and 7.0904 in the JAX package).

ARACNE labels on the shared SR rows: the strict `<` of the DPI test
(core/aracne.py:147) turns f32 MI differences into flipped labels, and the
reference is itself that sensitive.  So the port's f32 backends must agree
with JAX "jax" at least as well as the JAX package's own "numpy" (f64)
agrees with its "jax" (f32) on the same input, less 0.005.  Observed on
the CPU on this input: JAX "numpy" vs JAX "jax" 1.0 (680 shared rows),
port "jax" 1.0 (673), port "pallas" 1.0 (671)."""

import os

import numpy as np
import pytest

from bench import synth
from tests.test_torch_pipeline import fringe_bound, read_lr, read_sr

G = 2_200_000
KW = dict(plt_folder=None, sr_dist=20000, lr_retain_links=1e5,
          max_blk_sz=1000, srp_cutoff=3.0, verbose=False)


def inputs(pkg):
    """SnpData + CdsVar of the package `pkg`, bench.py `leg_pipeline`."""
    if pkg == "jax":
        from ldweaver_tpu.core.cds import CdsVar, Clusters
        from ldweaver_tpu.core.snp_tensor import SnpData
    else:
        from ldweaver_tpu_torch.core.cds import CdsVar, Clusters
        from ldweaver_tpu_torch.core.snp_tensor import SnpData
    nsnp, nseq, nclust = 2048, 64, 3
    codes, pos, uqe, r, w = synth(nsnp, nseq, seed=1)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    sd = SnpData(codes=codes, pos=pos, g=G,
                 seq_names=[str(i) for i in range(nseq)], acgtn_table=acgtn,
                 uqe=uqe, r=r)
    rng = np.random.default_rng(2)
    cds_var = CdsVar(
        var_estimate=np.zeros(1), cds_start=np.zeros(1, np.int64),
        cds_end=np.zeros(1, np.int64), clusts=Clusters(np.array([1]), 0.0),
        paint=rng.integers(1, nclust + 1, size=nsnp).astype(np.int64),
        ref=np.array(["A"] * nsnp), alt=np.array([""] * nsnp),
        allele_table=acgtn, nclust=nclust,
    )
    return sd, w, cds_var


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import ldweaver_tpu.core.sweep as jsweep
    import ldweaver_tpu_torch.core.sweep as tsweep

    d = tmp_path_factory.mktemp("compat")
    out = {}
    for pkg, backend in (("jax", "numpy"), ("jax", "jax"), ("torch", "numpy"),
                         ("torch", "jax"), ("torch", "pallas")):
        sd, w, cds_var = inputs(pkg)
        run = d / f"{pkg}_{backend}"
        run.mkdir()
        extra = {} if pkg == "jax" else dict(device="cpu")
        mod = jsweep if pkg == "jax" else tsweep
        mod.perform_mi_computation(
            sd, w, cds_var, lr_save_path=str(run / "lr_links.tsv"),
            sr_save_path=str(run / "sr_links.tsv"), backend=backend, **KW,
            **extra,
        )
        out[pkg, backend] = str(run)
    return out


def test_numpy_backend_byte_identical(runs):
    for name in ("sr_links.tsv", "lr_links.tsv"):
        a = open(os.path.join(runs["jax", "numpy"], name), "rb").read()
        b = open(os.path.join(runs["torch", "numpy"], name), "rb").read()
        assert len(a) > 1000 and a == b, name


def aracne_agreement(ref_dset, dset):
    """Share of the SR rows two runs share whose ARACNE labels agree."""
    key_r, _, ar_r = read_sr(os.path.join(ref_dset, "sr_links.tsv"))
    key_d, _, ar_d = read_sr(os.path.join(dset, "sr_links.tsv"))
    lab = dict(zip(key_d, ar_d))
    shared = [(k, a) for k, a in zip(key_r, ar_r) if k in lab]
    return np.mean([a == lab[k] for k, a in shared])


def sr_srp(path):
    """{(pos1, pos2): srp} of an sr_links.tsv."""
    return {(r[1], r[2]): float(r[7])
            for r in (ln.split("\t") for ln in open(path))}


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_f32_backends_within_reference_fringe(runs, backend):
    ref, got = runs["jax", "jax"], runs["torch", backend]
    key_j, mi_j, _ = read_sr(os.path.join(ref, "sr_links.tsv"))
    key_t, mi_t, _ = read_sr(os.path.join(got, "sr_links.tsv"))
    assert len(key_j) > 100
    own = sr_srp(os.path.join(runs["jax", "numpy"], "sr_links.tsv"))
    spread = len(set(own) ^ set(key_j))  # the JAX package's f64 vs f32
    one_side = set(key_j) ^ set(key_t)
    assert len(one_side) <= max(fringe_bound(len(key_j)), spread)
    srp = {**sr_srp(os.path.join(got, "sr_links.tsv")),
           **sr_srp(os.path.join(ref, "sr_links.tsv"))}  # the reference's first
    assert all(srp[k] - 3.0 <= 0.1 for k in one_side)
    idx_t = {k: i for i, k in enumerate(key_t)}
    shared = [(i, idx_t[k]) for i, k in enumerate(key_j) if k in idx_t]
    assert max(abs(mi_j[i] - mi_t[j]) for i, j in shared) <= 1.2e-4
    assert set(key_j[:10]) == set(key_t[:10])
    for a, b in zip(key_j[:10], key_t[:10]):
        assert a == b or abs(srp[a] - srp[b]) < 0.1, (a, b)
    own_agree = aracne_agreement(ref, runs["jax", "numpy"])
    assert aracne_agreement(ref, got) >= own_agree - 0.005
    lr_j = read_lr(os.path.join(ref, "lr_links.tsv"))
    lr_t = read_lr(os.path.join(got, "lr_links.tsv"))
    assert len(lr_j) > 10000
    assert len(set(lr_j) ^ set(lr_t)) <= fringe_bound(len(lr_j))
    common = set(lr_j) & set(lr_t)
    assert max(abs(lr_j[k] - lr_t[k]) for k in common) <= 1.2e-4
