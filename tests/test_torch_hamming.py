"""BLK4 in the port (one-hot products on the r-stratified rank codes, on
the CPU) against the NumPy oracle and the JAX package's device path on
the 8-device virtual CPU mesh: the Hamming weights must be bit-equal."""

import numpy as np
import pytest

from ldweaver_tpu.core.hamming import hamming_weights_numpy as jax_pkg_numpy
from ldweaver_tpu.core.snp_tensor import SnpData
from ldweaver_tpu.parallel.spmd_sweep import hamming_weights_spmd
from ldweaver_tpu_torch.core.hamming import (
    estimate_hamming_distance_weights,
    hamming_weights_numpy,
)


def structured_snps(nseq, nsnp, seed, mut=0.03):
    """Sequences in 4 clades (a clade base plus `mut` mutated sites per
    sequence), so Hamming neighbour counts vary across sequences; ~1% N
    calls give some sites a fifth allele class."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(4, nsnp))
    clade = rng.integers(0, 4, size=nseq)
    codes = bases[clade].copy()
    flip = rng.random((nseq, nsnp)) < mut
    codes[flip] = rng.integers(0, 4, size=int(flip.sum()))
    codes[rng.random((nseq, nsnp)) < 0.01] = 4
    codes = codes.astype(np.uint8)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    uqe = (acgtn > 0).astype(np.uint8).T
    pos = np.sort(rng.choice(np.arange(1, 10 * nsnp), nsnp, replace=False))
    return SnpData(
        codes=codes, pos=pos.astype(np.int64), g=10 * nsnp,
        seq_names=[str(i) for i in range(nseq)], acgtn_table=acgtn,
        uqe=uqe, r=uqe.sum(axis=1).astype(np.int32),
    )


@pytest.mark.parametrize(
    "nseq,nsnp,max_blk_sz,threshold",
    [
        (48, 700, 256, 0.1),  # 700 % 256 != 0: npad = 68 pad columns
        (40, 1024, 512, 0.1),  # npad = 0
        (33, 999, 1000, 0.08),  # one block, npad = 1
    ],
)
def test_hdw_bit_equal(nseq, nsnp, max_blk_sz, threshold):
    sd = structured_snps(nseq, nsnp, seed=nsnp + nseq)
    got = estimate_hamming_distance_weights(
        sd, threshold, backend="spmd", max_blk_sz=max_blk_sz, device="cpu"
    )
    oracle = hamming_weights_numpy(sd.codes, threshold)
    assert np.array_equal(oracle, jax_pkg_numpy(sd.codes, threshold))
    # the case must be non-trivial: some sequences have neighbours
    assert got.min() < 0.5 and np.unique(got).size > 2
    assert np.array_equal(got, oracle)
    ref = hamming_weights_spmd(sd, threshold, max_blk_sz=max_blk_sz)
    assert ref is not None
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("backend", ["jax", "pallas", "numpy"])
def test_compat_backends_bit_equal(backend):
    """The compat backends' weights equal the JAX package's for the same
    backend (the JAX package runs "pallas" through its "jax" weights)."""
    from ldweaver_tpu.core.hamming import (
        estimate_hamming_distance_weights as jax_pkg_weights,
    )

    sd = structured_snps(40, 700, seed=9)
    got = estimate_hamming_distance_weights(sd, backend=backend, device="cpu")
    ref = jax_pkg_weights(sd, backend="numpy" if backend == "numpy" else "jax")
    assert got.min() < 0.5 and np.unique(got).size > 2
    assert np.array_equal(got, ref)


def test_unported_options_raise():
    """n_devices below one raises; two CPU shards give the same weights.
    backend="fast" gives the JAX package's weights, which takes "fast"
    through its "jax" weights (pipeline.py:368)."""
    from ldweaver_tpu.core.hamming import (
        estimate_hamming_distance_weights as jax_pkg_weights,
    )

    sd = structured_snps(8, 64, seed=1)
    got = estimate_hamming_distance_weights(sd, backend="fast", device="cpu")
    assert np.array_equal(got, jax_pkg_weights(sd, backend="jax"))
    assert np.array_equal(
        estimate_hamming_distance_weights(sd, n_devices=2, device="cpu"), got)
    with pytest.raises(ValueError, match="n_devices"):
        estimate_hamming_distance_weights(sd, n_devices=0, device="cpu")
