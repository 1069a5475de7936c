"""The JAX package's recorded runs as chip_smoke.py drives them in the port:
examples/bench_e2e.py's full alignment, and bench.py's pipeline and
streaming legs.

- chip_smoke's one-pass generator writes examples/bench_e2e.py's
  `synth_alignment` bytes (the gzip member's content: its header carries
  the file name and the time of writing) and GenBank file, and beside them
  the SNP-only alignment of the same draws; its chunked `bench_synth`
  equals bench.py's `synth`.
- The pipeline leg's body (`chip_smoke.pipeline_leg`) on the CPU at
  bench.py's BENCH_SMOKE size (2,048 SNPs x 64 genomes, block 512) against
  the JAX package's `perform_mi_computation(backend="spmd")` on the same
  input: SR links and LR rows within the reference's own CPU-vs-TPU
  fringe (CHIP_PARITY_r05.json: 2 of 970 SR rows, 2 of 20,314 LR rows,
  at least 2), the bounds the card run is held to against the recorded
  counts.
- The streaming leg's body (`chip_smoke.streaming_leg`) on the CPU at
  4,096 SNPs x 64 genomes through bench.py's budget (0.75 of the slabs,
  4 slots of 8 blocks, panels of 2, the card run's plan) against the JAX
  package's streamed `fast_lr_topk` (tests/test_torch_lr_sweep.py's rule),
  with the same slab uploads, and against its own resident run.
- `chip_smoke.srp_ordered` turns the e2e run's SR table (written
  unordered, as an annotating run writes it) into the bytes of a run
  without annotation, the reference of the later headline phases."""

import gzip

import numpy as np
import pytest

import bench
import chip_smoke as cs
from tests.test_torch_lr_sweep import assert_topk_agree


@pytest.mark.parametrize("nseq,g,nsnp", [(24, 100_000, 2500), (7, 10_001, 333)])
def test_full_alignment_generator_matches_bench_e2e(tmp_path, nseq, g, nsnp):
    from examples.bench_e2e import synth_alignment

    ref_fa, ref_gbk = tmp_path / "bench_aln.fa.gz", tmp_path / "bench_ref.gbk"
    synth_alignment(str(ref_fa), str(ref_gbk), nseq, g, nsnp)
    fa, pos, gbk, fa_full = cs.synth_alignments(str(tmp_path), nseq, g, nsnp,
                                                full=True)
    full = gzip.open(fa_full).read()
    assert full == gzip.open(ref_fa).read()
    assert open(gbk, "rb").read() == open(ref_gbk, "rb").read()
    # the SNP-only file: the full rows' columns at the planted positions,
    # and the bytes the SNP-only call writes
    rows = full.split(b"\n")[1::2]
    snps = gzip.open(fa).read()
    assert snps.split(b"\n")[1::2] == [bytes(np.frombuffer(r, np.uint8)[pos - 1])
                                      for r in rows]
    only = tmp_path / "only"
    only.mkdir()
    fa2, pos2, gbk2, none = cs.synth_alignments(str(only), nseq, g, nsnp)
    assert none is None
    assert gzip.open(fa2).read() == snps and np.array_equal(pos2, pos)
    assert open(gbk2, "rb").read() == open(gbk, "rb").read()


@pytest.mark.parametrize("seed", [1, 3])
@pytest.mark.parametrize("nsnp,nseq,chunk", [(300, 50, 16), (257, 33, 7)])
def test_chunked_bench_synth_matches_bench(seed, nsnp, nseq, chunk):
    got = cs.bench_synth(nsnp, nseq, seed, chunk=chunk)
    for a, b in zip(got, bench.synth(nsnp, nseq, seed)):
        assert np.array_equal(a, b)
    acgtn = np.stack([(got[0] == k).sum(axis=0) for k in range(5)])
    assert np.array_equal(got[5], acgtn)


def jax_pipeline_leg(nsnp, nseq, block, out_dir):
    """bench.py's `leg_pipeline` at the given size in the JAX package."""
    from ldweaver_tpu.core.cds import CdsVar, Clusters
    from ldweaver_tpu.core.sweep import perform_mi_computation

    codes, pos, uqe, r, w = bench.synth(nsnp, nseq, seed=1)
    sd = bench._snp_data(codes, pos, uqe, r)
    rng = np.random.default_rng(2)
    cds_var = CdsVar(
        var_estimate=np.zeros(1), cds_start=np.zeros(1, np.int64),
        cds_end=np.zeros(1, np.int64), clusts=Clusters(np.array([1]), 0.0),
        paint=rng.integers(1, 4, size=nsnp).astype(np.int64),
        ref=np.array(["A"] * nsnp), alt=np.array([""] * nsnp),
        allele_table=sd.acgtn_table, nclust=3,
    )
    lr_path = out_dir / "lr_links.tsv"
    links = perform_mi_computation(
        sd, w, cds_var, lr_save_path=str(lr_path),
        sr_save_path=str(out_dir / "sr_links.tsv"), plt_folder=None,
        sr_dist=cs.SR_DIST, lr_retain_links=1e6, max_blk_sz=block,
        srp_cutoff=3.0, backend="spmd", verbose=False,
    )
    return len(links), sum(1 for _ in open(lr_path))


def test_pipeline_leg_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    sr_j, lr_j = jax_pipeline_leg(2048, 64, 512, tmp_path / "jax")
    got = cs.pipeline_leg(2048, 64, 512, "cpu", str(tmp_path / "torch"))
    assert sr_j > 100 and lr_j > 100_000
    assert abs(got["sr_links"] - sr_j) <= cs.fringe_bound(sr_j)
    assert abs(got["lr_rows"] - lr_j) <= cs.fringe_bound(lr_j, cs.LR_FRINGE_RATE)
    assert got["phases"]["spmd"]["tiles"] == 10


def test_streaming_leg_matches_jax():
    from ldweaver_tpu.core.snp_tensor import SnpData as JaxSnpData
    from ldweaver_tpu.parallel import fast_sweep as jfs

    nsnp, nseq, block = 4096, 64, 512
    got = cs.streaming_leg(nsnp, nseq, block, "cpu")
    assert got["streaming"] and not got["resident_streaming"]
    assert (got["max_slabs"], got["panel"]) == (4, 2)
    assert got["resident_pool_bytes"] == 8 * got["slab_bytes"]
    codes, pos, uqe, r, w = bench.synth(nsnp, nseq, seed=3)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    sd = JaxSnpData(codes=codes, pos=pos, g=cs.G,
                    seq_names=[str(i) for i in range(nseq)], acgtn_table=acgtn,
                    uqe=uqe, r=r)
    state = jfs.prepare_fast_sweep(sd, w, block=block, n_devices=1,
                                   hbm_budget_bytes=got["budget"])
    assert state.streaming
    jfs.fast_lr_topk(state=state, sr_dist=cs.SR_DIST, topk=1024)
    u0 = sum(c.uploads for c in state.slab_caches)
    ref = jfs.fast_lr_topk(state=state, sr_dist=cs.SR_DIST, topk=1024)
    assert sum(c.uploads for c in state.slab_caches) - u0 == got["uploads"]
    assert_topk_agree(ref, got["streamed"])
    assert_topk_agree(got["resident"], got["streamed"])


def test_srp_order_of_an_unordered_sr_table(tmp_path):
    """The e2e run annotates, so its SR table is written unordered
    (order_links=False); `srp_ordered` gives the bytes of the run without
    annotation that the later headline phases are held against."""
    from ldweaver_tpu_torch.core.sweep import perform_mi_computation

    sd, w, cds_var = cs.pipeline_leg_inputs(2048, 64)
    out = {}
    for order in (False, True):
        d = tmp_path / str(order)
        (d / "Temp").mkdir(parents=True)
        perform_mi_computation(
            sd, w, cds_var, lr_save_path=str(d / "Temp" / "lr_links.tsv"),
            sr_save_path=str(d / "Temp" / "sr_links.tsv"), max_blk_sz=512,
            order_links=order, backend="spmd", verbose=False, device="cpu")
        out[order] = cs.tsv_bytes(str(d), "sr_links.tsv")
    assert out[False] != out[True]
    assert cs.srp_ordered(out[False]) == out[True]
