"""The port's `backend="fast"` pipeline (BLK1-BLK7, device="cpu": the
kernels' plain versions) on the examples/bench_e2e.py generator at its
E2E_SMOKE size (24 genomes x 100 kb x 2,500 SNPs, max_blk_sz=1000, a
3 x 3 block grid), against the port's own spmd run and the JAX package's
fast run on the same input.

  * port fast vs port spmd: sr_links.tsv and lr_links.tsv byte-identical
    (the same tiles, certificate, retry policy and emission order);
  * port fast vs JAX fast: within the reference's CPU-vs-TPU fringe
    (tests/test_torch_pipeline.py's helpers: one-side rows at 2 per 970,
    MI within 1.2e-4, ARACNE agreement 0.99, top-10 equal);
  * a budget that streams the slabs (3 of 3 blocks do not fit): SR table
    byte-identical, LR lines equal as sets (the tile order changes);
  * every ldweaver() run checkpoints BLK5 into dset/mi_chkpt."""

import json
import os

import numpy as np
import pytest

from tests.test_torch_fast_sweep import one_torch_thread  # noqa: F401
from tests.test_torch_pipeline import assert_lr_within_fringe, assert_sr_within_fringe


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import ldweaver_tpu
    import ldweaver_tpu_torch
    from examples.bench_e2e import synth_alignment

    d = tmp_path_factory.mktemp("fast_smoke")
    fa, gbk = str(d / "aln.fa.gz"), str(d / "ref.gbk")
    synth_alignment(fa, gbk, nseq=24, g=100_000, nsnp=2500)
    kw = dict(aln_path=fa, gbk_path=gbk, SnpEff_Annotate=False, max_blk_sz=1000)
    out = {"dir": d, "kw": kw}
    ldweaver_tpu.ldweaver(dset=str(d / "jax_fast"), backend="fast", **kw)
    for tag, backend in (("fast", "fast"), ("spmd", "spmd")):
        ldweaver_tpu_torch.ldweaver(dset=str(d / tag), backend=backend,
                                    device="cpu", **kw)
    for tag in ("jax_fast", "fast", "spmd"):
        out[tag] = str(d / tag)
    return out


def tsv(dset, name):
    with open(os.path.join(dset, "Temp", name), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("name", ["sr_links.tsv", "lr_links.tsv"])
def test_fast_byte_identical_to_spmd(runs, name):
    a, b = tsv(runs["fast"], name), tsv(runs["spmd"], name)
    assert len(a) > 1000 and a == b


def test_fast_within_jax_fast_fringe(runs):
    assert_sr_within_fringe(runs["jax_fast"], runs["fast"])
    assert_lr_within_fringe(runs["jax_fast"], runs["fast"])


def test_fast_phase_stats_and_checkpoints(runs):
    t = json.load(open(os.path.join(runs["fast"], "timings.json")))
    fast = t["blk5_phases"]["fast"]
    for k in ("tiles", "retries", "fallbacks", "demoted", "uploads", "hits",
              "dispatch_s", "finish_s", "ckpt_s", "ckpt_hits"):
        assert k in fast, k
    assert fast["tiles"] == 6 and fast["ckpt_hits"] == 0
    assert not fast["streaming"] and fast["uploads"] == 3  # one per slab
    # every run checkpoints BLK5 into dset/mi_chkpt, as the JAX pipeline;
    # fast and spmd are one tile sweep, with one checkpoint layout
    for tag in ("fast", "spmd"):
        tiles = os.path.join(runs[tag], "mi_chkpt", "spmd_tiles")
        npz = [f for f in os.listdir(tiles) if f.endswith(".npz")]
        assert len(npz) == 6 and "manifest.json" in os.listdir(tiles)


def test_streamed_fast_run(runs):
    import ldweaver_tpu_torch

    dset = str(runs["dir"] / "fast_streamed")
    ldweaver_tpu_torch.ldweaver(dset=dset, backend="fast", device="cpu",
                                device_budget_bytes=int(24 * 1000 * 2 / 0.6) - 1,
                                pipeline_depth=2, **runs["kw"])
    fast = json.load(open(os.path.join(dset, "timings.json")))["blk5_phases"]["fast"]
    assert fast["streaming"] and fast["max_slabs"] == 4 and fast["panel"] == 2
    assert tsv(dset, "sr_links.tsv") == tsv(runs["spmd"], "sr_links.tsv")
    lr_s = tsv(dset, "lr_links.tsv").splitlines()
    lr_r = tsv(runs["spmd"], "lr_links.tsv").splitlines()
    assert sorted(lr_s) == sorted(lr_r) and len(lr_r) > 1000


def test_resumed_pipeline_replays_every_tile(runs, tmp_path):
    """A second run of BLK5 in the same dset (its TSVs removed) replays
    every tile from mi_chkpt and writes the same bytes."""
    import shutil

    import ldweaver_tpu_torch

    dset = str(tmp_path / "again")
    shutil.copytree(runs["fast"], dset)
    for name in ("sr_links.tsv", "lr_links.tsv"):
        os.unlink(os.path.join(dset, "Temp", name))
    ldweaver_tpu_torch.ldweaver(dset=dset, backend="fast", device="cpu",
                                **runs["kw"])
    fast = json.load(open(os.path.join(dset, "timings.json")))["blk5_phases"]["fast"]
    # in device SR mode a replayed tile is dispatched again to rebuild its
    # SR pairs on the device; in host mode nothing is dispatched
    assert fast["ckpt_hits"] == fast["tiles"] == 6
    assert fast["uploads"] == {"device": 3, "host": 0}[fast["sr_reduce"]]
    for name in ("sr_links.tsv", "lr_links.tsv"):
        assert tsv(dset, name) == tsv(runs["fast"], name)
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(dset, "Temp", "sr_links.tsv"), usecols=7),
        np.loadtxt(os.path.join(runs["fast"], "Temp", "sr_links.tsv"), usecols=7))
