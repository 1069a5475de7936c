"""Two processes joined by `torch.distributed` on gloo
(`ldweaver_tpu_torch/parallel/multihost.py`), on device="cpu".

`process_pairs` splits as the JAX package's does.  Two worker processes
(this file's __main__ block; they import the port, not JAX) run
`perform_mi_computation(backend="spmd")` with sr_reduce auto and part and
`fast_lr_topk`; two more run the CLI with `--num-processes 2`.  Both ranks
write sr and lr TSVs (and fit files) byte-identical to the single-process
port run, within the reference fringe of the JAX package's run
(tests/test_torch_pipeline.py's helpers); their top-k equals the one-shard
top-k.  A bring-up without a coordinator, process count or id raises, and
so does a worker whose peer never comes; two workers whose SR budgets
lead them to different SR reductions both raise instead of hanging."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR_RETAIN = 20_000
SR_DIST = 2000
MODES = ("auto", "part")
RANGE_BUDGET = 1 << 16


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argvs, timeout=300):
    """Start one process per argv, wait for all; returns their outputs."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(a, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def tsv_files(dset):
    out = {}
    for sub in ("Temp", "Fit"):
        d = os.path.join(dset, sub)
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.endswith((".tsv", ".npz")):
                    with open(os.path.join(d, name), "rb") as fh:
                        out[name] = fh.read()
    return out


# --------------------------------------------------------------------------
# the worker (no JAX)
# --------------------------------------------------------------------------
def load_case(path):
    from ldweaver_tpu_torch.core.cds import CdsVar, Clusters
    from ldweaver_tpu_torch.core.snp_tensor import SnpData

    z = np.load(path)
    sd = SnpData(codes=z["codes"], pos=z["pos"], g=int(z["g"]),
                 seq_names=[str(i) for i in range(z["codes"].shape[0])],
                 acgtn_table=z["acgtn_table"], uqe=z["uqe"], r=z["r"])
    cds = CdsVar(var_estimate=z["var_estimate"], cds_start=z["cds_start"],
                 cds_end=z["cds_end"], clusts=Clusters(np.array([1]), 0.0),
                 paint=z["paint"], ref=z["ref"], alt=z["alt"],
                 allele_table=z["allele_table"], nclust=int(z["nclust"]))
    lr = SnpData(codes=z["lr_codes"], pos=z["lr_pos"], g=int(z["lr_g"]),
                 seq_names=[str(i) for i in range(z["lr_codes"].shape[0])],
                 acgtn_table=z["lr_acgtn"], uqe=z["lr_uqe"], r=z["lr_r"])
    return sd, z["w"], cds, lr, z["lr_w"]


def run_pmc(mod, sd, w, cds, out, **kw):
    temp, fit = os.path.join(out, "Temp"), os.path.join(out, "Fit")
    os.makedirs(temp)
    phases = {}
    mod.perform_mi_computation(
        sd, w, cds, lr_save_path=os.path.join(temp, "lr_links.tsv"),
        sr_save_path=os.path.join(temp, "sr_links.tsv"), plt_folder=fit,
        sr_dist=SR_DIST, lr_retain_links=LR_RETAIN, max_blk_sz=1000,
        srp_cutoff=3.0, backend="spmd", verbose=False, phase_timings=phases,
        **kw,
    )
    return phases


def worker(workdir, rank, port, job):
    """`job` "runs": the pipeline in both modes and the LR sweep;
    "disagree": rank 0 with an SR budget of one byte ("auto" takes the
    host), rank 1 with the default (the device)."""
    import torch

    from ldweaver_tpu_torch.core import sweep as tsweep
    from ldweaver_tpu_torch.parallel import fast_sweep, multihost
    from ldweaver_tpu_torch.parallel import sr_reduce as tsr

    torch.set_num_threads(1)
    multihost.initialize_multihost(f"localhost:{port}", 2, rank, timeout_s=240)
    sd, w, cds, lr, lr_w = load_case(os.path.join(workdir, "case.npz"))
    if job == "disagree":
        if rank == 0:
            os.environ["LDW_SR_BUDGET"] = "1"
        run_pmc(tsweep, sd, w, cds, os.path.join(workdir, job, f"r{rank}"),
                device="cpu")
        return
    stats = {}
    for mode in MODES:
        if mode == "part":  # tests/test_torch_multidevice.py's RANGE_BUDGET
            tsr.PART_RANGE_MIN = tsr.PART_RANGE_MAX = RANGE_BUDGET
        ph = run_pmc(tsweep, sd, w, cds, os.path.join(workdir, f"r{rank}", mode),
                     sr_reduce=mode, device="cpu")
        stats[mode] = ph["spmd"]
    p1, p2, mi = fast_sweep.fast_lr_topk(lr, lr_w, block=512, topk=400,
                                         device="cpu")
    np.savez(os.path.join(workdir, f"lr{rank}.npz"), p1=p1, p2=p2, mi=mi)
    with open(os.path.join(workdir, f"stats{rank}.json"), "wt") as fh:
        json.dump(stats, fh)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
def test_process_pairs_match_jax(monkeypatch):
    import jax

    from ldweaver_tpu.parallel import multihost as jmh
    from ldweaver_tpu_torch.parallel import multihost as tmh

    for n in (0, 1, 5, 15, 64):
        pairs = np.arange(2 * n, dtype=np.int32).reshape(-1, 2)
        for world in (1, 2, 3, 8):
            for rank in range(world):
                monkeypatch.setattr(jax, "process_count", lambda: world)
                monkeypatch.setattr(jax, "process_index", lambda: rank)
                monkeypatch.setattr(tmh, "process_count", lambda: world)
                monkeypatch.setattr(tmh, "process_index", lambda: rank)
                got, want = tmh.process_pairs(pairs), jmh.process_pairs(pairs)
                assert np.array_equal(got[0], want[0])
                assert np.array_equal(got[1], want[1])
                lo, hi = tmh.shard_ranges(n, world)[rank]
                assert np.array_equal(got[1], np.arange(lo, hi))


def test_failed_bring_up_raises(monkeypatch, tmp_path):
    from ldweaver_tpu_torch.parallel import multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost.initialize_multihost()
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize_multihost("localhost:1", 2, None)
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize_multihost("localhost:1", 2, 2)
    assert multihost.process_count() == 1 and multihost.is_writer()
    # a process whose peer never joins gives up and fails
    code = ("import sys; from ldweaver_tpu_torch.parallel import multihost;"
            f" multihost.initialize_multihost('localhost:{free_port()}', 2, 0,"
            " timeout_s=3)")
    ((rc, out),) = launch([[sys.executable, "-c", code]], timeout=120)
    assert rc != 0, out


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from bench import synth
    from tests.test_torch_sr_reduce import port_case

    d = tmp_path_factory.mktemp("multihost")
    sd, w, cds, jsd, jcds = port_case()
    codes, pos, uqe, r, lr_w = synth(4096, 48, seed=5)
    acgtn = np.stack([(codes == k).sum(axis=0) for k in range(5)]).astype(np.int64)
    np.savez(
        d / "case.npz", codes=sd.codes, pos=sd.pos, g=sd.g,
        acgtn_table=sd.acgtn_table, uqe=sd.uqe, r=sd.r, w=w,
        var_estimate=cds.var_estimate, cds_start=cds.cds_start,
        cds_end=cds.cds_end, paint=cds.paint, ref=cds.ref, alt=cds.alt,
        allele_table=cds.allele_table, nclust=cds.nclust,
        lr_codes=codes, lr_pos=pos, lr_g=2_200_000, lr_acgtn=acgtn,
        lr_uqe=uqe, lr_r=r, lr_w=lr_w,
    )
    port = free_port()
    runs = launch([[sys.executable, __file__, str(d), str(rank), str(port),
                    "runs"] for rank in range(2)])
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    return d, (sd, w, cds, jsd, jcds)


@pytest.mark.parametrize("mode", MODES)
def test_two_processes_byte_identical(case, tmp_path, mode):
    import ldweaver_tpu.core.sweep as jsweep
    import ldweaver_tpu_torch.core.sweep as tsweep
    from tests.test_torch_pipeline import assert_lr_within_fringe, assert_sr_within_fringe

    from tests.test_torch_multidevice import planned_partitions

    d, (sd, w, cds, jsd, jcds) = case
    one = str(tmp_path / "one")
    run_pmc(tsweep, sd, w, cds, one, sr_reduce=mode, device="cpu")
    ref = tsv_files(one)
    assert ref["sr_links.tsv"].count(b"\n") > 100
    for rank in range(2):
        st = json.load(open(d / f"stats{rank}.json"))[mode]
        assert st["shards"] == 2 and st["rank"] == rank
        assert st["tiles"] == 3 and st["gather_bytes"] > 0
        assert st["sr_reduce"] == {"auto": "device", "part": "device-part"}[mode]
        if mode == "part":
            assert st["range_budget"] == RANGE_BUDGET
            planned = planned_partitions(sd, st, 2, SR_DIST)
            assert st["sr_partitions"] == planned > 2
        got = tsv_files(str(d / f"r{rank}" / mode))
        assert got.keys() == ref.keys()
        for name in ref:
            assert got[name] == ref[name], (rank, name)
    jax_dset = str(tmp_path / "jax")
    run_pmc(jsweep, jsd, w, jcds, jax_dset, sr_reduce=mode, n_devices=1)
    assert_sr_within_fringe(jax_dset, one)
    assert_lr_within_fringe(jax_dset, one)


def test_two_process_fast_lr_topk(case):
    from ldweaver_tpu_torch.parallel import fast_sweep

    d, _ = case
    lr, lr_w = load_case(d / "case.npz")[3:]
    one = fast_sweep.fast_lr_topk(lr, lr_w, block=512, topk=400, device="cpu")
    assert one[2].size == 400
    for rank in range(2):
        got = np.load(d / f"lr{rank}.npz")
        for a, k in zip(one, ("p1", "p2", "mi")):
            assert np.array_equal(a, got[k]), (rank, k)


def test_processes_choosing_different_sr_reductions_raise(case):
    """Ranks whose SR budgets give different modes stop with an error
    before the sweep, instead of issuing different collectives."""
    d, _ = case
    port = free_port()
    runs = launch([[sys.executable, __file__, str(d), str(rank), str(port),
                    "disagree"] for rank in range(2)], timeout=300)
    for rc, out in runs:
        assert rc != 0, out[-4000:]
        assert "chose different SR reductions" in out, out[-4000:]
        assert "('host', 0), ('device', 0)" in out, out[-4000:]


def test_two_process_cli(tmp_path):
    from examples.bench_e2e import synth_alignment
    import ldweaver_tpu_torch.cli as tcli

    fa, gbk = str(tmp_path / "aln.fa.gz"), str(tmp_path / "ref.gbk")
    synth_alignment(fa, gbk, nseq=16, g=100_000, nsnp=2500)
    base = ["run", "--aln", fa, "--gbk", gbk, "--device", "cpu",
            "--max-blk-sz", "1000", "--lr-retain-links", str(LR_RETAIN),
            "--no-annotate", "--backend", "spmd"]
    port = free_port()
    runs = launch([[sys.executable, "-m", "ldweaver_tpu_torch.cli", *base,
                    "--dset", str(tmp_path / f"r{rank}"), "--coordinator",
                    f"localhost:{port}", "--num-processes", "2",
                    "--process-id", str(rank)] for rank in range(2)])
    for rc, out in runs:
        assert rc == 0, out[-4000:]
    assert tcli.main([*base, "--dset", str(tmp_path / "one")]) == 0
    ref = tsv_files(str(tmp_path / "one"))
    assert ref["sr_links.tsv"].count(b"\n") > 100
    assert ref["lr_links.tsv"].count(b"\n") > 1000
    for rank in range(2):
        t = json.load(open(tmp_path / f"r{rank}" / "timings.json"))
        spmd = t["blk5_phases"]["spmd"]
        assert spmd["shards"] == 2 and spmd["rank"] == rank
        got = tsv_files(str(tmp_path / f"r{rank}"))
        for name in ("sr_links.tsv", "lr_links.tsv"):
            assert got[name] == ref[name], (rank, name)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
