#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ldweaver_tpu_torch`) on one NVIDIA
Hopper GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line):
  1. probe   - the card's name, capability (must be 9.0), power limit;
  2. build   - every CUDA kernel of the port from ldweaver_tpu_torch/csrc
               (K1 rank_mi, K2 fused_tile, K3 compat_mi), one nvcc per
               source, all started together; ptxas registers and spills of
               each kernel (every one <= 128 registers, 0 spill bytes),
               and from cuobjdump -sass each library's HMMA count and the
               instructions of its counting loops (HMMA, no FFMA);
  3. kernels - K1 (the rank-compacted MI tile) at B = 4096 SNPs for every
               bucket (Rf, Rt, pure) below at the spmd slice's S = 616
               genomes, and for the LR sweep's K1 buckets at its S = 1024;
     fused   - K2 (the fused LR stage-1 tile) at the LR sweep's shape,
               B = 4096 x S = 1024, cross- and same-block with pad sites;
     compat  - K3 (the 25-allele compat tile) at the compat pipeline's
               tiles: 4000 x 4000, the ragged 4000 x 191 and the diagonal
               191 x 191, and the sharded sweep's 512 x 512, S = 616,
               rxy_compat=True;
               each kernel is held against its plain PyTorch version run
               in float64 on the card (the exact result of the kernel's
               own inputs; max abs diff <= 2e-5; for K2 the -inf chunks
               equal and chosen columns equal except at near-ties, <= 1e-5
               in the f64 tile) and against the host float64 oracle on a
               sub-tile of up to 256 x 256 (K1, K2: rtol 2e-4, atol 2e-5;
               K3: rtol 5e-5, atol 5e-6); CUDA-event times of the kernel,
               of the plain version as the CPU path runs it (float32), and
               of one bf16 torch.matmul of the same stacked count planes,
               and the fraction of the bound each kernel reaches;
  4. small   - the port's pipeline on a small synthetic input on the card
               and on the CPU (plain versions): link tables must agree,
               for backend="spmd", "pallas", "jax" and "fast"; for "spmd"
               the card also runs sr_reduce="host", and its sr_links.tsv
               and lr_links.tsv must be byte-identical to the default
               run's, which reduces the SR table on the card; for "fast"
               the card also runs pipeline_depth=1, backend="spmd" and a
               run whose tile dispatches raise on any host sync
               (torch.cuda.set_sync_debug_mode("error")), each
               byte-identical to the fast run (depth 4);
     resume  - on the small input, backend="fast" with sr_reduce="host"
               and backend="spmd" with sr_reduce="device" (one tile
               sweep, both SR modes), each crashed after its first
               checkpoint (the checkpoint save patched to raise) and run
               again in the same dset: the rerun replays >= 1 tile from
               dset/mi_chkpt and writes byte-identical TSVs;
  5. slice   - the main path, `ldweaver(..., backend="spmd")` with the
               default config (SnpEff_Annotate=True, sr_reduce="auto")
               through BLK1-BLK12 at 616 genomes x 2.2 Mb x 32,768 SNPs:
               K1's launches, the SR reduction on the card, the per-block
               times and the BLK5 split, and every data file of
               BLK8-BLK12 present;
     cli     - `python -m ldweaver_tpu_torch.cli run --device cuda` in a
               subprocess on the small input, with --backend spmd and
               with the default backend (fast): exit 0 and the SR tophits;
     headline- examples/bench_e2e.py's run: the whole 616 genomes x 2.2
               Mb alignment (131,072 planted SNPs, written with the SNP-only
               alignment in one pass) through BLK1-BLK12 with its config
               (aln_has_all_bases, SnpEff_Annotate, lr_retain_links
               1,000,000, max_blk_sz 4096: 32 blocks, 528 tiles): every
               block in timings.json, the SR reduction on the card, K1
               launched for every tile with 0 fallbacks, the SR pair count
               equal to an independent count from the kept positions and to
               the JAX package's record (156,118,853), the SR rows within
               the reference's fringe of its record (394,599 +- 814), every
               data file of BLK8-BLK12 present and parsed, the per-block
               times, the BLK5 split and BLK5's own peak device memory;
     headline fast - the SNP-only input through `ldweaver(..., backend="fast",
               device_budget_bytes=50_331_648)` (48 MiB: the rank codes
               stream through an 11-slot slab pool in panels of 9),
               BLK1-BLK7: the SR table reduced on the card,
               sr_links.tsv byte-identical to the headline e2e run's
               in the srp order of a run without annotation,
               its lr_links.tsv lines equal as a set, the run streamed
               with a pool within 60% of the budget, K1 launched for
               every tile; blk5_phases "fast" (uploads, hits, dispatch /
               finish / checkpoint seconds), the per-block times and
               BLK5's own peak device memory beside the budget;
  6. lr      - the LR-only sweep `fast_lr_topk`: card against CPU at 64
               genomes x 16,384 SNPs, then the bench.py sweep leg (the
               `synth` recipe at 1024 genomes x 131,072 SNPs, block 4096,
               top-k 1024): one warm call, 5 timed calls, one profiled
               call split by the card's own events (busy: the union of
               their intervals, at most the call's wall; summed; shares of
               K1, K2, torch's kernels and copies); then the same
               input streamed through a 64 MiB budget
               (hbm_budget_bytes=67_108_864), whose top-1024 must equal
               the resident call's (pairs and values);
     pipeline leg - bench.py's pipeline leg: `perform_mi_computation(
               backend="spmd")` on its synth recipe at 616 genomes x 131,072
               SNPs with a random 3-cluster paint, block 4096: SR links
               and LR rows within the reference's fringe of the JAX
               package's record (396,094 +- 817, 1,000,426 +- 98);
     streaming leg - bench.py's streaming leg: `fast_lr_topk` (top-k 1024)
               on its synth recipe at 16,384 genomes x 32,768 SNPs, block
               4096, through 0.75 of its 8 slabs of 67.1 MB (4 slots,
               panels of 2): the run streams, the counted call uploads the
               JAX package's recorded 17 slabs, and its top-1024 equals a
               resident run's (all 8 slabs on the card) apart from
               near-ties; then K1 at the leg's buckets and K2 at S =
               16,384, each against its plain version as in phase 3;
  7. compat  - the compat path, `ldweaver(..., backend="pallas")` through
               BLK1-BLK7 at 616 genomes x 2.2 Mb x 8,192 SNPs,
               max_blk_sz=4000 (3 blocks, 6 tiles);
     sharded - `parallel/sweep.sharded_lr_topk` (K3 on every 512 x 512
               tile): card against CPU at 64 x 2,048, then one process at
               616 x 8,192 SNPs (136 tiles);
     one card- n_devices=2 on the one card raises ValueError;
     part footprint - the partitioned SR reduction's passes on one shard
               of 32 M and 8 M synthetic kept pairs (a range buffer up to
               512 MiB): the bytes a pair and the range factor measured
               with the card's memory statistics must stay within
               sr_reduce's PART_* constants, the model "auto" selects by;
     flat footprint - the single-device SR reduction's passes (flatten,
               group stats, candidates) on 32 M synthetic kept pairs over
               8 clusters and on 8 M over 8 and 2: the bytes a pair,
               counted with the kept pairs, must stay within
               sr_reduce.FLAT_PASS_BYTES, the flat model "auto" selects by;
               the headline phase also holds BLK5's peak within its peak
               after the tiles plus that model;
  8. multi   - two ranks on cuda:0, joined by torch.distributed on gloo
               (this script started as `--multi-worker job rank port`,
               LDW_SR_BUDGET 1 GiB, multi auto's its own, and
               device_budget_bytes 8 GiB a rank):
               multi small - the small input with backend="spmd" and
               sr_reduce auto, part and host, and backend="fast"; multi
               cli - `python -m ldweaver_tpu_torch.cli run --num-processes
               2 --device cuda:0 --backend spmd`; each rank's TSVs
               byte-identical to the single-process card run's.  Then the
               headline input with sr_reduce="part" (more than 2 k2
               ranges at the range budget's floor), each rank's TSVs
               byte-identical to the headline phase's tables (the SR
               table in srp order) and its peak within
               the part model, with
               each rank's BLK5 split, gather seconds and bytes and peak
               device memory; the LR-only sweep at 1024 x 131,072 over the
               two ranks (top-1024 equal to the lr phase's resident call,
               K1 and K2 launches summing to 150 and 378); the sharded
               sweep over the two ranks (equal to the one-process result).
               multi auto - the headline input with sr_reduce="auto" and an
               LDW_SR_BUDGET a rank between the part model and the flat
               model of its SR table: both ranks take "part", each within
               the part model, TSVs byte-identical to those tables.
  9. terms   - the weight-term count t = 1 and 2 (`precision_terms` of the
               sweeps, `n_terms` of the kernels; every other phase runs the
               default three): K1 at the LR sweep's buckets ((2,2) pure,
               (2,3) and (3,3) pure and general) at S = 1024, K2 at 4096^2
               x 1024 and K3 at 4000^2 and 512^2 x 616, each against its
               plain version at the same t in float64 on the card; the
               host-facing `mi_tile_rank_pallas`, `mi_tile_rank` and
               `mi_tile_pallas` at 512^2 x 616, card against CPU;
               `fast_lr_topk(precision_terms=t)` at 256 genomes x 16,384
               SNPs, block 2048, card against CPU (the top-k rule of
               tests/test_torch_lr_sweep.py); then the sweep leg's shape
               (1024 x 131,072, block 4096, top-k 1024) resident at t = 1,
               2 and 3 from one prepared state: median wall of 5 calls,
               pairs/s, K1 and K2 launches and the device-time split.  The
               kernels line lists every row with its `n_terms`.
Each path runs with the launch counts of its kernels set to 0 just before
and read just after (the cli phases' and the ranks' launches are their
subprocesses' own).

Prints one JSON line of each recorded run's counts beside the JAX
package's record (`recorded`, with the e2e run's per-block times), one
JSON line of per-kernel numbers, then the card's name and power limit as
nvidia-smi gives them, then the ok line.  The input data
is generated from a seed into `_smoke_run/` (git-ignored) beside this
file.  The port imports neither JAX nor the JAX package.
"""

import contextlib
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "_smoke_run")

B = 4096  # the main path's tile (max_blk_sz=4096)
S = 616  # genomes
ATOL_PLAIN = 2e-5  # kernel vs plain PyTorch, same f32 inputs
RTOL_F64, ATOL_F64 = 2e-4, 2e-5  # vs the f64 oracle (tests/test_fast_sweep.py)
BUCKETS = [  # (Rf, Rt, pure); (2,3,*) and (3,3,*) are what the slice runs
    (2, 2, True), (2, 2, False), (3, 2, False), (2, 3, False), (2, 3, True),
    (3, 3, True), (3, 3, False), (5, 5, False), (1, 2, False),
]
# the K1 buckets of the LR sweep's input (K2 takes its (2,2,pure) tiles)
LR_BUCKETS = [(2, 3, True), (2, 3, False), (3, 3, True), (3, 3, False)]
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
G = 2_200_000  # S. pneumoniae-scale genome (bench.py)
SR_DIST = 20000
K2_S = 1024  # genomes in the LR sweep (bench.py sweep leg)
K3_F, K3_EDGE = 4000, 191  # the compat pipeline keeps 8,191 SNPs: blocks 4000, 4000, 191
SHARDED_B, SHARDED_SNPS = 512, 8192  # the sharded sweep's tile and input (616 genomes)
MULTI_SR_BUDGET = 1 << 30  # LDW_SR_BUDGET of each of the two ranks
MULTI_DEVICE_BUDGET = 8 << 30  # device_budget_bytes of each of the two ranks
RTOL_K3, ATOL_K3 = 5e-5, 5e-6  # vs the f64 oracle (tests/test_pallas.py)
NEAR_TIE = 1e-5


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# 1. probe
# --------------------------------------------------------------------------
def probe():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}, capability {cap}, {torch.cuda.device_count()} card(s);"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    if cap != (9, 0):
        raise RuntimeError(f"K1 is built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    from ldweaver_tpu_torch.support import resolve_device

    resolve_device("cuda")  # the port's f32 product precision (TF32 off)
    log(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    return name, smi


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------
def build():
    from ldweaver_tpu_torch.ops import cuda_build

    t0 = time.time()
    report = cuda_build.build(cuda_build.KERNELS, force=True)
    for name, r in report.items():
        log(f"built {name} in {r['seconds']:.1f} s")
        # ptxas -v: "Function properties for <mangled>", its spill line,
        # then "Used N registers, ..." for each kernel
        kernels = re.findall(
            r"Function properties for (\S+)\n.*?(\d+) bytes spill stores,"
            r" (\d+) bytes spill loads\n.*?Used (\d+) registers[^\n]*?(\d+) bytes smem",
            r["log"])
        for mangled, st, ld, regs, smem in kernels:
            kern = re.search(r"([a-z][a-z_]*_kernel)", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            log(f"  {kern.group(1) if kern else mangled}<{','.join(args)}>: {regs}"
                f" registers, {smem} bytes smem, spill {st}/{ld} bytes")
        regs = [int(k[3]) for k in kernels]
        spill = sum(int(k[1]) + int(k[2]) for k in kernels)
        log(f"{name}: {len(regs)} kernels, at most {max(regs, default=0)} registers a"
            f" thread, {spill} bytes of spill stores and loads in all")
        # two 256-thread blocks an SM need <= 128 registers a thread
        if not regs or max(regs) > 128 or spill:
            raise RuntimeError(f"{name}: a kernel above 128 registers or spilling")
    log(f"build wall {time.time() - t0:.1f} s")
    # every kernel counts on the tensor cores: each library's SASS must hold
    # HMMA instructions, and no FFMA between a kernel's first HMMA and its last
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for name in cuda_build.KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", cuda_build.library_path(name)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hmma = sum("HMMA" in line for line in sass.splitlines())
        loop_ops = {}
        for fn in sass.split("Function : ")[1:]:
            lines = fn.splitlines()
            at = [i for i, line in enumerate(lines) if "HMMA" in line]
            for line in lines[at[0] : at[-1] + 1] if at else []:
                op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
                if op:
                    loop_ops[op.group(1)] = loop_ops.get(op.group(1), 0) + 1
        log(f"{name} SASS: {hmma} HMMA instructions; instructions of the counting"
            f" loops: {dict(sorted(loop_ops.items(), key=lambda kv: -kv[1]))}")
        if hmma == 0 or loop_ops.get("FFMA", 0):
            raise RuntimeError(f"{name} does not count on the tensor cores alone")


# --------------------------------------------------------------------------
# 3. kernels
# --------------------------------------------------------------------------
def cuda_time_ms(fn, reps, warm=2):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes at the HBM rate and
    the bf16 operations at the tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bench_synth(nsnp, nseq, seed=0, chunk=2048):
    """bench.py's `synth` recipe: mostly biallelic sites (MAF 0.02-0.5),
    ~15% of sites carrying N calls at 3%, positions over a 2.2 Mb genome,
    Hamming-like weights in [0.05, 0.5].  The [nseq, nsnp] uniform draws
    are taken `chunk` genomes at a time (the same stream, so the same
    values), and only the u8 codes are held whole."""
    rng = np.random.default_rng(seed)
    major = rng.integers(0, 4, size=nsnp)
    minor = (major + rng.integers(1, 4, size=nsnp)) % 4
    maf = rng.uniform(0.02, 0.5, size=nsnp)
    codes = np.empty((nseq, nsnp), np.uint8)
    major8, minor8 = major.astype(np.uint8), minor.astype(np.uint8)
    for s0 in range(0, nseq, chunk):
        u = rng.random((min(chunk, nseq - s0), nsnp))
        codes[s0 : s0 + len(u)] = np.where(u < maf[None, :], minor8[None, :],
                                           major8[None, :])
    del u
    n_sites = rng.random(nsnp) < 0.15
    for s0 in range(0, nseq, chunk):
        ncells = (rng.random((min(chunk, nseq - s0), nsnp)) < 0.03) & n_sites[None, :]
        codes[s0 : s0 + len(ncells)][ncells] = 4
    del ncells
    pos = np.sort(
        rng.choice(np.arange(1, G + 1), size=nsnp, replace=False)
    ).astype(np.int64)
    acgtn = np.zeros((5, nsnp), np.int64)
    for s0 in range(0, nseq, chunk):
        for k in range(5):
            acgtn[k] += (codes[s0 : s0 + chunk] == k).sum(axis=0)
    uqe = (acgtn > 0).astype(np.uint8).T
    r = uqe.sum(axis=1).astype(np.int32)
    w = rng.uniform(0.05, 0.5, size=nseq)
    return codes, pos, uqe, r, w, acgtn


def bench_snp_data(nsnp, nseq, seed=0):
    from ldweaver_tpu_torch.core.snp_tensor import SnpData

    codes, pos, uqe, r, w, acgtn = bench_synth(nsnp, nseq, seed)
    sd = SnpData(codes=codes, pos=pos, g=G,
                 seq_names=[str(i) for i in range(nseq)], acgtn_table=acgtn,
                 uqe=uqe, r=r)
    return sd, w


def bucket_inputs(rng, Rf, Rt, pure, S):
    """Sequence-major rank codes [S, 2B] (rows' SNPs then columns'), with
    per-site r in 1..R (R present) or r == R when pure, and ranks skewed
    like real allele frequencies (rank 0 the major allele)."""
    def block(R):
        r = np.full(B, R) if pure else rng.integers(1, R + 1, B)
        r[0] = R
        # rank x drawn with weight 2^-x: major allele most frequent
        u = rng.random((S, B))
        codes = np.zeros((S, B), np.uint8)
        for x in range(1, 5):
            codes[(u < 0.5 ** x) & (x < r[None, :])] = x
        codes[:R, :] = np.minimum(np.arange(R)[:, None], r[None, :] - 1)
        return codes, r

    cf, rf = block(Rf)
    ct, rt = block(Rt)
    w = 1.0 / rng.integers(1, 12, S)  # Hamming weights are 1/(neighbours+1)
    return np.ascontiguousarray(np.concatenate([cf, ct], axis=1)), rf, rt, w


def kernel_phase(S, buckets, seed, terms=3):
    """K1 at B x S for each bucket over the first `terms` bf16 weight
    terms: against its plain version in float64 on the card (the exact
    tile of the kernel's own inputs) and, at three terms (the f32 weights),
    the host f64 oracle on a 256 x 256 sub-tile; CUDA-event times of the
    kernel, the plain version as the CPU path runs it (float32) and one
    bf16 torch.matmul of the stacked count planes,
    [(Rf-1) B, tS] x [tS, (Rt-1) B]."""
    import torch

    from ldweaver_tpu_torch.core.mi import mi_tile_numpy
    from ldweaver_tpu_torch.ops import rank_mi
    from ldweaver_tpu_torch.parallel.fast_sweep import rank_marginals, wparts

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    rows = {}
    for Rf, Rt, pure in buckets:
        tag = f"K1 {Rf},{Rt},{'pure' if pure else 'general'} S={S} t={terms}"
        codes_np, rf_np, rt_np, w = bucket_inputs(rng, Rf, Rt, pure, S)
        codes = torch.from_numpy(codes_np).to(dev)
        w32, parts = wparts(w)
        w32, parts = w32.to(dev), parts[:terms].to(dev).contiguous()
        px = rank_marginals(codes, 0, B, w32, Rf)
        py = rank_marginals(codes, B, B, w32, Rt)
        r_f = torch.tensor(rf_np, dtype=torch.float32, device=dev)
        r_t = torch.tensor(rt_np, dtype=torch.float32, device=dev)
        neff = float(np.float32(w.sum()))
        args = (codes, 0, B, B, B, parts, px, py, r_f, r_t, neff, Rf, Rt, pure)

        got = rank_mi.rank_mi_tile(*args)
        exact = rank_mi.rank_mi_tile_reference(*args, dtype=torch.float64)
        plain = rank_mi.rank_mi_tile_reference(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{tag}: non-finite output")
        err = float((got.double() - exact).abs().max())
        # the f32 plain version is a yardstick, not a user path on the card:
        # its non-finite outputs are counted and left out of its errors
        fin32 = torch.isfinite(plain)
        plain_nonfinite = int((~fin32).sum())
        err32 = float((got - plain)[fin32].abs().max())
        err_plain = float((plain.double() - exact)[fin32].abs().max())
        del exact
        # f64 oracle on a 256 x 256 sub-tile (host, reference statistic)
        n = 256
        cf = np.ascontiguousarray(codes_np[:, :n].T)
        ct = np.ascontiguousarray(codes_np[:, B : B + n].T)
        uq_f = (np.arange(5)[None, :] < rf_np[:n, None]).astype(np.uint8)
        uq_t = (np.arange(5)[None, :] < rt_np[:n, None]).astype(np.uint8)
        oracle = mi_tile_numpy(cf, ct, w, rf_np[:n], rt_np[:n], uq_f, uq_t,
                               float(w.sum()), rxy_compat=False)
        sub = got[:n, :n].double().cpu().numpy()
        # the oracle holds the f32 weights: below three terms the counted
        # planes hold their bf16 rounding, and only the plain version binds
        ok64 = terms < 3 or np.allclose(sub, oracle, rtol=RTOL_F64, atol=ATOL_F64)
        err64 = float(np.abs(sub - oracle).max())

        ms = cuda_time_ms(lambda: rank_mi.rank_mi_tile(*args), reps=20)
        plain_ms = cuda_time_ms(lambda: rank_mi.rank_mi_tile_reference(*args), reps=3, warm=1)
        nc = (Rf - 1) * (Rt - 1) if Rf >= 2 and Rt >= 2 else 0
        if nc:
            lhs = torch.ones(((Rf - 1) * B, terms * S), dtype=torch.bfloat16, device=dev)
            rhs = torch.ones(((Rt - 1) * B, terms * S), dtype=torch.bfloat16, device=dev)
            library_ms = cuda_time_ms(lambda: torch.matmul(lhs, rhs.T), reps=20)
            del lhs, rhs
        else:
            library_ms = None  # no contraction: the tile is marginals only
        nbytes = S * 2 * B + 2 * terms * S + 4 * (Rf + Rt) * B + 8 * B + 4 * B * B
        bound_ms, bound_by = bound(nbytes, 2.0 * B * B * terms * S * nc)
        row = dict(
            Rf=Rf, Rt=Rt, pure=pure, S=S, n_terms=terms, max_abs_err=err,
            f32_plain_max_abs_err=err32, f32_plain_nonfinite=plain_nonfinite,
            f64_max_abs_err=err64,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, bound_frac=bound_ms / ms,
        )
        rows[(Rf, Rt, pure)] = row
        log(f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, stacked-plane"
            f" matmul {library_ms} ms, bound {bound_ms:.4f} ms ({bound_by}),"
            f" {bound_ms / ms:.3f} of the bound;"
            f" max|kernel-plain64| {err:.2e} (f32 plain: kernel {err32:.2e},"
            f" plain {err_plain:.2e}, {plain_nonfinite} non-finite),"
            f" max|kernel-f64 oracle| {err64:.2e}")
        if err > ATOL_PLAIN:
            raise RuntimeError(f"{tag}: kernel vs plain (f64) {err:.3e} > {ATOL_PLAIN}")
        if not ok64:
            raise RuntimeError(f"{tag}: kernel vs f64 oracle {err64:.3e}")
        del codes, got, plain, args
        torch.cuda.empty_cache()
    return rows


def stage1_phase(S, buckets, seed, terms=3):
    """K1's LR stage-1 form (`rank_mi.rank_mi_stage1`) at B x S for each
    bucket over the first `terms` bf16 weight terms, on a cross-block tile
    and, where Rf == Rt, a diagonal one (the triangle), with pad sites at
    the ends of each block: bit for bit against the store form on the card
    after `tile_masks`, `torch.where` and `chunk_max` (what the sweep ran
    before it), and against its plain version in float64 (the same -inf
    chunks, values within ATOL_PLAIN, another column only where the
    kernel's values at both columns lie within ATOL_PLAIN of the exact
    tile); CUDA-event times of the cross-block tile: the stage-1
    form, the store form with those torch ops (`stored_ms`), the plain
    version in float32 and one bf16 torch.matmul of the stacked count
    planes, [(Rf-1) B, tS] x [tS, (Rt-1) B]."""
    import torch

    from ldweaver_tpu_torch.ops import rank_mi
    from ldweaver_tpu_torch.parallel.fast_sweep import (
        rank_marginals,
        tile_masks,
        wparts,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    f64 = torch.float64
    rows = {}
    for Rf, Rt, pure in buckets:
        codes_np, rf_np, rt_np, w = bucket_inputs(rng, Rf, Rt, pure, S)
        codes = torch.from_numpy(codes_np).to(dev)
        w32, parts = wparts(w)
        w32, parts = w32.to(dev), parts[:terms].to(dev).contiguous()
        pos = torch.from_numpy(np.concatenate([
            np.sort(rng.choice(np.arange(1, G + 1), B, replace=False))
            for _ in range(2)]).astype(np.int32)).to(dev)
        valid = torch.ones(2 * B, dtype=torch.bool, device=dev)
        valid[B - 5 : B] = False
        valid[2 * B - 3 :] = False
        r_all = torch.from_numpy(np.concatenate([rf_np, rt_np]).astype(np.float32)).to(dev)
        neff = float(np.float32(w.sum()))
        row = None
        for same in ((False, True) if Rf == Rt else (False,)):
            tag = (f"K1 stage-1 {Rf},{Rt},{'pure' if pure else 'general'}"
                   f" {'same' if same else 'cross'}-block S={S} t={terms}")
            ts = 0 if same else B
            tile = (codes, 0, ts, B, B, parts, rank_marginals(codes, 0, B, w32, Rf),
                    rank_marginals(codes, ts, B, w32, Rt), r_all[:B],
                    r_all[ts : ts + B], neff, Rf, Rt, pure)
            lr = (pos[:B], pos[ts : ts + B], valid[:B], valid[ts : ts + B], same)
            kw = dict(g=G, sr_dist=SR_DIST)

            def stored():
                _, lr_ok = tile_masks(*lr, G, SR_DIST)
                return rank_mi.chunk_max(torch.where(
                    lr_ok, rank_mi.rank_mi_tile(*tile), float("-inf")))

            kv, kc = rank_mi.rank_mi_stage1(*tile, *lr, **kw)
            sv, sc = stored()
            ev, ec = rank_mi.rank_mi_stage1_reference(*tile, *lr, **kw, dtype=f64)
            torch.cuda.synchronize()
            bitwise = (torch.equal(kv.view(torch.int32), sv.view(torch.int32))
                       and torch.equal(kc, sc))
            if not bool((torch.isneginf(kv) == torch.isneginf(ev)).all()):
                raise RuntimeError(f"{tag}: -inf chunks differ from the plain version")
            fin = torch.isfinite(ev)
            if torch.isnan(kv).any() or not bool(fin.any()) or bool(fin.all()):
                raise RuntimeError(f"{tag}: expected live and masked chunks")
            err = float((kv[fin].double() - ev[fin]).abs().max())
            mism = kc != ec
            n_mism = int(mism.sum())
            tie_gap = tie_err = 0.0
            if n_mism:
                # another column than the exact argmax: the kernel's values
                # at both columns (the store form's, bit for bit) must lie
                # within ATOL_PLAIN of the exact tile, so their exact gap
                # within twice that; K1's error grows with S (PERF.md §7)
                exact = rank_mi.rank_mi_tile_reference(*tile, dtype=f64)
                mi = rank_mi.rank_mi_tile(*tile).double()
                rows_i = torch.nonzero(mism)[:, 0]
                k_col, e_col = kc[mism].long(), ec[mism].long()
                tie_gap = float((exact[rows_i, e_col] - exact[rows_i, k_col]).abs().max())
                tie_err = max(float((mi[rows_i, c] - exact[rows_i, c]).abs().max())
                              for c in (k_col, e_col))
                del exact, mi
            log(f"{tag}: bit for bit the store form's chunk max {bitwise};"
                f" max|kernel-plain64| {err:.2e}; {n_mism} of {kc.numel()}"
                f" chunks pick another column than the f64 plain version (max"
                f" gap {tie_gap:.2e} in the f64 tile, kernel values there within"
                f" {tie_err:.2e} of it), live chunks {int(fin.sum())}")
            if not bitwise:
                raise RuntimeError(f"{tag}: differs from the store form's chunk max")
            if err > ATOL_PLAIN:
                raise RuntimeError(f"{tag}: kernel vs plain (f64) {err:.3e} > {ATOL_PLAIN}")
            if tie_err > ATOL_PLAIN or tie_gap > 2 * ATOL_PLAIN:
                raise RuntimeError(f"{tag}: a divergent column is no tie within the"
                                   f" kernel's bound (gap {tie_gap:.3e}, values"
                                   f" {tie_err:.3e} off)")
            if same:
                row["max_abs_err"] = max(row["max_abs_err"], err)
                continue
            ms = cuda_time_ms(lambda: rank_mi.rank_mi_stage1(*tile, *lr, **kw), reps=20)
            stored_ms = cuda_time_ms(stored, reps=20)
            plain_ms = cuda_time_ms(
                lambda: rank_mi.rank_mi_stage1_reference(*tile, *lr, **kw), reps=3, warm=1)
            nc = (Rf - 1) * (Rt - 1)
            lhs = torch.ones(((Rf - 1) * B, terms * S), dtype=torch.bfloat16, device=dev)
            rhs = torch.ones(((Rt - 1) * B, terms * S), dtype=torch.bfloat16, device=dev)
            library_ms = cuda_time_ms(lambda: torch.matmul(lhs, rhs.T), reps=20)
            del lhs, rhs
            # the store form's inputs, positions and validity; out: one
            # (f32, i32) pair a row and 128-column chunk, no tile
            nbytes = (S * 2 * B + 2 * terms * S + 4 * (Rf + Rt) * B + 8 * B
                      + 8 * B + 2 * B + 8 * B * (B // rank_mi.CHUNK))
            bound_ms, bound_by = bound(nbytes, 2.0 * B * B * terms * S * nc)
            row = dict(Rf=Rf, Rt=Rt, pure=pure, S=S, n_terms=terms, max_abs_err=err,
                       ms=ms, stored_ms=stored_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_frac=bound_ms / ms)
            log(f"K1 stage-1 timing {Rf},{Rt},{'pure' if pure else 'general'} S={S}"
                f" t={terms}: kernel {ms:.4f} ms, store form + torch ops"
                f" {stored_ms:.4f} ms, plain {plain_ms:.3f} ms, stacked-plane"
                f" matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}),"
                f" {bound_ms / ms:.3f} of the bound")
        rows[(Rf, Rt, pure)] = row
        del codes, tile, lr, kv, kc, sv, sc, ev, ec
        torch.cuda.empty_cache()
    return rows


def fused_inputs(rng, same, nseq=K2_S):
    """Biallelic rank codes [nseq, B] (same block) or [nseq, 2B] (rows' SNPs,
    then the columns'), rank 0 the major allele, sorted positions per
    block over the genome, pad sites at the ends of the blocks."""
    n = B if same else 2 * B
    maf = rng.uniform(0.02, 0.5, n)
    codes = (rng.random((nseq, n)) < maf[None, :]).astype(np.uint8)
    pos = np.concatenate([
        np.sort(rng.choice(np.arange(1, G + 1), B, replace=False))
        for _ in range(n // B)
    ]).astype(np.int32)
    valid = np.ones(n, bool)
    valid[B - 5 : B] = False
    valid[n - 3 :] = False
    w = 1.0 / rng.integers(1, 12, nseq)
    return np.ascontiguousarray(codes), pos, valid, w


def fused_phase(terms=3, nseq=K2_S):
    """K2 at the LR sweep's tile shape (B x B over `nseq` genomes) over the
    first `terms` weight terms, cross- and same-block: against its plain
    version in float64 on the card (the exact candidates of the kernel's
    own inputs) and, at three terms, the host f64 oracle on the first 256
    rows."""
    import torch

    from ldweaver_tpu_torch.core.mi import mi_tile_numpy
    from ldweaver_tpu_torch.ops import fused_tile
    from ldweaver_tpu_torch.ops.rank_mi import rank_mi_tile_reference
    from ldweaver_tpu_torch.parallel.fast_sweep import (
        rank_marginals,
        tile_masks,
        wparts,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    f64 = torch.float64
    row = None
    for same in (False, True):
        tag = f"K2 {'same' if same else 'cross'}-block S={nseq} t={terms}"
        codes_np, pos_np, valid_np, w = fused_inputs(rng, same, nseq)
        codes = torch.from_numpy(codes_np).to(dev)
        w32, parts = wparts(w)
        w32, parts = w32.to(dev), parts[:terms].to(dev).contiguous()
        ts = 0 if same else B
        pos = torch.from_numpy(pos_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        px = rank_marginals(codes, 0, B, w32, 2)
        py = rank_marginals(codes, ts, B, w32, 2)
        neff = float(np.float32(w.sum()))
        args = (codes, 0, ts, B, B, parts, px, py, pos[:B], pos[ts : ts + B],
                valid[:B], valid[ts : ts + B], neff, same)
        kw = dict(g=G, sr_dist=SR_DIST)
        kv, kc = fused_tile.fused_tile_stage1(*args, **kw)
        ev, ec = fused_tile.fused_tile_stage1_reference(*args, **kw, dtype=f64)
        pv, _ = fused_tile.fused_tile_stage1_reference(*args, **kw)
        torch.cuda.synchronize()
        if not bool((torch.isneginf(kv) == torch.isneginf(ev)).all()):
            raise RuntimeError(f"{tag}: -inf chunks differ")
        fin = torch.isfinite(ev)
        if torch.isnan(kv).any() or not bool(fin.any()) or bool(fin.all()):
            raise RuntimeError(f"{tag}: expected live and masked chunks")
        err = float((kv[fin].double() - ev[fin]).abs().max())
        err32 = float((kv[fin] - pv[fin]).abs().max())
        err_plain = float((pv[fin].double() - ev[fin]).abs().max())
        mism = kc != ec
        n_mism = int(mism.sum())
        tie_gap = 0.0
        if n_mism:  # near-ties, judged on the exact (f64) tile
            two = torch.full((B,), 2.0, device=dev)
            tile = rank_mi_tile_reference(codes, 0, ts, B, B, parts, px, py,
                                          two, two, neff, 2, 2, True, dtype=f64)
            rows_i = torch.nonzero(mism)[:, 0]
            tie_gap = float((tile[rows_i, kc[mism].long()]
                             - tile[rows_i, ec[mism].long()]).abs().max())
            del tile
        # the first 256 rows against the host f64 oracle (r = 2 everywhere:
        # the general formula equals the pure one)
        n = 256
        two_np = np.full(B, 2)
        uq = np.zeros((B, 5), np.uint8)
        uq[:, :2] = 1
        oracle = torch.from_numpy(mi_tile_numpy(
            np.ascontiguousarray(codes_np[:, :n].T),
            np.ascontiguousarray(codes_np[:, ts : ts + B].T), w, two_np[:n],
            two_np, uq[:n], uq, float(w.sum()), rxy_compat=False))
        _, lr_ok = tile_masks(pos[:n].cpu(), pos[ts : ts + B].cpu(),
                              valid[:n].cpu(), valid[ts : ts + B].cpu(), same,
                              G, SR_DIST)
        o_vals, _ = fused_tile.chunk_max(torch.where(lr_ok, oracle, float("-inf")))
        o_fin = torch.isfinite(o_vals)
        k_sub = kv[:n].cpu().double()[o_fin]
        err64 = float((k_sub - o_vals[o_fin]).abs().max())
        log(f"{tag}: max|kernel-plain64| {err:.2e} (f32 plain: kernel"
            f" {err32:.2e}, plain {err_plain:.2e}), max|kernel-f64 oracle|"
            f" {err64:.2e} (256 rows); {n_mism} of {kc.numel()} chunks pick"
            f" another column (max gap {tie_gap:.2e} in the f64 tile), live"
            f" chunks {int(fin.sum())}")
        if err > ATOL_PLAIN:
            raise RuntimeError(f"{tag}: kernel vs plain (f64) {err:.3e} > {ATOL_PLAIN}")
        if tie_gap > NEAR_TIE:
            raise RuntimeError(f"{tag}: a divergent column is no near-tie ({tie_gap:.3e})")
        if terms == 3 and not torch.allclose(k_sub, o_vals[o_fin], rtol=RTOL_F64,
                                             atol=ATOL_F64):
            raise RuntimeError(f"{tag}: kernel vs f64 oracle {err64:.3e}")
        if not same:
            ms = cuda_time_ms(lambda: fused_tile.fused_tile_stage1(*args, **kw), reps=20)
            plain_ms = cuda_time_ms(
                lambda: fused_tile.fused_tile_stage1_reference(*args, **kw), reps=3, warm=1)
            lhs = torch.ones((B, terms * nseq), dtype=torch.bfloat16, device=dev)
            rhs = torch.ones((B, terms * nseq), dtype=torch.bfloat16, device=dev)
            library_ms = cuda_time_ms(lambda: torch.matmul(lhs, rhs.T), reps=20)
            del lhs, rhs
            nbytes = (nseq * 2 * B + 2 * terms * nseq + 4 * 2 * 2 * B + 4 * 2 * B
                      + 2 * B + 8 * B * (B // 128))
            bound_ms, bound_by = bound(nbytes, 2.0 * B * B * terms * nseq)
            row = dict(S=nseq, n_terms=terms, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bound_frac=bound_ms / ms)
            log(f"K2 timing S={nseq} t={terms}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bf16"
                f" matmul {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}),"
                f" {bound_ms / ms:.3f} of the bound")
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)
        del codes, kv, kc, ev, ec, pv, args
        torch.cuda.empty_cache()
    return row


K3_SHAPES = ((K3_F, K3_F, K3_F), (K3_F, K3_EDGE, K3_F), (K3_EDGE, K3_EDGE, 0),
             (SHARDED_B, SHARDED_B, K3_F))


def compat_kernel_phase(shapes=K3_SHAPES, terms=3):
    """K3 over the first `terms` weight terms at the tile shapes of the
    8,191-SNP compat pipeline: 4000 x 4000, the ragged 4000 x 191 and the
    diagonal 191 x 191 (rxy_compat=True, so the ragged tiles carry the
    column-major RXY alias), and at the sharded sweep's 512 x 512 tile.
    Each against its plain version in float64 on the card, and (at three
    terms) a sub-input of up to 256 x 256 against the host float64
    oracle."""
    import torch

    from ldweaver_tpu_torch.core.mi import mi_tile_numpy
    from ldweaver_tpu_torch.ops import compat_mi

    dev = torch.device("cuda")
    codes, _, uqe, r, w, _ = bench_synth(2 * K3_F, S, seed=3)
    rows = {}
    # (F, T, first column of the column block): cross-block tiles read the
    # second half of the sites, the diagonal tile its own rows
    for F, T, t0 in shapes:
        tag = f"K3 {F}x{T} t={terms}"
        cf = np.ascontiguousarray(codes[:, :F].T)
        ct = np.ascontiguousarray(codes[:, t0 : t0 + T].T)

        def host(n_f, n_t):
            return (cf[:n_f], ct[:n_t], w, r[:n_f], r[t0 : t0 + n_t],
                    uqe[:n_f], uqe[t0 : t0 + n_t], float(w.sum()))

        args = compat_mi.tile_inputs(*host(F, T), rxy_compat=True, n_terms=terms,
                                     device=dev)
        got = compat_mi.compat_mi_tile(*args)
        exact = compat_mi.compat_mi_tile_reference(*args, dtype=torch.float64)
        plain = compat_mi.compat_mi_tile_reference(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{tag}: non-finite output")
        err = float((got.double() - exact).abs().max())
        err32 = float((got - plain).abs().max())
        err_plain = float((plain.double() - exact).abs().max())
        del exact
        sub = host(min(256, F), min(256, T))
        k_sub = compat_mi.mi_tile_pallas(*sub, rxy_compat=True, n_terms=terms,
                                         device=dev)
        oracle = mi_tile_numpy(*sub, rxy_compat=True)
        err64 = float(np.abs(k_sub - oracle).max())
        ms = cuda_time_ms(lambda: compat_mi.compat_mi_tile(*args), reps=5, warm=1)
        plain_ms = cuda_time_ms(
            lambda: compat_mi.compat_mi_tile_reference(*args), reps=2, warm=1)
        lhs = torch.ones((4 * F, terms * S), dtype=torch.bfloat16, device=dev)
        rhs = torch.ones((4 * T, terms * S), dtype=torch.bfloat16, device=dev)
        library_ms = cuda_time_ms(lambda: torch.matmul(lhs, rhs.T), reps=5)
        del lhs, rhs
        # 16 counted planes (the fifth row / column by closure); per site
        # 5 marginals, 5 closure marginals, 5 gates and r
        nbytes = S * (F + T) + 2 * terms * S + 4 * (16 * (F + T)) + 8 * F * T
        bound_ms, bound_by = bound(nbytes, 16 * 2.0 * F * T * terms * S)
        rows[(F, T)] = dict(n_terms=terms, max_abs_err=err, f32_plain_max_abs_err=err32,
                            f64_max_abs_err=err64, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_frac=bound_ms / ms)
        log(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bf16 matmul"
            f" of the 16 planes {library_ms:.4f} ms, bound {bound_ms:.4f} ms"
            f" ({bound_by}), {bound_ms / ms:.3f} of the bound;"
            f" max|kernel-plain64| {err:.2e} (f32 plain: kernel"
            f" {err32:.2e}, plain {err_plain:.2e}), max|kernel-f64 oracle|"
            f" {err64:.2e} ({k_sub.shape[0]}x{k_sub.shape[1]} sub-input)")
        if err > ATOL_PLAIN:
            raise RuntimeError(f"{tag}: kernel vs plain (f64) {err:.3e} > {ATOL_PLAIN}")
        if terms == 3 and not np.allclose(k_sub, oracle, rtol=RTOL_K3, atol=ATOL_K3):
            raise RuntimeError(f"{tag}: kernel vs f64 oracle {err64:.3e}")
        del args, got, plain
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# synthetic input: the examples/bench_e2e.py recipe
# --------------------------------------------------------------------------
def write_gbk(path, name, seq, cds_list):
    g = len(seq)
    with open(path, "wt") as fh:
        fh.write(f"LOCUS       {name}             {g} bp    DNA     circular"
                 " BCT 01-JAN-2024\n")
        fh.write("DEFINITION  synthetic benchmark genome.\n")
        fh.write(f"VERSION     {name}\n")
        fh.write("FEATURES             Location/Qualifiers\n")
        fh.write(f"     source          1..{g}\n")
        for k, (s, e, strand) in enumerate(cds_list):
            loc = f"{s}..{e}" if strand > 0 else f"complement({s}..{e})"
            fh.write(f"     gene            {loc}\n")
            fh.write(f'                     /gene="g{k:04d}"\n')
            fh.write(f"     CDS             {loc}\n")
            fh.write(f'                     /gene="g{k:04d}"\n')
            fh.write(f'                     /locus_tag="SYN_{k:05d}"\n')
            fh.write(f'                     /product="hypothetical protein {k}"\n')
        fh.write("ORIGIN\n")
        for i in range(0, g, 60):
            chunk = seq[i : i + 60]
            groups = " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10))
            fh.write(f"{i + 1:>9} {groups.lower()}\n")
        fh.write("//\n")


def synth_alignments(out_dir, nseq, g, nsnp, seed=0, full=False):
    """examples/bench_e2e.py's `synth_alignment` recipe: biallelic sites
    with minor-allele frequency in [0.02, 0.5], ~15% of sites carrying N
    calls at 3%, CDS features tiling ~85% of the genome.  Writes the
    SNP-only alignment `snps.fa.gz` and the GenBank file `ref.gbk`, and
    with `full` also the whole nseq x g alignment `aln.fa.gz`, the same
    bytes as bench_e2e's (both alignments from the same draws, in its
    order) -> (snps.fa.gz, 1-based positions, ref.gbk, aln.fa.gz or
    None)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[rng.integers(0, 4, size=g)]
    snp_pos = np.sort(rng.choice(g, size=nsnp, replace=False))  # 0-based
    major = ref[snp_pos]
    minor_off = rng.integers(1, 4, size=nsnp)
    minor = bases[(np.searchsorted(bases, major) + minor_off) % 4]
    maf = rng.uniform(0.02, 0.5, size=nsnp)
    n_sites = rng.random(nsnp) < 0.15
    fa = os.path.join(out_dir, "snps.fa.gz")
    fa_full = os.path.join(out_dir, "aln.fa.gz") if full else None
    row = ref.copy()
    with contextlib.ExitStack() as stack:
        fh = stack.enter_context(gzip.open(fa, "wb", compresslevel=1))
        fh_full = (stack.enter_context(gzip.open(fa_full, "wb", compresslevel=1))
                   if full else None)
        for s in range(nseq):
            take_minor = rng.random(nsnp) < maf
            col = np.where(take_minor, minor, major)
            ncalls = (rng.random(nsnp) < 0.03) & n_sites
            col = np.where(ncalls, np.uint8(ord("N")), col).astype(np.uint8)
            fh.write(b">seq%d\n" % s)
            fh.write(col.tobytes())
            fh.write(b"\n")
            if full:
                row[snp_pos] = col
                fh_full.write(b">seq%d\n" % s)
                fh_full.write(row.tobytes())
                fh_full.write(b"\n")
    cds = []
    p = 150
    while p + 3000 < g:
        ln = int(rng.integers(200, 500)) * 3
        strand = 1 if rng.random() < 0.7 else -1
        cds.append((p, p + ln - 1, strand))
        p += ln + int(rng.integers(30, 250))
    gbk = os.path.join(out_dir, "ref.gbk")
    write_gbk(gbk, "SYNPNEUMO.1", ref.tobytes().decode(), cds)
    return fa, snp_pos + 1, gbk, fa_full


def read_links(dset):
    def rows(name):
        path = os.path.join(dset, "Temp", name)
        return [ln.rstrip("\n").split("\t") for ln in open(path)]

    sr = rows("sr_links.tsv")
    lr = rows("lr_links.tsv")
    return sr, lr


# the data files of BLK8-BLK12 in cleanup()'s layout (BLK9 writes
# SR_Tanglegram); the network pages are written without matplotlib too
BLK8_12_FILES = [
    "Tophits/sr_tophits.tsv", "Tophits/lr_tophits.tsv",
    "Annotated_links/sr_links_annotated.tsv",
    "Annotated_links/lr_links_annotated.tsv",
    "Temp/sr_annotations.tsv", "Temp/lr_annotations.tsv",
    "Temp/sr_snps.vcf", "Temp/lr_snps.vcf",
    *[f"GWESExplorer/{k}_GWESExplorer/snps.{ext}"
      for k in ("SR", "LR") for ext in ("loci", "aln", "outliers")],
    "SR_Tanglegram/tanglegram_segments.tsv", "SR_Tanglegram/tanglegram.html",
    "Tophits/SR_network_plot.html", "Tophits/lr_network_plot.html",
]


def parse_output(path):
    """Parse one data file of BLK8-BLK12 by its kind -> its record count:
    TSVs (a header and rows of its width), VCF bodies (>= 8 fields a
    line), GWESExplorer loci (integers), outliers (a header and rows of 6
    numbers) and alignments (records of one length), HTML pages (one
    document)."""
    text = open(path).read()
    lines = text.splitlines()
    ext = os.path.splitext(path)[1]
    bad = None
    if ext == ".tsv":
        widths = {len(ln.split("\t")) for ln in lines}
        n, bad = len(lines) - 1, len(widths) != 1 or widths.pop() < 2
    elif ext == ".vcf":
        body = [ln.split("\t") for ln in lines if not ln.startswith("#")]
        n, bad = len(body), any(len(f) < 8 for f in body)
    elif ext == ".loci":
        n, bad = len(lines), not all(ln.strip().isdigit() for ln in lines)
    elif ext == ".outliers":
        rows = [ln.split() for ln in lines[1:]]
        n = len(rows)
        bad = lines[0].split()[:2] != ["Pos_1", "Pos_2"] or any(
            len(f) != 6 or not np.isfinite(np.array(f, np.float64)).all() for f in rows)
    elif ext == ".aln":
        heads, seqs = lines[0::2], lines[1::2]
        n = len(seqs)
        bad = (not all(h.startswith(">") for h in heads)
               or len({len(q) for q in seqs}) != 1)
    elif ext == ".html":
        n, bad = 1, not (text.startswith("<!DOCTYPE html>") and "</html>" in text)
    if bad is None or bad or n < 1:
        raise RuntimeError(f"{path}: does not parse as its kind ({n} records)")
    return n


def check_blk8_12(dset):
    """Every data file of BLK8-BLK12 present and parsed (`parse_output`,
    at least one record each) -> {file: records}."""
    missing = [f for f in BLK8_12_FILES
               if not os.path.isfile(os.path.join(dset, f))
               or os.path.getsize(os.path.join(dset, f)) == 0]
    if missing:
        raise RuntimeError(f"BLK8-BLK12 outputs missing or empty: {missing}")
    return {f: parse_output(os.path.join(dset, f)) for f in BLK8_12_FILES}


def check_tables(sr, lr):
    sr_mi = np.array([float(r[6]) for r in sr])
    sr_srp = np.array([float(r[7]) for r in sr])
    lr_mi = np.array([float(r[5]) for r in lr])
    if not (len(sr) and len(lr)):
        raise RuntimeError("empty link table")
    if not (np.isfinite(sr_mi).all() and np.isfinite(sr_srp).all()
            and np.isfinite(lr_mi).all()):
        raise RuntimeError("non-finite MI or srp in the link tables")
    if any(len(r) != 9 for r in sr) or any(len(r) != 6 for r in lr):
        raise RuntimeError("link table rows of the wrong width")


# --------------------------------------------------------------------------
# 4. small input: card against the plain versions on the CPU
# --------------------------------------------------------------------------
def small_phase(backend):
    import ldweaver_tpu_torch

    d = os.path.join(WORK, f"small_{backend}")
    os.makedirs(d)
    fa, pos, gbk, _ = synth_alignments(d, nseq=48, g=200_000, nsnp=3000, seed=1)
    np.save(os.path.join(d, "pos.npy"), pos)  # for the two-rank runs
    out = {}
    runs = [("cuda", "cuda", {}), ("cpu", "cpu", {})]
    if backend == "spmd":
        runs.append(("cuda_host", "cuda", dict(sr_reduce="host")))
    if backend == "fast":
        runs += [("cuda_depth1", "cuda", dict(pipeline_depth=1)),
                 ("cuda_spmd", "cuda", dict(backend="spmd")),
                 ("cuda_no_sync", "cuda", {})]
    for tag, dev, extra in runs:
        dset = os.path.join(d, tag)
        with dispatch_must_not_sync(tag == "cuda_no_sync"):
            ldweaver_tpu_torch.ldweaver(
                dset=dset, aln_path=fa, aln_has_all_bases=False, pos=pos,
                gbk_path=gbk, max_blk_sz=1024, SnpEff_Annotate=False, device=dev,
                lr_retain_links=20000, **{"backend": backend, **extra},
            )
        out[tag] = read_links(dset)
    if backend == "fast":
        same = {tag: {name: tsv_bytes(os.path.join(d, tag), name)
                      == tsv_bytes(os.path.join(d, "cuda"), name)
                      for name in ("sr_links.tsv", "lr_links.tsv")}
                for tag in ("cuda_depth1", "cuda_spmd", "cuda_no_sync")}
        log(f"small input on the card, fast (depth 4) against depth 1, spmd and"
            f" a run whose tile dispatches raise on any host sync"
            f" (torch.cuda.set_sync_debug_mode): byte-identical {same}")
        if not all(v for by_name in same.values() for v in by_name.values()):
            raise RuntimeError("fast: depth 1, spmd or no-sync TSVs differ from depth 4's")
    if backend == "spmd":
        # the SR reduction on the card and on the host: the same bytes
        modes = {tag: json.load(open(os.path.join(d, tag, "timings.json")))
                 ["blk5_phases"]["spmd"]["sr_reduce"] for tag in ("cuda", "cuda_host")}
        same = {}
        for name in ("sr_links.tsv", "lr_links.tsv"):
            with open(os.path.join(d, "cuda", "Temp", name), "rb") as a, \
                    open(os.path.join(d, "cuda_host", "Temp", name), "rb") as b:
                same[name] = a.read() == b.read()
        log(f"small input on the card, sr_reduce modes {modes}: byte-identical {same}")
        if modes != {"cuda": "device", "cuda_host": "host"} or not all(same.values()):
            raise RuntimeError("the card's device and host SR reductions disagree")
    (sr_c, lr_c), (sr_p, lr_p) = out["cuda"], out["cpu"]
    check_tables(sr_c, lr_c)
    ksr_c = {(r[1], r[2]): float(r[6]) for r in sr_c}
    ksr_p = {(r[1], r[2]): float(r[6]) for r in sr_p}
    klr_c = {(r[0], r[1]): float(r[5]) for r in lr_c}
    klr_p = {(r[0], r[1]): float(r[5]) for r in lr_p}
    sr_only = len(set(ksr_c) ^ set(ksr_p))
    lr_only = len(set(klr_c) ^ set(klr_p))
    sr_diff = max(abs(ksr_c[k] - ksr_p[k]) for k in set(ksr_c) & set(ksr_p))
    lr_diff = max(abs(klr_c[k] - klr_p[k]) for k in set(klr_c) & set(klr_p))
    top10 = [r[1:3] for r in sr_c[:10]] == [r[1:3] for r in sr_p[:10]]
    res = dict(sr_rows=len(sr_c), lr_rows=len(lr_c), sr_one_side=sr_only,
               lr_one_side=lr_only, sr_mi_max_abs_diff=sr_diff,
               lr_mi_max_abs_diff=lr_diff, sr_top10_equal=top10)
    log(f"small input, backend={backend!r}, card vs CPU: {json.dumps(res)}")
    # the reference package's own CPU-vs-TPU spread (CHIP_PARITY_r05.json):
    # one-side rows at 2 per 970, MI within 1.2e-4, top-10 ranking equal
    if not (sr_only <= max(2, round(2 / 970 * len(sr_p)))
            and lr_only <= max(2, round(2 / 970 * len(lr_p)))
            and sr_diff <= 1.2e-4 and lr_diff <= 1.2e-4 and top10):
        raise RuntimeError(f"backend={backend!r}: card and CPU link tables disagree")
    return res


@contextlib.contextmanager
def dispatch_must_not_sync(on):
    """While on, every FastTileRunner.dispatch runs under
    torch.cuda.set_sync_debug_mode("error"): an operation that waits for
    the card (a blocking copy, .item(), nonzero) raises."""
    if not on:
        yield
        return
    import torch

    from ldweaver_tpu_torch.core.sweep import FastTileRunner

    orig = FastTileRunner.dispatch

    def strict(self, bi, bj, lane=0):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(self, bi, bj, lane)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    FastTileRunner.dispatch = strict
    try:
        yield
    finally:
        FastTileRunner.dispatch = orig


def tsv_bytes(dset, name):
    with open(os.path.join(dset, "Temp", name), "rb") as fh:
        return fh.read()


def srp_ordered(sr_tsv):
    """An SR table written without the srp order (SnpEff_Annotate=True) as
    a run without annotation writes it: rows stably sorted by descending
    srp (perform_mi_computation's order_links; the 15 significant digits
    of the column keep the order of distinct values)."""
    lines = sr_tsv.splitlines(keepends=True)
    return b"".join(sorted(lines, key=lambda ln: -float(ln.split(b"\t")[7])))


class SimulatedCrash(Exception):
    pass


def resume_phase():
    """backend="fast" (host SR mode: a done tile replays from disk) and
    "spmd" (device SR mode: a done tile replays its LR rows and is
    dispatched again) on the small input on the card: a run that dies
    after its first checkpoint, rerun in the same dset, must replay
    checkpoints and write the uninterrupted run's bytes."""
    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.core import sweep as tsweep

    d = os.path.join(WORK, "resume")
    os.makedirs(d)
    fa, pos, gbk, _ = synth_alignments(d, nseq=48, g=200_000, nsnp=3000, seed=1)
    kw = dict(aln_path=fa, aln_has_all_bases=False, pos=pos, gbk_path=gbk,
              max_blk_sz=1024, SnpEff_Annotate=False, device="cuda",
              lr_retain_links=20000)
    orig = tsweep._BlockCheckpoint.save
    res = {}
    for backend, extra in (("fast", dict(sr_reduce="host")),
                           ("spmd", dict(sr_reduce="device"))):
        ref = os.path.join(d, f"{backend}_ref")
        ldweaver_tpu_torch.ldweaver(dset=ref, backend=backend, **extra, **kw)
        saved = {"n": 0}

        def dying_save(self, key, payload, _saved=saved):
            if _saved["n"] >= 1:
                raise SimulatedCrash("after the first checkpoint")
            orig(self, key, payload)
            _saved["n"] += 1

        dset = os.path.join(d, backend)
        tsweep._BlockCheckpoint.save = dying_save
        try:
            ldweaver_tpu_torch.ldweaver(dset=dset, backend=backend, **extra, **kw)
            raise RuntimeError(f"resume {backend}: the run did not crash")
        except SimulatedCrash:
            pass
        finally:
            tsweep._BlockCheckpoint.save = orig
        ldweaver_tpu_torch.ldweaver(dset=dset, backend=backend, **extra, **kw)
        stats = json.load(open(os.path.join(dset, "timings.json")))["blk5_phases"][backend]
        same = all(tsv_bytes(dset, n) == tsv_bytes(ref, n)
                   for n in ("sr_links.tsv", "lr_links.tsv"))
        res[backend] = dict(ckpt_hits=stats["ckpt_hits"], tiles=stats["tiles"],
                            ckpt_s=stats["ckpt_s"], byte_identical=same,
                            sr_reduce=stats.get("sr_reduce"))
        if stats["ckpt_hits"] < 1 or not same:
            raise RuntimeError(f"resume {backend}: {res[backend]}")
    log(f"resume on the card (crash after the first checkpoint, rerun): {json.dumps(res)}")
    if res["spmd"]["sr_reduce"] != "device" or res["fast"]["sr_reduce"] != "host":
        raise RuntimeError(f"resume: not in the SR modes asked for: {res}")
    return res


# --------------------------------------------------------------------------
# 5. the main path
# --------------------------------------------------------------------------
def slice_phase():
    import torch

    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.ops import rank_mi

    d = os.path.join(WORK, "slice")
    os.makedirs(d)
    t0 = time.time()
    fa, pos, gbk, _ = synth_alignments(d, nseq=616, g=2_200_000, nsnp=32768)
    log(f"slice input generated in {time.time() - t0:.1f} s")
    dset = os.path.join(d, "ldw_out")
    rank_mi.K1.reset()
    t0 = time.time()
    ldweaver_tpu_torch.ldweaver(  # the default config: BLK1-BLK12
        dset=dset, aln_path=fa, aln_has_all_bases=False, pos=pos,
        gbk_path=gbk, backend="spmd", max_blk_sz=4096, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = rank_mi.K1.launches
    by_bucket = dict(rank_mi.K1.by_bucket)
    timings = json.load(open(os.path.join(dset, "timings.json")))
    sr, lr = read_links(dset)
    check_tables(sr, lr)
    records = check_blk8_12(dset)
    spmd = timings["blk5_phases"]["spmd"]
    log(f"slice BLK5: {json.dumps(blk5_split(timings))}")
    blk8_12 = {k: timings.get(k) for k in (
        "blk8_annotation_tophits", "blk9_tanglegram", "blk10_gwes_explorer",
        "blk11_network_plot", "blk12_lr_analysis")}
    log(f"slice wall {wall:.1f} s; timings.json: {json.dumps(timings)}")
    log(f"slice BLK8-BLK12 (s): {json.dumps(blk8_12)}, together"
        f" {sum(v or 0 for v in blk8_12.values()):.3f} s; records {records}")
    log(f"slice: sr rows {len(sr)}, lr rows {len(lr)}, tiles {spmd['tiles']},"
        f" retries {spmd['retries']}, fallbacks {spmd['fallbacks']},"
        f" K1 launches {launches} {by_bucket}")
    if None in blk8_12.values():
        raise RuntimeError(f"a block of BLK8-BLK12 did not run: {blk8_12}")
    if launches < spmd["tiles"] or spmd["tiles"] != 36:
        raise RuntimeError(f"K1 launched {launches} times for {spmd['tiles']} tiles")
    if spmd["sr_reduce"] != "device":
        raise RuntimeError(f"slice: the SR table reduced on the {spmd['sr_reduce']}")
    return launches, by_bucket


def blk5_split(timings, backend="spmd"):
    """BLK5's wall and its parts (timings.json, seconds): the tile sweep
    (dispatch, finish = waits on the card + LR emission, SR emission or
    hand-over, checkpoints; slab uploads, BLK5's own peak device memory),
    the on-device SR reduction's passes and host steps, then the
    background model's finish, ARACNE and the SR table's write."""
    blk5 = timings["blk5_phases"]
    sweep = blk5[backend]
    keys = ("sr_reduce", "tiles", "retries", "fallbacks", "sr_pairs", "depth",
            "streaming", "pool_bytes", "uploads", "hits", "dispatch_s", "finish_s",
            "emit_s", "ckpt_s", "peak_tiles_bytes", "peak_bytes", "bg_stats_s",
            "bg_fit_s", "bg_cand_s", "cand_count", "cand_mb", "bg_order_s")
    return dict(blk5_mi_computation=timings["blk5_mi_computation"],
                **{k: sweep.get(k) for k in keys},
                **{k: blk5.get(k) for k in ("sweep_s", "background_s", "aracne_s",
                                            "sr_write_s")})


def sr_pairs_from_positions(pos, g, sr_dist):
    """Pairs of distinct sites at circular distance min(d, g - d) <=
    sr_dist, counted from the sorted positions alone."""
    p = np.sort(np.asarray(pos, np.int64))
    near = np.searchsorted(p, p + sr_dist, side="right") - np.arange(1, p.size + 1)
    wrap = p.size - np.searchsorted(p, p + g - sr_dist, side="left")
    return int(near.sum() + wrap.sum())


HEADLINE_SNPS = 131072
LR_STREAM_BUDGET = 67_108_864  # 64 MiB: 9 slabs of 1024 x 4096, panels of 7
# The JAX package's recorded output counts on these synthetic inputs
# (E2E_r05.json / E2E_r04.json; BENCH_r05.json "pipeline_*", "streaming_*")
E2E_SR_ROWS, E2E_SR_PAIRS, E2E_TILES = 394_599, 156_118_853, 528
PIPE_SR_LINKS, PIPE_LR_ROWS, PIPE_SR_PAIRS = 396_094, 1_000_426, 156_174_006
STREAM_UPLOADS = 17
# rows on one side only per table row: the reference's own CPU-vs-TPU
# spread (CHIP_PARITY_r05.json; tests/test_torch_pipeline.py FRINGE_RATE)
FRINGE_RATE = 2 / 970  # SR: 2 of 970 rows
LR_FRINGE_RATE = 2 / 20314  # LR: 2 of 20,314 rows


def fringe_bound(n_rows, rate=FRINGE_RATE):
    return max(2, int(round(rate * n_rows)))


BLOCKS = ("blk1_parse_alignment", "blk2_annotation_parse", "blk3_cds_diversity",
          "blk4_hamming_weights", "blk5_mi_computation", "blk6_ld_map",
          "blk7_gwes_plots", "blk8_annotation_tophits", "blk9_tanglegram",
          "blk10_gwes_explorer", "blk11_network_plot", "blk12_lr_analysis")


def headline_phase(sr_reduce="auto"):
    """examples/bench_e2e.py's run on the card: the whole 616 genomes x 2.2
    Mb alignment (131,072 planted SNPs) through BLK1-BLK12 with its config
    (aln_has_all_bases, SnpEff_Annotate, lr_retain_links 1,000,000,
    max_blk_sz 4096, backend "spmd"), against the JAX package's recorded
    counts; with sr_reduce="host" the SR table is copied to the host and
    reduced there instead (for comparison; the script itself runs
    "auto").  The same pass writes the SNP-only alignment and positions,
    the later headline phases' input."""
    import torch

    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.ops import rank_mi
    from ldweaver_tpu_torch.parallel.sr_reduce import flat_peak_bytes

    d = os.path.join(WORK, "headline")
    os.makedirs(d)
    t0 = time.time()
    fa, pos, gbk, fa_full = synth_alignments(d, nseq=616, g=G, nsnp=HEADLINE_SNPS,
                                             full=True)
    np.save(os.path.join(d, "pos.npy"), pos)
    gen_s = time.time() - t0
    log(f"headline input generated in {gen_s:.1f} s: {os.path.getsize(fa_full)}"
        f" bytes of gzip alignment")
    dset = os.path.join(d, "ldw_out")
    torch.cuda.empty_cache()
    rank_mi.K1.reset()
    t0 = time.time()
    # save_additional_outputs keeps the kept positions for the SR-pair
    # count; it writes extra files and changes no link table
    ldweaver_tpu_torch.ldweaver(
        dset=dset, aln_path=fa_full, aln_has_all_bases=True, gbk_path=gbk,
        backend="spmd", max_blk_sz=4096, SnpEff_Annotate=True,
        lr_retain_links=1_000_000, save_additional_outputs=True,
        sr_reduce=sr_reduce, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = rank_mi.K1.launches
    by_bucket = dict(rank_mi.K1.by_bucket)
    timings = json.load(open(os.path.join(dset, "timings.json")))
    spmd = timings["blk5_phases"]["spmd"]
    sr, lr = read_links(dset)
    check_tables(sr, lr)
    records = check_blk8_12(dset)
    z = np.load(os.path.join(dset, "Additional_Outputs", "snp_ACGTN.npz"))
    kept, g = z["pos"], int(z["g"])
    host_sr = sr_pairs_from_positions(kept, g, SR_DIST)
    blocks = {k: timings.get(k) for k in BLOCKS}
    res = dict(wall_s=wall, gen_s=gen_s, nsnp=int(kept.size), g=g, tiles=spmd["tiles"],
               retries=spmd["retries"], fallbacks=spmd["fallbacks"],
               k1_launches=launches, k1_by_bucket={str(k): v for k, v in by_bucket.items()},
               sr_pairs=spmd["sr_pairs"], sr_pairs_from_positions=host_sr,
               sr_rows=len(sr), lr_rows=len(lr), blocks=blocks, records=records,
               blk5=blk5_split(timings))
    log(f"headline e2e (616 x 2.2 Mb alignment, BLK1-BLK12, sr_reduce={sr_reduce!r}):"
        f" {json.dumps(res)}")
    log(f"headline: wall {wall:.1f} s, BLK5 {timings['blk5_mi_computation']:.2f} s"
        f" (dispatch {spmd['dispatch_s']} s, finish {spmd['finish_s']} s, SR"
        f" stats {spmd.get('bg_stats_s')} s, fit {spmd.get('bg_fit_s')} s,"
        f" candidates {spmd.get('bg_cand_s')} s for {spmd.get('cand_count')},"
        f" order {spmd.get('bg_order_s')} s; background"
        f" {timings['blk5_phases'].get('background_s')} s), BLK5 peak device"
        f" memory {spmd['peak_bytes']} bytes ({spmd['peak_tiles_bytes']} after"
        f" the tiles; pool {spmd['pool_bytes']} bytes); flat model"
        f" {flat_peak_bytes(spmd['sr_pairs'])} bytes for {spmd['sr_pairs']} pairs")
    log(f"headline per-block walls (s): {json.dumps(blocks)}; SR rows {len(sr)}"
        f" (JAX record {E2E_SR_ROWS}), SR pairs {spmd['sr_pairs']} (JAX record"
        f" {E2E_SR_PAIRS}), LR rows {len(lr)}")
    missing = [k for k, v in blocks.items() if v is None]
    if missing:
        raise RuntimeError(f"headline: blocks missing from timings.json: {missing}")
    if spmd["sr_reduce"] != ("host" if sr_reduce == "host" else "device"):
        raise RuntimeError(f"headline: the SR table reduced on the {spmd['sr_reduce']}")
    if spmd["peak_bytes"] > spmd["peak_tiles_bytes"] + flat_peak_bytes(spmd["sr_pairs"]):
        raise RuntimeError("headline: BLK5 peak over the tiles' peak plus the flat model")
    if spmd["tiles"] != E2E_TILES or launches < E2E_TILES or spmd["fallbacks"]:
        raise RuntimeError(f"headline: K1 launched {launches} times for"
                           f" {spmd['tiles']} tiles ({E2E_TILES} expected),"
                           f" {spmd['fallbacks']} fallbacks")
    if not spmd["sr_pairs"] == host_sr == E2E_SR_PAIRS:
        raise RuntimeError(f"headline: {spmd['sr_pairs']} SR pairs on the card,"
                           f" {host_sr} from the positions, {E2E_SR_PAIRS} recorded")
    if abs(len(sr) - E2E_SR_ROWS) > fringe_bound(E2E_SR_ROWS):
        raise RuntimeError(f"headline: {len(sr)} SR rows against the recorded"
                           f" {E2E_SR_ROWS} (bound {fringe_bound(E2E_SR_ROWS)})")
    # the later headline runs (fast, two ranks) run without annotation,
    # which orders the SR table by srp (perform_mi_computation's
    # order_links): their reference is this run's tables in that order
    tables = os.path.join(d, "tables")
    os.makedirs(os.path.join(tables, "Temp"))
    with open(os.path.join(tables, "Temp", "sr_links.tsv"), "wb") as fh:
        fh.write(srp_ordered(tsv_bytes(dset, "sr_links.tsv")))
    shutil.copy(os.path.join(dset, "Temp", "lr_links.tsv"), os.path.join(tables, "Temp"))
    inputs = dict(fa=fa, pos=pos, gbk=gbk, tables=tables)
    with open(os.path.join(d, "inputs.json"), "wt") as fh:  # for the two ranks
        json.dump(dict(inputs, pos=os.path.join(d, "pos.npy")), fh)
    recorded = dict(sr_rows=[len(sr), E2E_SR_ROWS], sr_pairs=[spmd["sr_pairs"], E2E_SR_PAIRS],
                    tiles=[spmd["tiles"], E2E_TILES], fallbacks=[spmd["fallbacks"], 0],
                    retries=[spmd["retries"], 0], lr_rows=len(lr), walls_s=blocks,
                    wall_s=wall)
    return by_bucket, inputs, spmd["sr_pairs"], recorded


HEADLINE_FAST_BUDGET = 50_331_648  # 48 MiB: 11 slabs of 616 x 4096, panels of 9


def headline_fast_phase(inputs, depth=4):
    """backend="fast" on the headline input, the rank codes streamed
    through a 48 MiB slab budget, `depth` tiles dispatched ahead, the SR
    table reduced on the card, BLK1-BLK7, against the headline e2e run's
    tables (`inputs` from headline_phase; the SR table in srp order)."""
    import torch

    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.ops import rank_mi

    dset = os.path.join(WORK, "headline", f"ldw_fast_depth{depth}")
    torch.cuda.empty_cache()
    rank_mi.K1.reset()
    t0 = time.time()
    ldweaver_tpu_torch.ldweaver(
        dset=dset, aln_path=inputs["fa"], aln_has_all_bases=False,
        pos=inputs["pos"], gbk_path=inputs["gbk"], backend="fast",
        max_blk_sz=4096, SnpEff_Annotate=False, pipeline_depth=depth,
        device_budget_bytes=HEADLINE_FAST_BUDGET, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = rank_mi.K1.launches
    by_bucket = dict(rank_mi.K1.by_bucket)
    timings = json.load(open(os.path.join(dset, "timings.json")))
    blk5 = timings["blk5_phases"]
    fast = blk5["fast"]
    sr_same = tsv_bytes(dset, "sr_links.tsv") == tsv_bytes(inputs["tables"], "sr_links.tsv")
    lr_f = tsv_bytes(dset, "lr_links.tsv").splitlines()
    lr_s = tsv_bytes(inputs["tables"], "lr_links.tsv").splitlines()
    lr_same_set = sorted(lr_f) == sorted(lr_s)
    blocks = {k: v for k, v in timings.items() if k.startswith("blk") and k != "blk5_phases"}
    res = dict(wall_s=wall, k1_launches=launches,
               k1_by_bucket={str(k): v for k, v in by_bucket.items()},
               sr_tsv_byte_identical_to_e2e=sr_same, lr_rows=len(lr_f),
               lr_set_equal_to_e2e=lr_same_set, lr_row_order_equal=lr_f == lr_s,
               blocks=blocks, blk5=blk5_split(timings, "fast"),
               max_slabs=fast["max_slabs"], panel=fast["panel"])
    log(f"headline fast (616 x 131,072 SNPs, budget {HEADLINE_FAST_BUDGET} bytes,"
        f" depth {depth}, BLK1-BLK7): {json.dumps(res)}")
    log(f"headline fast: wall {wall:.1f} s, BLK5 {timings['blk5_mi_computation']:.2f} s"
        f" (dispatch {fast['dispatch_s']} s, finish {fast['finish_s']} s, SR"
        f" emission {fast['emit_s']} s, checkpoints {fast['ckpt_s']} s, SR"
        f" stats {fast.get('bg_stats_s')} s, fit {fast.get('bg_fit_s')} s;"
        f" background {blk5.get('background_s')} s), slab uploads"
        f" {fast['uploads']}, hits {fast['hits']}; BLK5 peak device memory"
        f" {fast['peak_bytes']} bytes ({fast['peak_tiles_bytes']} after the"
        f" tiles) against a slab budget of {HEADLINE_FAST_BUDGET} bytes, of which"
        f" the pool holds {fast['pool_bytes']}")
    if fast["sr_reduce"] != "device":
        raise RuntimeError(f"headline fast: the SR table reduced on the {fast['sr_reduce']}")
    if fast["pool_bytes"] > 0.6 * HEADLINE_FAST_BUDGET:
        raise RuntimeError(f"headline fast: the slab pool ({fast['pool_bytes']} bytes)"
                           f" exceeds 60% of the budget")
    if not (sr_same and lr_same_set):
        raise RuntimeError("headline fast: the link tables differ from the e2e run's")
    if not (fast["streaming"] and fast["max_slabs"] == 11 and fast["panel"] == 9):
        raise RuntimeError(f"headline fast: not streamed as planned: {fast}")
    if fast["tiles"] != 528 or launches < 528:
        raise RuntimeError(f"headline fast: K1 launched {launches} times for"
                           f" {fast['tiles']} tiles (528 expected)")
    return by_bucket


def depth_ab(depths=(4, 1, 1, 4)):
    """Not part of the smoke run: the headline spmd run, then the
    headline fast run once for each of `depths` (a fresh dset each, so
    nothing resumes), to read what `pipeline_depth` does to BLK5.  Run
    as `python3 -c "import chip_smoke as cs; cs.depth_ab()"`."""
    probe()
    if os.path.exists(WORK):
        shutil.rmtree(WORK)
    os.makedirs(WORK)
    build()
    _, inputs, _, _ = timed("headline", headline_phase)
    for depth in depths:
        shutil.rmtree(os.path.join(WORK, "headline", f"ldw_fast_depth{depth}"),
                      ignore_errors=True)
        timed(f"headline fast depth {depth}", headline_fast_phase, inputs, depth)


def cli_phase():
    """The CLI in a subprocess on the small input, on the card: with
    --backend spmd, and with the default backend (fast)."""
    d = os.path.join(WORK, "cli")
    os.makedirs(d)
    fa, pos, gbk, _ = synth_alignments(d, nseq=48, g=200_000, nsnp=3000, seed=1)
    pos_path = os.path.join(d, "snps.pos")
    np.savetxt(pos_path, pos, fmt="%d")
    for backend in ("spmd", "fast"):
        dset = os.path.join(d, f"out_{backend}")
        flags = ["--backend", "spmd"] if backend == "spmd" else []
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "ldweaver_tpu_torch.cli", "run", "--dset", dset,
             "--aln", fa, "--pos", pos_path, "--gbk", gbk, "--device", "cuda",
             *flags, "--max-blk-sz", "1024", "--lr-retain-links", "20000"],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        wall = time.time() - t0
        tophits = os.path.join(dset, "Tophits", "sr_tophits.tsv")
        ran = (json.load(open(os.path.join(dset, "timings.json")))["blk5_phases"]
               if proc.returncode == 0 else {})
        log(f"cli {' '.join(flags) or '(default backend)'}: exit {proc.returncode}"
            f" in {wall:.1f} s; Tophits/sr_tophits.tsv"
            f" {'present' if os.path.isfile(tophits) else 'missing'}")
        if proc.returncode != 0 or not os.path.isfile(tophits) or backend not in ran:
            log(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise RuntimeError(f"the CLI run ({backend}) failed")


PORT_KERNEL = re.compile(r"\b(rank_mi|fused_tile|compat_mi)_kernel\b")


def sweep_counters():
    """The LR sweep's launch counters: K1's store form (`rank_mi_tile`,
    tiles at most 1024 columns wide), K1's stage-1 form (`rank_mi_stage1`,
    wider tiles) and K2."""
    from ldweaver_tpu_torch.ops import fused_tile, rank_mi

    return rank_mi.K1, rank_mi.K1_STAGE1, fused_tile.K2


def reset_sweep_launches():
    for c in sweep_counters():
        c.reset()


def sweep_launches():
    """(count, {bucket: count}) of each of `sweep_counters` since their
    last reset."""
    return tuple((c.launches, dict(c.by_bucket)) for c in sweep_counters())


def kernel_split(events):
    """Device time of `events`, (name, start_us, end_us) of the card's
    own activities (kernels, copies, fills): busy, the union of their
    intervals (what an idle share needs; it cannot exceed the wall), and
    summed, the sum of their times (above busy only where streams
    overlap), in seconds; and by group, (ms, count) of the port's kernels
    (every template instance of one kernel together), of the copies and
    fills, and of the other kernels (torch's ops)."""
    busy = summed = 0.0
    end = float("-inf")
    groups = {}
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        summed += t1 - t0
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        kern = PORT_KERNEL.search(name)
        group = (kern.group(1) if kern else "copies"
                 if re.match(r"Mem(cpy|set)", name) else "torch ops")
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + (t1 - t0) / 1e3, n + 1)
    return busy / 1e6, summed / 1e6, groups


def device_time_split(fn, top=6):
    """Run fn once under torch.profiler and split the card's time by its
    own events (device_type CUDA in `prof.events()`; the CPU ops' entries
    only attribute those events again): busy and summed device time
    (`kernel_split`), each group's share of the summed time and the
    kernels that took the most.  Fails when busy exceeds the profiled
    wall.  The profiler slows the host side several-fold, so compare the
    device time with an unprofiled wall time, not with this call's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("profiled call: no device events")
    busy, summed, groups = kernel_split(events)
    by_name = {}
    for name, a, b in events:
        ms, n = by_name.get(name[:60], (0.0, 0))
        by_name[name[:60]] = (ms + (b - a) / 1e3, n + 1)
    split = sorted(((k, round(ms, 2), n) for k, (ms, n) in by_name.items()),
                   key=lambda r: -r[1])[:top]
    shares = {k: round(ms / (1e3 * summed), 4) for k, (ms, _) in groups.items()}
    log(f"profiled call: wall {wall:.3f} s, device busy {busy:.3f} s, summed"
        f" {summed:.3f} s over {len(events)} device events; top (name, ms, count):"
        f" {split}; by group (ms, count):"
        f" { {k: (round(ms, 2), n) for k, (ms, n) in groups.items()} },"
        f" share of the summed time: {shares}")
    if busy > wall:
        raise RuntimeError(f"profiled call: device busy {busy:.3f} s over the wall {wall:.3f} s")
    return dict(profiled_wall_s=wall, device_busy_s=busy, device_summed_s=summed,
                device_share=shares)


# --------------------------------------------------------------------------
# 6. the LR-only sweep
# --------------------------------------------------------------------------
def canon_topk(a, b, v):
    """A top-k's (pair, value) list in one order: pairs as (low, high),
    sorted."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    o = np.lexsort((hi, lo))
    return lo[o].tolist(), hi[o].tolist(), v[o].tolist()


def lr_phase():
    import torch

    from ldweaver_tpu_torch.parallel.fast_sweep import (
        fast_lr_topk,
        prepare_fast_sweep,
    )

    # card against CPU (plain versions) at 64 genomes x 16,384 SNPs
    sd, w = bench_snp_data(16384, 64, seed=5)
    res = {dev: fast_lr_topk(sd, w, block=2048, sr_dist=SR_DIST, topk=1024,
                             device=dev) for dev in ("cuda", "cpu")}
    keys = {dev: dict(zip(zip(r[0].tolist(), r[1].tolist()), r[2].tolist()))
            for dev, r in res.items()}
    kth = min(res["cuda"][2][-1], res["cpu"][2][-1])
    one_side = set(keys["cuda"]) ^ set(keys["cpu"])
    far = [k for k in one_side
           if keys["cuda"].get(k, keys["cpu"].get(k)) - kth > NEAR_TIE]
    common = set(keys["cuda"]) & set(keys["cpu"])
    diff = max(abs(keys["cuda"][k] - keys["cpu"][k]) for k in common)
    log(f"LR sweep, card vs CPU (64 x 16,384, block 2048, top-k 1024):"
        f" {len(one_side)} pairs on one side only ({len(far)} beyond a near-tie"
        f" at the k-th value), MI max abs diff {diff:.2e}")
    if far or diff > 1.2e-4 or len(res["cuda"][2]) != 1024:
        raise RuntimeError("LR sweep: card and CPU top-k disagree")

    # the bench.py sweep leg
    t0 = time.time()
    sd, w = bench_snp_data(131072, 1024, seed=0)
    log(f"LR sweep input (bench synth 131,072 x 1024) in {time.time() - t0:.1f} s")
    t0 = time.time()
    state = prepare_fast_sweep(sd, w, block=4096, device="cuda")
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    tiles = {k: len(v) for k, v in state.buckets.items()}
    n22 = tiles.get((2, 2, True), 0)
    log(f"LR sweep prepared in {prep_s:.1f} s; tiles per bucket {tiles}")
    t0 = time.time()
    fast_lr_topk(sr_dist=SR_DIST, topk=1024, state=state)
    warm_s = time.time() - t0
    walls = []
    for _ in range(5):
        reset_sweep_launches()
        t0 = time.time()
        pos1, pos2, mi = fast_lr_topk(sr_dist=SR_DIST, topk=1024, state=state)
        walls.append(time.time() - t0)
        (k1, k1_by_bucket), (s1, s1_by_bucket), (k2, _) = sweep_launches()
        if not (mi.size == 1024 and np.isfinite(mi).all()
                and np.all(np.diff(mi) <= 0) and (pos1 != pos2).all()):
            raise RuntimeError("LR sweep: malformed top-k")
        # block 4096 > 1024: every K1 tile takes the stage-1 form
        if k2 != n22 or k1 or s1 + k2 != sum(tiles.values()):
            raise RuntimeError(f"LR sweep: K2 launched {k2} times for {n22}"
                               f" (2,2,pure) tiles, K1's stage-1 form {s1} times,"
                               f" its store form {k1}")
    median = float(np.median(walls))
    np.savez(os.path.join(WORK, "lr_resident.npz"), pos1=pos1, pos2=pos2, mi=mi)
    pairs = sd.nsnp * (sd.nsnp - 1) // 2
    busy = device_time_split(
        lambda: fast_lr_topk(sr_dist=SR_DIST, topk=1024, state=state))
    out = dict(warm_s=warm_s, walls_s=walls, median_s=median,
               pairs_per_s=pairs / median, k1_launches=k1,
               k1_stage1_launches=s1, k2_launches=k2,
               top_mi=float(mi[0]), kth_mi=float(mi[-1]), **busy)
    log(f"LR sweep (131,072 SNPs x 1024 genomes, block 4096, top-k 1024):"
        f" warm {warm_s:.2f} s, timed {[round(x, 3) for x in walls]} s, median"
        f" {median:.3f} s = {pairs / median:.4g} pairs/s; per call K2 {k2}"
        f" launches, K1 stage-1 {s1} {s1_by_bucket}, K1 store {k1}; device busy"
        f" {busy['device_busy_s']:.3f} s = {100 * busy['device_busy_s'] / median:.0f}%"
        f" of the median wall (summed {busy['device_summed_s']:.3f} s), share of"
        f" the summed time {busy['device_share']}")
    del state
    torch.cuda.empty_cache()

    # the same input streamed through a 64 MiB budget
    t0 = time.time()
    state = prepare_fast_sweep(sd, w, block=4096, hbm_budget_bytes=LR_STREAM_BUDGET,
                               device="cuda")
    torch.cuda.synchronize()
    prep_s = time.time() - t0
    if not state.streaming:
        raise RuntimeError("LR sweep: the 64 MiB budget did not stream")
    reset_sweep_launches()
    t0 = time.time()
    p1s, p2s, smi = fast_lr_topk(sr_dist=SR_DIST, topk=1024, state=state)
    stream_s = time.time() - t0
    (k1s, k1s_by_bucket), (s1s, s1s_by_bucket), (k2s, _) = sweep_launches()

    same = canon_topk(pos1, pos2, mi) == canon_topk(p1s, p2s, smi)
    cache = state.slab_cache
    out.update(stream_prep_s=prep_s, stream_s=stream_s, stream_k1_launches=k1s,
               stream_k1_stage1_launches=s1s, stream_k2_launches=k2s,
               stream_uploads=cache.uploads,
               stream_hits=cache.hits, stream_equal=same)
    log(f"LR sweep streamed ({LR_STREAM_BUDGET} bytes: {cache.max_slabs} slabs,"
        f" panels of {state.panel}): prepared in {prep_s:.1f} s, one call"
        f" {stream_s:.3f} s, {cache.uploads} slab uploads, {cache.hits} hits;"
        f" K2 {k2s} launches, K1 stage-1 {s1s} {s1s_by_bucket}, K1 store {k1s};"
        f" top-1024 equal to the resident call's: {same}")
    if not same:
        raise RuntimeError("LR sweep: the streamed top-k differs from the resident one")
    if k2s != n22 or k1s or s1s + k2s != sum(tiles.values()):
        raise RuntimeError(f"LR sweep streamed: K2 {k2s}, K1 stage-1 {s1s},"
                           f" store {k1s} launches")
    del state
    torch.cuda.empty_cache()
    return out, (k1_by_bucket, s1_by_bucket), (k1s_by_bucket, s1s_by_bucket)


# --------------------------------------------------------------------------
# 6b. bench.py's pipeline and streaming legs
# --------------------------------------------------------------------------
def pipeline_leg_inputs(nsnp, nseq):
    """bench.py's `leg_pipeline` input: bench_synth(nsnp, nseq, seed=1) and
    a 3-cluster random paint (default_rng(2)) -> (SnpData, w, CdsVar)."""
    from ldweaver_tpu_torch.core.cds import CdsVar, Clusters

    sd, w = bench_snp_data(nsnp, nseq, seed=1)
    nclust = 3  # reference default num_clusts_CDS
    cds_var = CdsVar(
        var_estimate=np.zeros(1), cds_start=np.zeros(1, np.int64),
        cds_end=np.zeros(1, np.int64), clusts=Clusters(np.array([1]), 0.0),
        paint=np.random.default_rng(2).integers(1, nclust + 1, size=nsnp)
        .astype(np.int64),
        ref=np.array(["A"] * nsnp), alt=np.array([""] * nsnp),
        allele_table=sd.acgtn_table, nclust=nclust,
    )
    return sd, w, cds_var


def pipeline_leg(nsnp, nseq, block, device, out_dir):
    """bench.py's `leg_pipeline` in the port: `perform_mi_computation(
    backend="spmd")` on `pipeline_leg_inputs` -> {sr_links, lr_rows,
    wall_s, phases}."""
    from ldweaver_tpu_torch.core.sweep import perform_mi_computation

    sd, w, cds_var = pipeline_leg_inputs(nsnp, nseq)
    phases = {}
    lr_path = os.path.join(out_dir, "lr_links.tsv")
    t0 = time.time()
    links = perform_mi_computation(
        sd, w, cds_var, lr_save_path=lr_path,
        sr_save_path=os.path.join(out_dir, "sr_links.tsv"), plt_folder=None,
        sr_dist=SR_DIST, lr_retain_links=1e6, max_blk_sz=block, srp_cutoff=3.0,
        backend="spmd", verbose=False, phase_timings=phases, device=device,
    )
    wall = time.time() - t0
    with open(lr_path) as fh:
        lr_rows = sum(1 for _ in fh)
    return dict(sr_links=len(links), lr_rows=lr_rows, wall_s=wall, phases=phases)


def pipeline_leg_phase():
    """bench.py's pipeline leg at its size, 131,072 SNPs x 616 genomes,
    block 4096, on the card: the SR links and LR rows against the JAX
    package's recorded counts, within the reference's fringe."""
    import torch

    from ldweaver_tpu_torch.ops import rank_mi

    d = os.path.join(WORK, "pipeline_leg")
    os.makedirs(d)
    torch.cuda.empty_cache()
    rank_mi.K1.reset()
    res = pipeline_leg(HEADLINE_SNPS, S, B, "cuda", d)
    launches, by_bucket = rank_mi.K1.launches, dict(rank_mi.K1.by_bucket)
    spmd = res["phases"]["spmd"]
    sr_bound = fringe_bound(PIPE_SR_LINKS)
    lr_bound = fringe_bound(PIPE_LR_ROWS, LR_FRINGE_RATE)
    log(f"pipeline leg (bench synth 131,072 x 616, block 4096, spmd): wall"
        f" {res['wall_s']:.1f} s, SR pairs {spmd['sr_pairs']} (JAX record"
        f" {PIPE_SR_PAIRS}), SR links {res['sr_links']} (JAX record"
        f" {PIPE_SR_LINKS}, bound {sr_bound}), LR rows {res['lr_rows']} (JAX"
        f" record {PIPE_LR_ROWS}, bound {lr_bound}); K1 launches {launches}"
        f" {by_bucket}; blk5_phases {json.dumps(res['phases'])}")
    if spmd["tiles"] != E2E_TILES or launches < E2E_TILES or spmd["fallbacks"]:
        raise RuntimeError(f"pipeline leg: K1 launched {launches} times for"
                           f" {spmd['tiles']} tiles, {spmd['fallbacks']} fallbacks")
    if spmd["sr_pairs"] != PIPE_SR_PAIRS:
        raise RuntimeError(f"pipeline leg: {spmd['sr_pairs']} SR pairs, {PIPE_SR_PAIRS}"
                           f" recorded")
    if abs(res["sr_links"] - PIPE_SR_LINKS) > sr_bound:
        raise RuntimeError(f"pipeline leg: {res['sr_links']} SR links against the"
                           f" recorded {PIPE_SR_LINKS}")
    if abs(res["lr_rows"] - PIPE_LR_ROWS) > lr_bound:
        raise RuntimeError(f"pipeline leg: {res['lr_rows']} LR rows against the"
                           f" recorded {PIPE_LR_ROWS}")
    recorded = dict(sr_links=[res["sr_links"], PIPE_SR_LINKS],
                    lr_rows=[res["lr_rows"], PIPE_LR_ROWS], tiles=[spmd["tiles"], E2E_TILES],
                    sr_pairs=[spmd["sr_pairs"], PIPE_SR_PAIRS], wall_s=res["wall_s"],
                    blk5_phases=res["phases"])
    return by_bucket, recorded


STREAM_SNPS, STREAM_SEQS = 32768, 16384  # bench.py's streaming leg


def streaming_leg(nsnp, nseq, block, device, topk=1024):
    """bench.py's `leg_streaming` in the port, and the same sweep resident:
    `fast_lr_topk(topk)` on bench_synth(nsnp, nseq, seed=3) streamed
    through bench.py's budget, 0.75 of the slabs, so that the usable 60%
    holds fewer than all of them (one warm call, then one counted call), then
    resident -> dict with both top-k results, the counted call's uploads,
    hits and K1 / K2 launches, the slab plan, and on the card the device
    time split of one more streamed call (`device_time_split`)."""
    import torch

    from ldweaver_tpu_torch.parallel.fast_sweep import fast_lr_topk, prepare_fast_sweep

    sd, w = bench_snp_data(nsnp, nseq, seed=3)
    budget = int(nseq * block * 0.75 * -(-nsnp // block))
    out = dict(budget=budget, slab_bytes=nseq * block)
    t0 = time.time()
    state = prepare_fast_sweep(sd, w, block=block, hbm_budget_bytes=budget,
                               device=device)
    cache = state.slab_cache
    out.update(streaming=state.streaming, prep_s=time.time() - t0,
               max_slabs=cache.max_slabs if cache else None, panel=state.panel,
               pool_bytes=cache.pool.numel() if cache else None)
    if not state.streaming:
        return out
    t0 = time.time()
    fast_lr_topk(state=state, sr_dist=SR_DIST, topk=topk)
    out["warm_s"] = time.time() - t0
    u0, h0 = cache.uploads, cache.hits
    reset_sweep_launches()
    t0 = time.time()
    out["streamed"] = fast_lr_topk(state=state, sr_dist=SR_DIST, topk=topk)
    if device != "cpu":
        torch.cuda.synchronize()
    (k1, k1_by_bucket), (s1, s1_by_bucket), (k2, _) = sweep_launches()
    out.update(wall_s=time.time() - t0, uploads=cache.uploads - u0,
               hits=cache.hits - h0, k1_launches=k1, k1_by_bucket=k1_by_bucket,
               k1_stage1_launches=s1, k1_stage1_by_bucket=s1_by_bucket,
               k2_launches=k2, tiles={k: len(v) for k, v in state.buckets.items()})
    if device != "cpu":  # where a streamed call's time goes, on the card
        out["split"] = device_time_split(
            lambda: fast_lr_topk(state=state, sr_dist=SR_DIST, topk=topk))
    del state, cache
    if device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.time()
    state = prepare_fast_sweep(sd, w, block=block, device=device)
    out.update(resident_streaming=state.streaming,
               resident_pool_bytes=state.dev.codes.numel(),
               resident_prep_s=time.time() - t0)
    fast_lr_topk(state=state, sr_dist=SR_DIST, topk=topk)
    reset_sweep_launches()
    t0 = time.time()
    out["resident"] = fast_lr_topk(state=state, sr_dist=SR_DIST, topk=topk)
    if device != "cpu":
        torch.cuda.synchronize()
    (_, k1_by_bucket), (_, s1_by_bucket), (k2, _) = sweep_launches()
    out.update(resident_wall_s=time.time() - t0,
               resident_k1_by_bucket=k1_by_bucket,
               resident_k1_stage1_by_bucket=s1_by_bucket, resident_k2_launches=k2)
    return out


def streaming_leg_phase():
    """bench.py's streaming leg at its size, 32,768 SNPs x 16,384 genomes,
    block 4096, through 0.75 of its 8 slabs of 67.1 MB on the card: the
    run streams, its uploads are counted, and its top-1024 equals the
    resident run's apart from near-ties; then K1 at the leg's buckets and
    K2 at S = 16,384, each against its plain version."""
    t0 = time.time()
    res = streaming_leg(STREAM_SNPS, STREAM_SEQS, B, "cuda")
    log(f"streaming leg (bench synth 32,768 x 16,384, block 4096, top-k 1024):"
        f" {time.time() - t0:.1f} s in all, budget {res['budget']} bytes"
        f" ({res['slab_bytes']} a slab): streaming {res['streaming']},"
        f" {res['max_slabs']} slabs, panels of {res['panel']}, prepared in"
        f" {res['prep_s']:.1f} s")
    if not res["streaming"]:
        raise RuntimeError("streaming leg: the budget did not stream")
    one_side, diff = assert_topk_agree(res["resident"], res["streamed"], 1024)
    # the visiting order (bucket or panel) breaks exact ties: the same
    # pairs and values in one canonical order
    exact = canon_topk(*res["resident"]) == canon_topk(*res["streamed"])
    nb = STREAM_SNPS // B
    log(f"streaming leg: warm call {res['warm_s']:.2f} s, counted call"
        f" {res['wall_s']:.3f} s (device busy {res['split']['device_busy_s']:.3f} s"
        f" in a profiled call), {res['uploads']} slab uploads (JAX record"
        f" {STREAM_UPLOADS}), {res['hits']} hits; K2 {res['k2_launches']}"
        f" launches, K1 stage-1 {res['k1_stage1_launches']}"
        f" {res['k1_stage1_by_bucket']}, K1 store {res['k1_launches']}; tiles"
        f" {res['tiles']}; resident (pool {res['resident_pool_bytes']} bytes,"
        f" streaming {res['resident_streaming']}) call {res['resident_wall_s']:.3f} s;"
        f" top-1024 streamed vs resident: {one_side} pairs on one side only"
        f" (near-ties), MI max abs diff {diff:.2e}, the same pairs and values"
        f" {exact}; resident prepared in {res['resident_prep_s']:.1f} s")
    ntiles = sum(res["tiles"].values())
    # the slab plan and the panel order are host logic: the counted call
    # uploads what the JAX package's did (tests/test_torch_recorded_runs.py)
    # block 4096 > 1024: every K1 tile takes the stage-1 form
    if (res["uploads"] != STREAM_UPLOADS or res["k1_launches"]
            or res["k1_stage1_launches"] + res["k2_launches"] != ntiles):
        raise RuntimeError(f"streaming leg: {res['uploads']} uploads, K1 stage-1"
                           f" {res['k1_stage1_launches']} + K2 {res['k2_launches']}"
                           f" launches for {ntiles} tiles, K1 store {res['k1_launches']}")
    if res["resident_streaming"] or res["resident_pool_bytes"] != nb * res["slab_bytes"]:
        raise RuntimeError("streaming leg: the resident run does not hold its"
                           f" {nb} slabs on the card")
    # the kernels at the leg's depth: K1's two forms at its buckets, K2
    k1_rows = kernel_phase(STREAM_SEQS, LR_BUCKETS, 20261020)
    s1_rows = stage1_phase(STREAM_SEQS, LR_BUCKETS, 20261024)
    unmeasured = ((set(res["k1_by_bucket"]) - set(k1_rows))
                  | (set(res["k1_stage1_by_bucket"]) - set(s1_rows)))
    if unmeasured:
        raise RuntimeError(f"streaming leg: K1 launched in buckets not measured at"
                           f" S={STREAM_SEQS}: {sorted(unmeasured)}")
    k2_row = fused_phase(nseq=STREAM_SEQS)
    recorded = dict(uploads=[res["uploads"], STREAM_UPLOADS], streaming=res["streaming"],
                    wall_s=res["wall_s"], resident_wall_s=res["resident_wall_s"],
                    device_busy_s=res["split"]["device_busy_s"],
                    budget_bytes=res["budget"], slab_bytes=res["slab_bytes"],
                    one_side_near_ties=one_side, identical=exact)
    return k1_rows, s1_rows, k2_row, res, recorded


# --------------------------------------------------------------------------
# 7. the compat path
# --------------------------------------------------------------------------
def compat_phase():
    import torch

    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.ops import compat_mi

    d = os.path.join(WORK, "compat")
    os.makedirs(d)
    fa, pos, gbk, _ = synth_alignments(d, nseq=616, g=2_200_000, nsnp=8192, seed=2)
    dset = os.path.join(d, "ldw_out")
    compat_mi.K3.reset()
    t0 = time.time()
    ldweaver_tpu_torch.ldweaver(
        dset=dset, aln_path=fa, aln_has_all_bases=False, pos=pos,
        gbk_path=gbk, backend="pallas", max_blk_sz=4000,
        SnpEff_Annotate=False, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = compat_mi.K3.launches
    by_shape = dict(compat_mi.K3.by_bucket)
    timings = json.load(open(os.path.join(dset, "timings.json")))
    sr, lr = read_links(dset)
    check_tables(sr, lr)
    log(f"compat wall {wall:.1f} s; timings.json: {json.dumps(timings)}")
    log(f"compat: sr rows {len(sr)}, lr rows {len(lr)}, K3 launches {launches}"
        f" by tile shape {by_shape}")
    if launches < 6 or by_shape.get((K3_F, K3_F), 0) != 3:
        raise RuntimeError(f"K3 launched {launches} times ({by_shape}) for 6 tiles")
    return by_shape


# --------------------------------------------------------------------------
# 8. two ranks on the one card (torch.distributed on gloo)
# --------------------------------------------------------------------------
MULTI_SMALL = (("spmd_auto", "spmd", "auto"), ("spmd_part", "spmd", "part"),
               ("spmd_host", "spmd", "host"), ("fast", "fast", "auto"))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(job, argvs=None, timeout=900, sr_budget=MULTI_SR_BUDGET):
    """Start two processes (this script's `--multi-worker job rank port`
    by default, else `argvs[rank]` with the port filled in), both on
    cuda:0, joined over gloo, each with LDW_SR_BUDGET `sr_budget`; wait
    for both and fail unless both exit 0.  Each rank's output goes to
    WORK/multi/<job>_r<rank>.log."""
    d = os.path.join(WORK, "multi")
    os.makedirs(d, exist_ok=True)
    port = str(free_port())
    env = dict(os.environ, LDW_SR_BUDGET=str(sr_budget))
    procs, logs = [], []
    for rank in range(2):
        argv = ([sys.executable, os.path.abspath(__file__), "--multi-worker", job,
                 str(rank), port] if argvs is None
                else [a.replace("{port}", port) for a in argvs[rank]])
        logs.append(os.path.join(d, f"{job}_r{rank}.log"))
        with open(logs[-1], "wt") as fh:
            procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=fh,
                                          stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for rank, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(open(path).read()[-6000:])
            raise RuntimeError(f"multi {job}: rank {rank} exited {p.returncode}")
    return wall


def multi_worker(job, rank, port):
    """One of the two ranks of `launch_ranks`: the bring-up first, then
    the job's runs on cuda:0; its results into WORK/multi/<job>_r<rank>.json."""
    from ldweaver_tpu_torch.parallel.multihost import initialize_multihost

    initialize_multihost(f"localhost:{port}", 2, rank)
    import torch

    import ldweaver_tpu_torch
    from ldweaver_tpu_torch.ops import compat_mi, rank_mi
    from ldweaver_tpu_torch.parallel.fast_sweep import fast_lr_topk, prepare_fast_sweep
    from ldweaver_tpu_torch.parallel.sweep import sharded_lr_topk

    out = {}
    if job == "small":
        src = os.path.join(WORK, "small_spmd")
        pos = np.load(os.path.join(src, "pos.npy"))
        for tag, backend, mode in MULTI_SMALL:
            rank_mi.K1.reset()
            dset = os.path.join(WORK, "multi", "small", f"r{rank}", tag)
            ldweaver_tpu_torch.ldweaver(
                dset=dset, aln_path=os.path.join(src, "snps.fa.gz"),
                aln_has_all_bases=False, pos=pos,
                gbk_path=os.path.join(src, "ref.gbk"), backend=backend,
                max_blk_sz=1024, SnpEff_Annotate=False, lr_retain_links=20000,
                sr_reduce=mode, device_budget_bytes=MULTI_DEVICE_BUDGET,
                device="cuda:0",
            )
            out[tag] = dict(k1=rank_mi.K1.launches, blk5=json.load(open(
                os.path.join(dset, "timings.json")))["blk5_phases"][backend])
    elif job in ("big", "auto"):
        # the headline input, sr_reduce="part" ("big") or "auto"
        inputs = json.load(open(os.path.join(WORK, "headline", "inputs.json")))
        dset = os.path.join(WORK, "multi", "headline" if job == "big" else "auto",
                            f"r{rank}")
        rank_mi.K1.reset()
        t0 = time.time()
        ldweaver_tpu_torch.ldweaver(
            dset=dset, aln_path=inputs["fa"], aln_has_all_bases=False,
            pos=np.load(inputs["pos"]), gbk_path=inputs["gbk"], backend="spmd",
            max_blk_sz=4096, SnpEff_Annotate=False,
            sr_reduce="part" if job == "big" else "auto",
            device_budget_bytes=MULTI_DEVICE_BUDGET, device="cuda:0",
        )
        torch.cuda.synchronize()
        out["headline"] = dict(
            wall_s=time.time() - t0, k1=rank_mi.K1.launches,
            k1_by_bucket={str(k): v for k, v in rank_mi.K1.by_bucket.items()},
            timings=json.load(open(os.path.join(dset, "timings.json"))))
        torch.cuda.empty_cache()
    if job == "big":
        # the LR-only sweep of the lr phase, the tiles shared by the ranks
        sd, w = bench_snp_data(131072, 1024, seed=0)
        state = prepare_fast_sweep(sd, w, block=4096,
                                   hbm_budget_bytes=MULTI_DEVICE_BUDGET,
                                   device="cuda:0")
        reset_sweep_launches()
        t0 = time.time()
        p1, p2, mi = fast_lr_topk(sr_dist=SR_DIST, topk=1024, state=state)
        (k1, _), (s1, s1_by_bucket), (k2, _) = sweep_launches()
        out["lr"] = dict(wall_s=time.time() - t0, k1=k1, k1_stage1=s1, k2=k2,
                         k1_stage1_by_bucket={str(k): v for k, v in s1_by_bucket.items()})
        np.savez(os.path.join(WORK, "multi", f"lr_r{rank}.npz"), pos1=p1, pos2=p2, mi=mi)
        del state
        torch.cuda.empty_cache()
        # the sharded compat sweep through K3
        sd, w = bench_snp_data(SHARDED_SNPS, S, seed=6)
        compat_mi.K3.reset()
        t0 = time.time()
        res = sharded_lr_topk(sd, w, block=SHARDED_B, sr_dist=SR_DIST, topk=1024,
                              device="cuda:0")
        out["sharded"] = dict(wall_s=time.time() - t0, k3=compat_mi.K3.launches)
        np.savez(os.path.join(WORK, "multi", f"sharded_r{rank}.npz"),
                 **dict(zip(("pos1", "pos2", "mi", "hist"), res)))
    with open(os.path.join(WORK, "multi", f"{job}_r{rank}.json"), "wt") as fh:
        json.dump(out, fh)


def read_rank(job, rank):
    return json.load(open(os.path.join(WORK, "multi", f"{job}_r{rank}.json")))


def multi_small_phase():
    """Two ranks on cuda:0 over gloo on the small input: spmd with
    sr_reduce auto, part and host, and fast; every rank's TSVs
    byte-identical to the card's single-process run (small_phase's)."""
    import torch

    torch.cuda.empty_cache()
    wall = launch_ranks("small")
    ref = {"spmd": os.path.join(WORK, "small_spmd", "cuda"),
           "fast": os.path.join(WORK, "small_fast", "cuda")}
    same, k1 = {}, 0
    for rank in range(2):
        got = read_rank("small", rank)
        for tag, backend, mode in MULTI_SMALL:
            st = got[tag]["blk5"]
            dset = os.path.join(WORK, "multi", "small", f"r{rank}", tag)
            same[rank, tag] = all(tsv_bytes(dset, n) == tsv_bytes(ref[backend], n)
                                  for n in ("sr_links.tsv", "lr_links.tsv"))
            want = {"auto": "device", "part": "device-part", "host": "host"}[mode]
            if st["shards"] != 2 or st["rank"] != rank or st["sr_reduce"] != want:
                raise RuntimeError(f"multi small {tag} rank {rank}: {st}")
            # the small input's SR records (~15 MB) fit the range budget
            # at partition_plan's first split
            if mode == "part" and (st["sr_partitions"] != 2
                                   or st["range_mb"] * 1e6 > st["range_budget"]):
                raise RuntimeError(f"multi small {tag}: {st['sr_partitions']} k2"
                                   f" ranges, {st['range_mb']} MB the largest of"
                                   f" {st['range_budget']} bytes")
            k1 += got[tag]["k1"]
    log(f"multi small (two ranks on cuda:0, {wall:.1f} s): byte-identical to the"
        f" single-process card runs {dict((f'r{r}/{t}', v) for (r, t), v in same.items())};"
        f" K1 launches of both ranks {k1}")
    if not all(same.values()):
        raise RuntimeError("multi small: a rank's TSVs differ from the single-process run's")


def multi_cli_phase():
    """The CLI with --num-processes 2 --device cuda:0 --backend spmd on the
    small input: both ranks' TSVs byte-identical to cli_phase's run."""
    d = os.path.join(WORK, "cli")
    argvs = [[sys.executable, "-m", "ldweaver_tpu_torch.cli", "run", "--dset",
              os.path.join(d, f"multi_r{rank}"), "--aln",
              os.path.join(d, "snps.fa.gz"), "--pos", os.path.join(d, "snps.pos"),
              "--gbk", os.path.join(d, "ref.gbk"), "--device", "cuda:0",
              "--backend", "spmd", "--max-blk-sz", "1024", "--lr-retain-links",
              "20000", "--coordinator", "localhost:{port}", "--num-processes",
              "2", "--process-id", str(rank)] for rank in range(2)]
    wall = launch_ranks("cli", argvs)
    same = {}
    for rank in range(2):
        dset = os.path.join(d, f"multi_r{rank}")
        spmd = json.load(open(os.path.join(dset, "timings.json")))["blk5_phases"]["spmd"]
        if spmd["shards"] != 2 or spmd["rank"] != rank:
            raise RuntimeError(f"multi cli rank {rank}: {spmd}")
        for n in ("sr_links.tsv", "lr_links.tsv"):
            same[f"r{rank}/{n}"] = tsv_bytes(dset, n) == tsv_bytes(
                os.path.join(d, "out_spmd"), n)
    log(f"multi cli (--num-processes 2 --device cuda:0, {wall:.1f} s):"
        f" byte-identical to the single-process CLI run {same}")
    if not all(same.values()):
        raise RuntimeError("multi cli: a rank's TSVs differ from the single-process run's")


def multi_big_phase(inputs):
    """Two ranks on cuda:0: the headline (616 x 131,072, BLK1-BLK7,
    sr_reduce="part", LDW_SR_BUDGET 1 GiB a rank: the flat arrays alone
    exceed it, so the range budget is sr_reduce.PART_RANGE_MIN and the
    grid splits into more than 2 k2 ranges), the LR-only sweep at 1024 x
    131,072 and the sharded sweep through K3.  Each rank's headline TSVs
    byte-identical to the headline phase's tables, its BLK5 peak within its
    peak after the tiles plus `sr_reduce.part_peak_bytes` of its kept
    pairs, its top-1024 equal to the lr phase's resident call, its
    sharded result equal to the single-process one (sharded_phase)."""
    import torch

    from ldweaver_tpu_torch.parallel import sr_reduce

    torch.cuda.empty_cache()
    wall = launch_ranks("big")
    res = {"wall_s": wall}
    by_bucket, lr_by_bucket = {}, {}
    k1_lr = s1_lr = k2_lr = k3 = 0
    ref = np.load(os.path.join(WORK, "lr_resident.npz"))
    ref_sh = np.load(os.path.join(WORK, "sharded_single.npz"))
    for rank in range(2):
        got = read_rank("big", rank)
        h = got["headline"]
        spmd = h["timings"]["blk5_phases"]["spmd"]
        dset = os.path.join(WORK, "multi", "headline", f"r{rank}")
        same = {n: tsv_bytes(dset, n) == tsv_bytes(inputs["tables"], n)
                for n in ("sr_links.tsv", "lr_links.tsv")}
        for k, v in h["k1_by_bucket"].items():
            by_bucket[k] = by_bucket.get(k, 0) + v
        for k, v in got["lr"]["k1_stage1_by_bucket"].items():
            lr_by_bucket[k] = lr_by_bucket.get(k, 0) + v
        k1_lr += got["lr"]["k1"]
        s1_lr += got["lr"]["k1_stage1"]
        k2_lr += got["lr"]["k2"]
        k3 += got["sharded"]["k3"]
        lr = np.load(os.path.join(WORK, "multi", f"lr_r{rank}.npz"))
        lr_equal = all(np.array_equal(lr[k], ref[k]) for k in ("pos1", "pos2", "mi"))
        sh = np.load(os.path.join(WORK, "multi", f"sharded_r{rank}.npz"))
        sh_equal = all(np.array_equal(sh[k], ref_sh[k]) for k in sh.files)
        res[f"r{rank}"] = dict(
            wall_s=h["wall_s"], blk5_s=h["timings"]["blk5_mi_computation"],
            blocks={k: v for k, v in h["timings"].items()
                    if k.startswith("blk") and k != "blk5_phases"},
            blk5=blk5_split(h["timings"]), k1=h["k1"], tiles=spmd["tiles"],
            sr_partitions=spmd.get("sr_partitions"), range_mb=spmd.get("range_mb"),
            range_budget=spmd.get("range_budget"),
            model_bytes=sr_reduce.part_peak_bytes(spmd["sr_pairs"],
                                                  spmd.get("range_budget", 0)),
            gather_s=spmd["gather_s"], gather_bytes=spmd["gather_bytes"],
            peak_bytes=spmd["peak_bytes"], peak_tiles_bytes=spmd["peak_tiles_bytes"],
            sr_pairs_on_rank=spmd["sr_pairs"], cand_count=spmd.get("cand_count"),
            tsv_byte_identical=same, lr_wall_s=got["lr"]["wall_s"],
            lr_k1=got["lr"]["k1"], lr_k1_stage1=got["lr"]["k1_stage1"],
            lr_k2=got["lr"]["k2"], lr_topk_equal=lr_equal,
            sharded_wall_s=got["sharded"]["wall_s"], sharded_k3=got["sharded"]["k3"],
            sharded_equal=sh_equal)
        log(f"multi headline rank {rank}: {json.dumps(res[f'r{rank}'])}")
        r = res[f"r{rank}"]
        if (spmd["sr_reduce"] != "device-part" or spmd["sr_partitions"] <= 2
                or spmd["range_budget"] != sr_reduce.PART_RANGE_MIN):
            raise RuntimeError(f"multi headline rank {rank}: not partitioned by"
                               f" the range budget's floor: {spmd}")
        if r["peak_bytes"] > r["peak_tiles_bytes"] + r["model_bytes"]:
            raise RuntimeError(f"multi headline rank {rank}: BLK5 peak over the"
                               f" part model: {r}")
        if not all(same.values()):
            raise RuntimeError(f"multi headline rank {rank}: TSVs differ from the headline's")
        if spmd["shards"] != 2 or spmd["tiles"] != 264 or h["k1"] < 264:
            raise RuntimeError(f"multi headline rank {rank}: {spmd['tiles']} tiles,"
                               f" K1 {h['k1']}")
        if not lr_equal or not sh_equal:
            raise RuntimeError(f"multi rank {rank}: the LR top-1024 ({lr_equal}) or the"
                               f" sharded result ({sh_equal}) differs from one process's")
    log(f"multi lr: K1 stage-1 {s1_lr}, K1 store {k1_lr} and K2 {k2_lr} launches"
        f" over the two ranks; multi sharded: K3 {k3}")
    if (s1_lr, k1_lr, k2_lr) != (150, 0, 378):
        raise RuntimeError(f"multi lr: K1 stage-1 {s1_lr}, K1 store {k1_lr}, K2"
                           f" {k2_lr} launches (150, 0, 378 expected)")
    n_sh = SHARDED_SNPS // SHARDED_B
    if k3 != n_sh * (n_sh + 1) // 2:
        raise RuntimeError(f"multi sharded: K3 launched {k3} times")
    return ({eval(k): v for k, v in by_bucket.items()},
            {eval(k): v for k, v in lr_by_bucket.items()}, k2_lr, k3)


def multi_auto_phase(inputs, sr_pairs):
    """Two ranks on cuda:0: the headline (BLK1-BLK7) under
    sr_reduce="auto", with an LDW_SR_BUDGET a rank between what the
    partitioned pass needs and what the single-device reduction needs of
    the `sr_pairs` kept pairs: `sr_reduce.part_peak_bytes` of a shard
    holding all of them at the largest range budget bounds the first,
    `sr_reduce.flat_peak_bytes` of the whole table is the second.  Both
    ranks must take "part", each rank's peak stay within the part model,
    and its TSVs be byte-identical to the headline phase's tables."""
    import torch

    from ldweaver_tpu_torch.parallel import sr_reduce as sr

    part = sr.part_peak_bytes(sr_pairs, sr.PART_RANGE_MAX)
    flat = sr.flat_peak_bytes(sr_pairs)
    budget = (part + flat) // 2
    log(f"multi auto: LDW_SR_BUDGET {budget} bytes a rank, between the part"
        f" model's {part} and the flat model's {flat} for {sr_pairs} pairs")
    if not part < budget < flat:
        raise RuntimeError("multi auto: no budget between the part and flat models")
    torch.cuda.empty_cache()
    wall = launch_ranks("auto", sr_budget=budget)
    res = {"wall_s": wall, "sr_budget": budget}
    for rank in range(2):
        h = read_rank("auto", rank)["headline"]
        spmd = h["timings"]["blk5_phases"]["spmd"]
        dset = os.path.join(WORK, "multi", "auto", f"r{rank}")
        same = {n: tsv_bytes(dset, n) == tsv_bytes(inputs["tables"], n)
                for n in ("sr_links.tsv", "lr_links.tsv")}
        model = sr.part_peak_bytes(spmd["sr_pairs"], spmd.get("range_budget", 0))
        res[f"r{rank}"] = dict(
            wall_s=h["wall_s"], blk5_s=h["timings"]["blk5_mi_computation"],
            sr_reduce=spmd["sr_reduce"], sr_partitions=spmd.get("sr_partitions"),
            range_budget=spmd.get("range_budget"), sr_pairs_on_rank=spmd["sr_pairs"],
            model_bytes=model, peak_bytes=spmd["peak_bytes"],
            peak_tiles_bytes=spmd["peak_tiles_bytes"], bg_stats_s=spmd.get("bg_stats_s"),
            gather_s=spmd["gather_s"], k1=h["k1"], tsv_byte_identical=same)
        log(f"multi auto rank {rank}: {json.dumps(res[f'r{rank}'])}")
        if spmd["sr_reduce"] != "device-part" or spmd["shards"] != 2:
            raise RuntimeError(f"multi auto rank {rank}: the SR table reduced on the"
                               f" {spmd['sr_reduce']} over {spmd['shards']} shards")
        if model > budget or spmd["peak_bytes"] > spmd["peak_tiles_bytes"] + model:
            raise RuntimeError(f"multi auto rank {rank}: over the part model: {res}")
        if not all(same.values()):
            raise RuntimeError(f"multi auto rank {rank}: TSVs differ from the headline's")
        if spmd["tiles"] != 264 or h["k1"] < 264:
            raise RuntimeError(f"multi auto rank {rank}: {spmd['tiles']} tiles, K1 {h['k1']}")
    return res


def sharded_phase():
    """`parallel/sweep.sharded_lr_topk` (K3 on every 512 x 512 tile) in
    one process on the card at 616 genomes x 8,192 SNPs (136 tiles), saved
    for the two-rank run; and card against CPU (plain versions) at 64 x
    2,048."""
    import torch

    from ldweaver_tpu_torch.ops import compat_mi
    from ldweaver_tpu_torch.parallel.sweep import sharded_lr_topk

    sd, w = bench_snp_data(2048, 64, seed=7)
    kw = dict(block=SHARDED_B, sr_dist=SR_DIST, topk=1024)
    card = sharded_lr_topk(sd, w, device="cuda", **kw)
    cpu = sharded_lr_topk(sd, w, device="cpu", **kw)
    kc = dict(zip(zip(card[0].tolist(), card[1].tolist()), card[2].tolist()))
    kp = dict(zip(zip(cpu[0].tolist(), cpu[1].tolist()), cpu[2].tolist()))
    kth = min(card[2][-1], cpu[2][-1])
    far = [k for k in set(kc) ^ set(kp) if kc.get(k, kp.get(k)) - kth > NEAR_TIE]
    diff = max(abs(kc[k] - kp[k]) for k in set(kc) & set(kp))
    hist_diff = int(np.abs(card[3].astype(np.int64) - cpu[3]).sum())
    log(f"sharded sweep, card vs CPU (64 x 2,048): {len(set(kc) ^ set(kp))} pairs on"
        f" one side only ({len(far)} beyond a near-tie), MI max abs diff {diff:.2e},"
        f" histogram |diff| {hist_diff} of {int(cpu[3].sum())}")
    if far or diff > 1.2e-4 or hist_diff > 2:
        raise RuntimeError("sharded sweep: card and CPU disagree")
    sd, w = bench_snp_data(SHARDED_SNPS, S, seed=6)
    compat_mi.K3.reset()
    t0 = time.time()
    res = sharded_lr_topk(sd, w, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = compat_mi.K3.launches
    np.savez(os.path.join(WORK, "sharded_single.npz"),
             **dict(zip(("pos1", "pos2", "mi", "hist"), res)))
    log(f"sharded sweep ({S} x {SHARDED_SNPS}, block {SHARDED_B}, one process):"
        f" {wall:.2f} s, K3 {launches} launches, top MI {res[2][0]:.6f}, k-th"
        f" {res[2][-1]:.6f}, SR histogram total {int(res[3].sum())}")
    if not (res[2].size == 1024 and np.isfinite(res[2]).all()):
        raise RuntimeError("sharded sweep: malformed top-k")
    return launches


PART_PAIRS = 32 << 20  # the footprint phases' shard: a 512 MiB range buffer


def device_mem(device, peak=False):
    """Bytes allocated on `device` now (or at their peak since the last
    reset); 0 off a card."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) if peak
            else torch.cuda.memory_allocated(device))


def reset_peak(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def footprint_shard(n, device, nclust, seed):
    """The footprint phases' synthetic shard: 16,384 distinct positions
    within SR_DIST of each other over 4 blocks of B, painted into `nclust`
    clusters, and the kept SR outputs (bi, bj, i32 index, f32 MI) of
    n // 2^19 tiles of 2^19 pairs, nearly every pair live.  Returns pos,
    paint, the segments, their pair count and the bytes allocated before
    the segments were made."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    nb = 4
    pos = (torch.randperm(nb * B, generator=gen, device=device) + 1).to(torch.int32)
    paint = torch.randint(1, nclust + 1, (nb * B,), generator=gen, device=device,
                          dtype=torch.int32)
    tiles = [(i, j) for i in range(nb) for j in range(i, nb)]
    per = 1 << 19
    base = device_mem(device)
    segs = []
    for k in range(n // per):
        idx = torch.randint(0, B * B, (per,), generator=gen, device=device,
                            dtype=torch.int32)
        vals = torch.rand(per, generator=gen, device=device) * 0.99 + 0.01
        segs.append((*tiles[k % len(tiles)], idx, vals))
    return pos, paint, segs, per * (n // per), base


def part_footprint(n, device, nclust=8, seed=11):
    """Device bytes of the partitioned SR reduction's passes on one shard
    of n kept pairs (`footprint_shard`): the flattening, one k2 range
    holding every record (the shard's records and the copy that one
    process gathers) and the candidates.  Returns the bytes a pair of the
    passes over the shard and of the flat arrays, the range buffer's bytes
    and its pass's bytes over the flat arrays (memory statistics only on a
    card)."""
    from ldweaver_tpu_torch.parallel import sr_reduce as sr

    pos, paint, segs, n, base = footprint_shard(n, device, nclust, seed)
    reset_peak(device)
    flat = sr.flat_segments(segs, pos, paint, B, G, SR_DIST)
    segs.clear()
    flatten = device_mem(device, True) - base
    resident = device_mem(device) - base
    count = int(flat.live.sum())  # all but a site's pair with itself
    reset_peak(device)
    before = device_mem(device)
    ns, xlo, xhi, range_bytes = sr.part_group_stats(
        [flat], np.array([1, 2 * SR_DIST]), np.array([[count]]), 0, SR_DIST, nclust)
    range_pass = device_mem(device, True) - before
    T = sr.threshold_tables(sr.fits_from_group_stats(ns, xlo, xhi, SR_DIST),
                            nclust, SR_DIST)
    reset_peak(device)
    gi, _, _ = sr.candidates(flat, T, SR_DIST, nclust)
    cand = device_mem(device, True) - base
    return dict(pairs=n, candidates=int(gi.size), pass_bytes_a_pair=max(flatten, cand) / n,
                flatten_bytes_a_pair=flatten / n, candidates_bytes_a_pair=cand / n,
                flat_bytes_a_pair=resident / n, range_bytes=range_bytes,
                range_pass_bytes=range_pass, range_factor=range_pass / range_bytes)


def part_footprint_phase():
    """`sr_reduce.part_peak_bytes` against the card: the footprint of the
    partitioned pass's shard at PART_PAIRS kept pairs (a range buffer of
    sr_reduce.PART_RANGE_MAX) and at a quarter of them.  Fails when a
    measured term exceeds the model's constant."""
    import torch

    from ldweaver_tpu_torch.parallel import sr_reduce as sr

    out = []
    for n in (PART_PAIRS, PART_PAIRS // 4):
        torch.cuda.empty_cache()
        got = part_footprint(n, "cuda")
        log(f"part footprint ({n} pairs): {json.dumps(got)}")
        out.append(got)
        if got["range_bytes"] > sr.PART_RANGE_MAX:
            raise RuntimeError("part footprint: the range buffer outgrew PART_RANGE_MAX")
        over = [k for k, lim in (("pass_bytes_a_pair", sr.PART_PASS_BYTES),
                                 ("flat_bytes_a_pair", sr.PART_PAIR_BYTES),
                                 ("range_factor", sr.PART_RANGE_FACTOR))
                if got[k] > lim]
        if over:
            raise RuntimeError(f"part footprint over the model's constants: {over}")
    return out


def flat_footprint(n, device, nclust=8, seed=11):
    """Device bytes of the single-device SR reduction on n kept pairs
    (`footprint_shard`), the passes run as `run_device_reduction` runs
    them: the flattening, pass 1 (`group_stats`: the i64 keys and one sort
    a cluster), the host fits and pass 2 (`candidates`).  Each pass's peak
    counts from before the segments were made, so the kept pairs, which
    stay on the card through the reduction, are in it.  Returns the bytes
    a pair of each pass and of the whole (memory statistics only on a
    card)."""
    from ldweaver_tpu_torch.parallel import sr_reduce as sr

    pos, paint, segs, n, base = footprint_shard(n, device, nclust, seed)
    reset_peak(device)
    flat = sr.flat_segments(segs, pos, paint, B, G, SR_DIST)
    flatten = device_mem(device, True) - base
    reset_peak(device)
    ns, xlo, xhi = sr.group_stats(flat, SR_DIST, nclust)
    stats = device_mem(device, True) - base
    T = sr.threshold_tables(sr.fits_from_group_stats(ns, xlo, xhi, SR_DIST),
                            nclust, SR_DIST)
    reset_peak(device)
    gi, _, _ = sr.candidates(flat, T, SR_DIST, nclust)
    cand = device_mem(device, True) - base
    return dict(pairs=n, clusters=nclust, candidates=int(gi.size),
                pass_bytes_a_pair=max(flatten, stats, cand) / n,
                flatten_bytes_a_pair=flatten / n, stats_bytes_a_pair=stats / n,
                candidates_bytes_a_pair=cand / n)


FLAT_SHAPES = ((PART_PAIRS, 8), (PART_PAIRS // 4, 8), (PART_PAIRS // 4, 2))


def flat_footprint_phase():
    """`sr_reduce.flat_peak_bytes` against the card: the single-device
    reduction's footprint at PART_PAIRS kept pairs and at a quarter of
    them (the sort's scratch space grows with n) over 8 clusters, and at
    the quarter over 2 (the per-cluster loop must not grow the peak).
    Fails when a measurement exceeds sr_reduce.FLAT_PASS_BYTES."""
    import torch

    from ldweaver_tpu_torch.parallel import sr_reduce as sr

    out = []
    for n, nclust in FLAT_SHAPES:
        torch.cuda.empty_cache()
        got = flat_footprint(n, "cuda", nclust)
        log(f"flat footprint ({n} pairs, {nclust} clusters): {json.dumps(got)}")
        out.append(got)
    log(f"flat footprint at {PART_PAIRS // 4} pairs, 8 clusters against 2:"
        f" {out[1]['pass_bytes_a_pair'] - out[2]['pass_bytes_a_pair']:+.4f} bytes"
        f" a pair; largest {max(g['pass_bytes_a_pair'] for g in out):.4f},"
        f" FLAT_PASS_BYTES {sr.FLAT_PASS_BYTES}")
    over = [g for g in out if g["pass_bytes_a_pair"] > sr.FLAT_PASS_BYTES]
    if over:
        raise RuntimeError(f"flat footprint over FLAT_PASS_BYTES: {over}")
    return out


# --------------------------------------------------------------------------
# 9. the weight-term count
# --------------------------------------------------------------------------
TERMS = (1, 2)  # the counts below the default three that the phase checks
# K1's buckets at the LR sweep's S = 1024, with the (2,2) pure bucket that
# K2 takes in the sweep
TERMS_K1_BUCKETS = [(2, 2, True)] + LR_BUCKETS
TERMS_K3_SHAPES = ((K3_F, K3_F, K3_F), (SHARDED_B, SHARDED_B, K3_F))


def assert_topk_agree(ref, got, k):
    """tests/test_torch_lr_sweep.py's rule: k pairs each, MI descending;
    pairs on one side only within NEAR_TIE of the k-th value, common pairs'
    MI within rtol 2e-4, atol 2e-5, the same order apart from swaps of
    near-tied neighbours."""
    (p1r, p2r, mr), (p1g, p2g, mg) = ref, got
    if mr.size != k or mg.size != k or not np.all(np.diff(mg) <= 0):
        raise RuntimeError("top-k: malformed")
    kr = list(zip(p1r.tolist(), p2r.tolist()))
    kg = list(zip(p1g.tolist(), p2g.tolist()))
    vr, vg = dict(zip(kr, mr)), dict(zip(kg, mg))
    kth = min(mr[-1], mg[-1])
    far = [p for p in set(kr) ^ set(kg) if vr.get(p, vg.get(p)) - kth > NEAR_TIE]
    common = sorted(set(kr) & set(kg))
    a = np.array([vr[p] for p in common], np.float64)
    b = np.array([vg[p] for p in common], np.float64)
    swaps = [i for i, (x, y) in enumerate(zip(kr, kg))
             if x != y and abs(float(mr[i]) - float(mg[i])) > NEAR_TIE]
    if far or swaps or not np.allclose(b, a, rtol=RTOL_F64, atol=ATOL_F64):
        raise RuntimeError(f"top-k disagree: {len(far)} pairs beyond a near-tie,"
                           f" {len(swaps)} order swaps, MI max abs diff"
                           f" {np.abs(a - b).max():.2e}")
    return len(set(kr) ^ set(kg)), float(np.abs(a - b).max())


def terms_phase():
    """The weight-term count t = 1, 2 (`precision_terms` / `n_terms`; three,
    the default, is every other phase's): K1 at the LR sweep's buckets at
    S = 1024, K2 at 4096^2 x 1024 and K3 at 4000^2 and 512^2 x 616, each
    against its plain version at the same t on the card; the host-facing
    `mi_tile_rank_pallas`, `mi_tile_rank` and `mi_tile_pallas` at 512^2 x
    616, card against CPU; `fast_lr_topk(precision_terms=t)` at 256 genomes
    x 16,384 SNPs, block 2048, card against CPU; then the sweep leg's shape
    (1024 x 131,072, block 4096, top-k 1024), resident, at t = 1, 2 and 3:
    median wall of 5 calls, pairs/s, K1 and K2 launches, device time."""
    import torch

    from ldweaver_tpu_torch.ops import compat_mi, rank_mi
    from ldweaver_tpu_torch.parallel.fast_sweep import (
        fast_lr_topk,
        mi_tile_rank,
        prepare_fast_sweep,
    )

    rows = {}
    for t in TERMS:
        rows[t] = dict(
            k1=kernel_phase(K2_S, TERMS_K1_BUCKETS, 20261019, terms=t),
            k1s1=stage1_phase(K2_S, LR_BUCKETS, 20261025, terms=t),
            k2=fused_phase(terms=t),
            k3=compat_kernel_phase(TERMS_K3_SHAPES, terms=t),
        )

    # the host-facing tiles, card against CPU (the plain versions)
    rng = np.random.default_rng(7)
    n = SHARDED_B
    codes_np, rf_np, rt_np, w = bucket_inputs(rng, 2, 3, False, S)
    cf = np.ascontiguousarray(codes_np[:, :n].T)
    ct = np.ascontiguousarray(codes_np[:, B : B + n].T)
    rank_args = (cf, ct, w, rf_np[:n], rt_np[:n], float(w.sum()))
    ccodes, _, uqe, r, cw, _ = bench_synth(2 * n, S, seed=9)
    compat_args = (np.ascontiguousarray(ccodes[:, :n].T),
                   np.ascontiguousarray(ccodes[:, n:].T), cw, r[:n], r[n:],
                   uqe[:n], uqe[n:], float(cw.sum()))
    for t in TERMS:
        compat_mi.K3.reset()
        got = {dev: (rank_mi.mi_tile_rank_pallas(*rank_args, n_terms=t, device=dev),
                     mi_tile_rank(*rank_args, precision_terms=t, device=dev),
                     compat_mi.mi_tile_pallas(*compat_args, n_terms=t, device=dev))
               for dev in ("cuda", "cpu")}
        rows[t]["k3_host_launches"] = compat_mi.K3.launches
        errs = [float(np.abs(a - b).max()) for a, b in zip(got["cuda"], got["cpu"])]
        log(f"host-facing tiles t={t} ({n}^2 x {S}), max|card-CPU|:"
            f" mi_tile_rank_pallas {errs[0]:.2e}, mi_tile_rank {errs[1]:.2e},"
            f" mi_tile_pallas {errs[2]:.2e}")
        if max(errs) > ATOL_PLAIN or not all(np.isfinite(a).all() for a in got["cuda"]):
            raise RuntimeError(f"host-facing tiles at t={t}: card and CPU disagree")

    # the LR-only sweep, card against CPU, at a small size
    sd, w = bench_snp_data(16384, 256, seed=6)
    for t in TERMS:
        res = {dev: fast_lr_topk(sd, w, block=2048, sr_dist=SR_DIST, topk=1024,
                                 precision_terms=t, device=dev)
               for dev in ("cuda", "cpu")}
        one_side, diff = assert_topk_agree(res["cpu"], res["cuda"], 1024)
        log(f"LR sweep t={t}, card vs CPU (256 x 16,384, block 2048, top-k 1024):"
            f" {one_side} pairs on one side only (near-ties), MI max abs diff"
            f" {diff:.2e}")

    # the sweep leg at t = 1, 2, 3 from one prepared state
    sd, w = bench_snp_data(131072, 1024, seed=0)
    state = prepare_fast_sweep(sd, w, block=4096, device="cuda")
    tiles = {k: len(v) for k, v in state.buckets.items()}
    n22 = tiles.get((2, 2, True), 0)
    pairs = sd.nsnp * (sd.nsnp - 1) // 2
    sweep = {}
    for t in (1, 2, 3):
        fast_lr_topk(sr_dist=SR_DIST, topk=1024, precision_terms=t, state=state)
        walls = []
        for _ in range(5):
            reset_sweep_launches()
            t0 = time.time()
            pos1, pos2, mi = fast_lr_topk(sr_dist=SR_DIST, topk=1024,
                                          precision_terms=t, state=state)
            walls.append(time.time() - t0)
            (k1, k1_by_bucket), (s1, s1_by_bucket), (k2, _) = sweep_launches()
            if not (mi.size == 1024 and np.isfinite(mi).all()
                    and np.all(np.diff(mi) <= 0) and (pos1 != pos2).all()):
                raise RuntimeError(f"LR sweep t={t}: malformed top-k")
            if k2 != n22 or k1 or s1 + k2 != sum(tiles.values()):
                raise RuntimeError(f"LR sweep t={t}: K2 {k2} launches for {n22}"
                                   f" (2,2,pure) tiles, K1 stage-1 {s1}, store {k1}")
        median = float(np.median(walls))
        busy = device_time_split(lambda: fast_lr_topk(
            sr_dist=SR_DIST, topk=1024, precision_terms=t, state=state))
        sweep[t] = dict(walls_s=walls, median_s=median, pairs_per_s=pairs / median,
                        k1_launches=k1, k1_by_bucket=k1_by_bucket,
                        k1_stage1_launches=s1, k1_stage1_by_bucket=s1_by_bucket,
                        k2_launches=k2,
                        top_mi=float(mi[0]), kth_mi=float(mi[-1]), **busy)
        log(f"LR sweep t={t} (131,072 SNPs x 1024 genomes, block 4096, top-k 1024):"
            f" timed {[round(x, 3) for x in walls]} s, median {median:.3f} s ="
            f" {pairs / median:.4g} pairs/s; K2 {k2} launches, K1 stage-1 {s1}"
            f" {s1_by_bucket}, K1 store {k1}; device busy {busy['device_busy_s']:.3f} s ="
            f" {100 * busy['device_busy_s'] / median:.0f}% of the median wall"
            f" (summed {busy['device_summed_s']:.3f} s), share of the summed"
            f" time {busy['device_share']}")
    del state
    torch.cuda.empty_cache()
    log("terms sweep: " + json.dumps({
        t: {k: v for k, v in r.items() if not k.endswith("by_bucket")}
        for t, r in sweep.items()}))
    return rows, sweep


def one_card_phase():
    """n_devices=2 on the one card raises ValueError, before any work."""
    from ldweaver_tpu_torch.parallel.fast_sweep import fast_lr_topk
    from ldweaver_tpu_torch.support import resolve_devices

    sd, w = bench_snp_data(1024, 16, seed=1)
    for call in (lambda: resolve_devices("cuda", 2),
                 lambda: fast_lr_topk(sd, w, block=512, n_devices=2, device="cuda")):
        try:
            call()
        except ValueError as e:
            log(f"n_devices=2 on one card: ValueError: {e}")
        else:
            raise RuntimeError("n_devices=2 on one card did not raise")


LINE_KEYS = ("n_terms", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "bound_frac", "library_ms")


def k1_line(row, launches, **extra):
    """K1's entry of the kernels line (names carry t below three)."""
    t = "" if row["n_terms"] == 3 else f",t={row['n_terms']}"
    return dict(
        name=(f"rank_mi_tile[Rf={row['Rf']},Rt={row['Rt']},"
              f"{'pure' if row['pure'] else 'general'},S={row['S']}{t}]"),
        route="cuda", source="ldweaver_tpu_torch/csrc/rank_mi.cu",
        replaces=("ldweaver_tpu/parallel/fast_sweep.py:223" if row["pure"]
                  else "ldweaver_tpu/ops/pallas_rank_mi.py:23"),
        launches=launches, **{k: row[k] for k in LINE_KEYS}, **extra)


def s1_line(row, launches, **extra):
    """The entry of K1's LR stage-1 form (`rank_mi_stage1`), with its
    store-form-and-torch-ops time beside it."""
    t = "" if row["n_terms"] == 3 else f",t={row['n_terms']}"
    return dict(
        name=(f"rank_mi_stage1[Rf={row['Rf']},Rt={row['Rt']},"
              f"{'pure' if row['pure'] else 'general'},S={row['S']}{t}]"),
        route="cuda", source="ldweaver_tpu_torch/csrc/rank_mi.cu",
        replaces="ldweaver_tpu/parallel/fast_sweep.py:280", launches=launches,
        **{k: row[k] for k in LINE_KEYS}, stored_ms=row["stored_ms"], **extra)


def k2_line(row, launches, **extra):
    t = "" if row["n_terms"] == 3 else f",t={row['n_terms']}"
    return dict(
        name=f"fused_tile_stage1[Rf=2,Rt=2,pure,S={row['S']}{t}]", route="cuda",
        source="ldweaver_tpu_torch/csrc/fused_tile.cu",
        replaces="ldweaver_tpu/ops/pallas_fused_tile.py:42",
        launches=launches, **{k: row[k] for k in LINE_KEYS}, **extra)


def k3_line(row, F, T, launches, **extra):
    t = "" if row["n_terms"] == 3 else f",t={row['n_terms']}"
    return dict(
        name=f"compat_mi_tile[{F}x{T},S={S}{t}]", route="cuda",
        source="ldweaver_tpu_torch/csrc/compat_mi.cu",
        replaces="ldweaver_tpu/ops/pallas_mi.py:28",
        launches=launches, **{k: row[k] for k in LINE_KEYS}, **extra)


def timed(name, fn, *args):
    """Run one phase and log its wall time."""
    t0 = time.time()
    out = fn(*args)
    log(f"phase {name}: {time.time() - t0:.1f} s")
    return out


def main():
    name, smi = probe()
    if os.path.exists(WORK):
        shutil.rmtree(WORK)
    os.makedirs(WORK)
    timed("build", build)
    k1_slice = timed("kernels S=616", kernel_phase, S, BUCKETS, 20261016)
    k1_lr = timed("kernels S=1024", kernel_phase, K2_S, LR_BUCKETS, 20261018)
    # K1's stage-1 form at the benchmark cell's S = 616 and the LR sweep's
    s1_rows = {S: timed("stage-1 S=616", stage1_phase, S, LR_BUCKETS, 20261021),
               K2_S: timed("stage-1 S=1024", stage1_phase, K2_S, LR_BUCKETS, 20261022)}
    k2_row = timed("fused", fused_phase)
    k3_rows = timed("compat kernel", compat_kernel_phase)
    for backend in ("spmd", "pallas", "jax", "fast"):
        timed(f"small {backend}", small_phase, backend)
    timed("resume", resume_phase)
    launches, by_bucket = timed("slice", slice_phase)
    timed("cli", cli_phase)
    headline_by_bucket, headline_inputs, headline_sr_pairs, e2e_rec = timed(
        "headline", headline_phase)
    fast_by_bucket = timed("headline fast", headline_fast_phase, headline_inputs)
    lr, (lr_k1, lr_s1), (lr_stream_k1, lr_stream_s1) = timed("lr", lr_phase)
    pipe_by_bucket, pipe_rec = timed("pipeline leg", pipeline_leg_phase)
    k1_stream, s1_stream, k2_stream, stream, stream_rec = timed(
        "streaming leg", streaming_leg_phase)
    k3_by_shape = timed("compat", compat_phase)
    k3_sharded = timed("sharded", sharded_phase)
    timed("one card", one_card_phase)
    timed("part footprint", part_footprint_phase)
    timed("flat footprint", flat_footprint_phase)
    timed("multi small", multi_small_phase)
    timed("multi cli", multi_cli_phase)
    multi_by_bucket, multi_lr_s1, multi_k2, multi_k3 = timed(
        "multi headline, lr, sharded", multi_big_phase, headline_inputs)
    timed("multi auto", multi_auto_phase, headline_inputs, headline_sr_pairs)
    terms_rows, terms_sweep = timed("terms", terms_phase)
    kernels = []
    # K1 at the spmd slice's S = 616 and the LR sweep's S = 1024, each row
    # with the launches of the path that runs the kernel at that shape (the
    # S = 616 rows also with the headline run's)
    unmeasured = (set(headline_by_bucket) | set(fast_by_bucket)
                  | set(multi_by_bucket) | set(pipe_by_bucket)) - set(k1_slice)
    if unmeasured:
        raise RuntimeError(f"K1 launched on the headline runs in buckets not"
                           f" measured at its shape: {sorted(unmeasured)}")
    for rows, path_launches, path in ((k1_slice, by_bucket, "spmd slice"),
                                      (k1_lr, {**lr_k1, **lr_stream_k1}, "LR sweep")):
        unmeasured = set(path_launches) - set(rows)
        if unmeasured:
            raise RuntimeError(f"K1 launched on the {path} in buckets not"
                               f" measured at its shape: {sorted(unmeasured)}")
        for (Rf, Rt, pure), row in rows.items():
            extra = ({"launches_headline": headline_by_bucket.get((Rf, Rt, pure), 0),
                      "launches_headline_fast": fast_by_bucket.get((Rf, Rt, pure), 0),
                      "launches_multi_headline": multi_by_bucket.get((Rf, Rt, pure), 0),
                      "launches_pipeline_leg": pipe_by_bucket.get((Rf, Rt, pure), 0)}
                     if rows is k1_slice else
                     {"launches_lr_streamed": lr_stream_k1.get((Rf, Rt, pure), 0)})
            kernels.append(k1_line(
                row, (by_bucket if rows is k1_slice else lr_k1).get((Rf, Rt, pure), 0),
                **extra))
    # K1's stage-1 form: the LR sweep runs it at S = 1024 (resident, streamed
    # and on two ranks); no phase here runs the sweep at S = 616
    unmeasured = set({**lr_s1, **lr_stream_s1, **multi_lr_s1}) - set(s1_rows[K2_S])
    if unmeasured:
        raise RuntimeError(f"K1's stage-1 form launched on the LR sweep in buckets"
                           f" not measured at its shape: {sorted(unmeasured)}")
    for depth, rows in s1_rows.items():
        for key, row in rows.items():
            kernels.append(s1_line(
                row, lr_s1.get(key, 0) if depth == K2_S else 0,
                **({"launches_lr_streamed": lr_stream_s1.get(key, 0),
                    "launches_multi_lr": multi_lr_s1.get(key, 0)}
                   if depth == K2_S else {})))
    kernels.append(k2_line(k2_row, lr["k2_launches"],
                           launches_lr_streamed=lr["stream_k2_launches"],
                           launches_multi_lr=multi_k2))
    # the streaming leg's depth, S = 16,384: launches of its streamed call
    # (the counted one), and of the resident call beside them
    for key, row in k1_stream.items():
        kernels.append(k1_line(row, stream["k1_by_bucket"].get(key, 0),
                               launches_resident=stream["resident_k1_by_bucket"]
                               .get(key, 0)))
    for key, row in s1_stream.items():
        kernels.append(s1_line(row, stream["k1_stage1_by_bucket"].get(key, 0),
                               launches_resident=stream["resident_k1_stage1_by_bucket"]
                               .get(key, 0)))
    kernels.append(k2_line(k2_stream, stream["k2_launches"],
                           launches_resident=stream["resident_k2_launches"]))
    k3_by_shape = dict(k3_by_shape)
    k3_by_shape[SHARDED_B, SHARDED_B] = k3_sharded  # the sharded sweep's tile
    unmeasured = set(k3_by_shape) - set(k3_rows)
    if unmeasured:
        raise RuntimeError(f"K3 launched at tile shapes not measured: {sorted(unmeasured)}")
    for (F, T), row in k3_rows.items():
        sharded = (F, T) == (SHARDED_B, SHARDED_B)
        kernels.append(k3_line(
            row, F, T, k3_by_shape.get((F, T), 0),
            **({"launches_multi_sharded": multi_k3} if sharded else {})))
    # t = 1 and 2: K1 and K2 with the launches of the sweep leg at that t,
    # K3 with those of mi_tile_pallas(n_terms=t) at 512^2
    for t, trows in terms_rows.items():
        by = terms_sweep[t]["k1_by_bucket"]
        unmeasured = set(by) - set(trows["k1"])
        if unmeasured:
            raise RuntimeError(f"K1 launched at t={t} in buckets not measured:"
                               f" {sorted(unmeasured)}")
        for key, row in trows["k1"].items():
            kernels.append(k1_line(row, by.get(key, 0)))
        by_s1 = terms_sweep[t]["k1_stage1_by_bucket"]
        unmeasured = set(by_s1) - set(trows["k1s1"])
        if unmeasured:
            raise RuntimeError(f"K1's stage-1 form launched at t={t} in buckets not"
                               f" measured: {sorted(unmeasured)}")
        for key, row in trows["k1s1"].items():
            kernels.append(s1_line(row, by_s1.get(key, 0)))
        kernels.append(k2_line(trows["k2"], terms_sweep[t]["k2_launches"]))
        for (F, T), row in trows["k3"].items():
            kernels.append(k3_line(row, F, T, trows["k3_host_launches"]
                                   if (F, T) == (SHARDED_B, SHARDED_B) else 0))
    print(json.dumps({"recorded": {"e2e": e2e_rec, "pipeline_leg": pipe_rec,
                                   "streaming_leg": stream_rec}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-worker"]:
        multi_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
