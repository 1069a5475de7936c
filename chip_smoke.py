#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`ldweaver_tpu_torch`) on one NVIDIA
Hopper GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the final line):
  1. probe   - the card's name, capability (must be 9.0), power limit;
  2. build   - every CUDA kernel of the port from ldweaver_tpu_torch/csrc,
               one nvcc per source, all started together;
  3. kernels - K1 (the rank-compacted MI tile) at the main path's tile
               shape, B = 4096 SNPs x S = 616 genomes, for every bucket
               (Rf, Rt, pure) below: kernel against its plain PyTorch
               version on the card (max abs diff <= 2e-5) and against the
               float64 oracle on a 256 x 256 sub-tile (rtol 2e-4, atol
               2e-5); CUDA-event times of the kernel, the plain version
               and one torch.matmul of the same contingency product;
  4. small   - the port's pipeline on a small synthetic input on the card
               and on the CPU (plain versions): link tables must agree;
  5. slice   - the main path, `ldweaver(..., backend="spmd")` through
               BLK1-BLK7 at 616 genomes x 2.2 Mb x 32,768 SNPs, with K1's
               launch counts set to 0 just before and read just after.

Prints one JSON line of per-kernel numbers, then the card's name and
power limit as nvidia-smi gives them, then the ok line.  The input data
is generated from a seed into `_smoke_run/` (git-ignored) beside this
file.  The port imports neither JAX nor the JAX package.
"""

import gzip
import json
import os
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
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12


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
    # state the float32 product precision the plain versions run at
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
    log(f"build wall {time.time() - t0:.1f} s")


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


def bucket_inputs(rng, Rf, Rt, pure):
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


def kernel_phase():
    import torch

    from ldweaver_tpu_torch.core.mi import mi_tile_numpy
    from ldweaver_tpu_torch.ops import rank_mi
    from ldweaver_tpu_torch.parallel.fast_sweep import rank_marginals, wparts

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    rows = {}
    for Rf, Rt, pure in BUCKETS:
        codes_np, rf_np, rt_np, w = bucket_inputs(rng, Rf, Rt, pure)
        codes = torch.from_numpy(codes_np).to(dev)
        w32, parts = wparts(w)
        w32, parts = w32.to(dev), parts.to(dev).contiguous()
        px = rank_marginals(codes, 0, B, w32, Rf)
        py = rank_marginals(codes, B, B, w32, Rt)
        r_f = torch.tensor(rf_np, dtype=torch.float32, device=dev)
        r_t = torch.tensor(rt_np, dtype=torch.float32, device=dev)
        neff = float(np.float32(w.sum()))
        args = (codes, 0, B, B, B, parts, px, py, r_f, r_t, neff, Rf, Rt, pure)

        got = rank_mi.rank_mi_tile(*args)
        torch.cuda.synchronize()
        plain = rank_mi.rank_mi_tile_reference(*args)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K1 {Rf, Rt, pure}: non-finite output")
        err = float((got - plain).abs().max())
        # f64 oracle on a 256 x 256 sub-tile (host, reference statistic)
        n = 256
        cf = np.ascontiguousarray(codes_np[:, :n].T)
        ct = np.ascontiguousarray(codes_np[:, B : B + n].T)
        uq_f = (np.arange(5)[None, :] < rf_np[:n, None]).astype(np.uint8)
        uq_t = (np.arange(5)[None, :] < rt_np[:n, None]).astype(np.uint8)
        oracle = mi_tile_numpy(cf, ct, w, rf_np[:n], rt_np[:n], uq_f, uq_t,
                               float(w.sum()), rxy_compat=False)
        sub = got[:n, :n].double().cpu().numpy()
        ok64 = np.allclose(sub, oracle, rtol=RTOL_F64, atol=ATOL_F64)
        err64 = float(np.abs(sub - oracle).max())

        ms = cuda_time_ms(lambda: rank_mi.rank_mi_tile(*args), reps=20)
        plain_ms = cuda_time_ms(lambda: rank_mi.rank_mi_tile_reference(*args), reps=3, warm=1)
        nc = (Rf - 1) * (Rt - 1) if Rf >= 2 and Rt >= 2 else 0
        if nc:
            lhs = torch.ones((B, 3 * S), dtype=torch.bfloat16, device=dev)
            rhs = torch.ones((B, 3 * S), dtype=torch.bfloat16, device=dev)
            library_ms = cuda_time_ms(lambda: torch.matmul(lhs, rhs.T), reps=20)
            del lhs, rhs
        else:
            library_ms = None  # no contraction: the tile is marginals only
        nbytes = S * 2 * B + 2 * 3 * S + 4 * (Rf + Rt) * B + 8 * B + 4 * B * B
        flops = 2.0 * B * B * 3 * S * nc
        t_bytes, t_ops = nbytes / HBM_BPS, flops / BF16_FLOPS
        bound_ms = 1e3 * max(t_bytes, t_ops)
        row = dict(
            Rf=Rf, Rt=Rt, pure=pure, max_abs_err=err, f64_max_abs_err=err64,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        rows[(Rf, Rt, pure)] = row
        log(f"K1 {Rf},{Rt},{'pure' if pure else 'general'}: kernel {ms:.3f} ms,"
            f" plain {plain_ms:.3f} ms, matmul {library_ms} ms, bound"
            f" {1e3 * bound_ms:.1f} us ({row['bound_by']}); max|kernel-plain|"
            f" {err:.2e}, max|kernel-f64| {err64:.2e}")
        if err > ATOL_PLAIN:
            raise RuntimeError(f"K1 {Rf, Rt, pure}: kernel vs plain {err:.3e} > {ATOL_PLAIN}")
        if not ok64:
            raise RuntimeError(f"K1 {Rf, Rt, pure}: kernel vs f64 oracle {err64:.3e}")
        del codes, got, plain, args
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# synthetic input: the examples/bench_e2e.py recipe, SNP columns only
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


def synth_snp_alignment(out_dir, nseq, g, nsnp, seed=0):
    """SNP-only alignment (.fa.gz) + 1-based positions + GenBank file:
    biallelic sites with minor-allele frequency in [0.02, 0.5], ~15% of
    sites carrying N calls at 3%, CDS features tiling ~85% of the genome."""
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
    with gzip.open(fa, "wb", compresslevel=1) as fh:
        for s in range(nseq):
            take_minor = rng.random(nsnp) < maf
            col = np.where(take_minor, minor, major)
            ncalls = (rng.random(nsnp) < 0.03) & n_sites
            col = np.where(ncalls, np.uint8(ord("N")), col)
            fh.write(b">seq%d\n" % s)
            fh.write(col.astype(np.uint8).tobytes())
            fh.write(b"\n")
    cds = []
    p = 150
    while p + 3000 < g:
        ln = int(rng.integers(200, 500)) * 3
        strand = 1 if rng.random() < 0.7 else -1
        cds.append((p, p + ln - 1, strand))
        p += ln + int(rng.integers(30, 250))
    gbk = os.path.join(out_dir, "ref.gbk")
    write_gbk(gbk, "SYNPNEUMO.1", ref.tobytes().decode(), cds)
    return fa, snp_pos + 1, gbk


def read_links(dset):
    def rows(name):
        path = os.path.join(dset, "Temp", name)
        return [ln.rstrip("\n").split("\t") for ln in open(path)]

    sr = rows("sr_links.tsv")
    lr = rows("lr_links.tsv")
    return sr, lr


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
def small_phase():
    import ldweaver_tpu_torch

    d = os.path.join(WORK, "small")
    os.makedirs(d)
    fa, pos, gbk = synth_snp_alignment(d, nseq=48, g=200_000, nsnp=3000, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        dset = os.path.join(d, dev)
        ldweaver_tpu_torch.ldweaver(
            dset=dset, aln_path=fa, aln_has_all_bases=False, pos=pos,
            gbk_path=gbk, backend="spmd", max_blk_sz=1024,
            SnpEff_Annotate=False, device=dev, lr_retain_links=20000,
        )
        out[dev] = read_links(dset)
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
    log(f"small input, card vs CPU: {json.dumps(res)}")
    # the reference package's own CPU-vs-TPU spread (CHIP_PARITY_r05.json):
    # one-side rows at 2 per 970, MI within 1.2e-4, top-10 ranking equal
    if not (sr_only <= max(2, round(2 / 970 * len(sr_p)))
            and lr_only <= max(2, round(2 / 970 * len(lr_p)))
            and sr_diff <= 1.2e-4 and lr_diff <= 1.2e-4 and top10):
        raise RuntimeError("card and CPU link tables disagree")
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
    fa, pos, gbk = synth_snp_alignment(d, nseq=616, g=2_200_000, nsnp=32768)
    log(f"slice input generated in {time.time() - t0:.1f} s")
    dset = os.path.join(d, "ldw_out")
    rank_mi.K1.reset()
    t0 = time.time()
    ldweaver_tpu_torch.ldweaver(
        dset=dset, aln_path=fa, aln_has_all_bases=False, pos=pos,
        gbk_path=gbk, backend="spmd", max_blk_sz=4096,
        SnpEff_Annotate=False, device="cuda",
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = rank_mi.K1.launches
    by_bucket = dict(rank_mi.K1.by_bucket)
    timings = json.load(open(os.path.join(dset, "timings.json")))
    sr, lr = read_links(dset)
    check_tables(sr, lr)
    spmd = timings["blk5_phases"]["spmd"]
    log(f"slice wall {wall:.1f} s; timings.json: {json.dumps(timings)}")
    log(f"slice: sr rows {len(sr)}, lr rows {len(lr)}, tiles {spmd['tiles']},"
        f" retries {spmd['retries']}, fallbacks {spmd['fallbacks']},"
        f" K1 launches {launches} {by_bucket}")
    if launches < spmd["tiles"] or spmd["tiles"] != 36:
        raise RuntimeError(f"K1 launched {launches} times for {spmd['tiles']} tiles")
    return launches, by_bucket


def main():
    name, smi = probe()
    if os.path.exists(WORK):
        shutil.rmtree(WORK)
    os.makedirs(WORK)
    build()
    rows = kernel_phase()
    small_phase()
    launches, by_bucket = slice_phase()
    kernels = []
    for (Rf, Rt, pure), row in rows.items():
        kernels.append(dict(
            name=f"rank_mi_tile[Rf={Rf},Rt={Rt},{'pure' if pure else 'general'}]",
            route="cuda",
            source="ldweaver_tpu_torch/csrc/rank_mi.cu",
            replaces=("ldweaver_tpu/parallel/fast_sweep.py:223" if pure
                      else "ldweaver_tpu/ops/pallas_rank_mi.py:23"),
            launches=by_bucket.get((Rf, Rt, pure), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
        ))
    if sum(k["launches"] for k in kernels) != launches:
        raise RuntimeError(f"the slice launched K1 in a bucket not measured: {by_bucket}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
