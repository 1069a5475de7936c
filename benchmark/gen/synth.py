"""Synthetic LDWeaver inputs from a seed: the recipe of the port's
`chip_smoke.bench_synth` (itself bench.py's `synth`), drawn with a
`torch.Generator` on the device in a few large calls, plus the pipeline
leg's random CDS-cluster paint.

  * each site has a major and a minor allele (A, C, G or T), the minor
    drawn at a site frequency uniform in [0.02, 0.5];
  * about 15% of sites carry N calls (code 4) in 3% of genomes;
  * positions: distinct, uniform over a genome of `genome_len` bases;
  * Hamming-like genome weights uniform in [0.05, 0.5] (float64);
  * the CDS paint: a cluster in 1..n_clusters for every site.

The same seed on the same kind of device gives the same arrays.  The
port and the reference are handed these same arrays; nothing here
imports either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# seeds are taken modulo this (a torch generator takes 64 bits)
SEED_MOD = 1 << 63


@dataclasses.dataclass
class Inputs:
    codes: np.ndarray  # [nseq, nsnp] uint8 allele codes A=0 C=1 G=2 T=3 N=4
    pos: np.ndarray  # [nsnp] int64, 1-based, ascending
    acgtn: np.ndarray  # [5, nsnp] int64 allele counts
    w: np.ndarray  # [nseq] float64 genome weights
    paint: np.ndarray  # [nsnp] int64 CDS cluster, 1..n_clusters
    g: int  # genome length
    n_clusters: int

    @property
    def nseq(self) -> int:
        return self.codes.shape[0]

    @property
    def nsnp(self) -> int:
        return self.codes.shape[1]


def make_inputs(config: dict, seed: int, device) -> Inputs:
    """The inputs of one run of a configuration (`n_genomes`, `n_snps`,
    `genome_len`, `n_clusters`), drawn on `device` from `seed`."""
    nseq, nsnp = int(config["n_genomes"]), int(config["n_snps"])
    g, nclust = int(config["genome_len"]), int(config["n_clusters"])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % SEED_MOD)

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    major = randint(0, 4, nsnp)
    minor = (major + randint(1, 4, nsnp)) % 4
    maf = 0.02 + 0.48 * rand(nsnp)
    codes = torch.where(rand(nseq, nsnp) < maf[None, :], minor[None, :],
                        major[None, :]).to(torch.uint8)
    n_sites = rand(nsnp) < 0.15
    n_cells = (rand(nseq, nsnp) < 0.03) & n_sites[None, :]
    codes[n_cells] = 4
    del n_cells
    pos = torch.sort(torch.randperm(g, generator=gen, device=dev)[:nsnp]).values + 1
    acgtn = torch.stack([(codes == k).sum(dim=0) for k in range(5)])
    w = 0.05 + 0.45 * rand(nseq, dtype=torch.float64)
    paint = randint(1, nclust + 1, nsnp)
    return Inputs(codes=codes.cpu().numpy(), pos=pos.cpu().numpy().astype(np.int64),
                  acgtn=acgtn.cpu().numpy().astype(np.int64),
                  w=w.cpu().numpy(), paint=paint.cpu().numpy().astype(np.int64),
                  g=g, n_clusters=nclust)
