"""The LDWeaver MI statistic in float64, from the allele codes and the
genome weights alone.

For SNP pair (f, t) with genome weights w, neff = sum(w), r the number of
distinct alleles at a site, and weighted counts n_XY = sum_s w_s
[f_s = X][t_s = Y], n_X = sum_s w_s [f_s = X]:

  den   = neff + 0.5 r_f r_t
  MI    = sum over the alleles X present at f and Y present at t of
          (n_XY + 0.5) / den * log((n_XY + 0.5) den /
                                   (n_X n_Y + 0.25 r_f r_t + 0.5 n_X r_f
                                    + 0.5 n_Y r_t))

(LDWeaver, R/computePairwiseMI.R; the pseudocount RXY taken as the
intended 0.25 r_f r_t).  MI does not depend on the names of the alleles,
so each site's alleles are numbered here by their count, most frequent
first (ties by allele code): a site's r alleles are 0..r-1, and a tile
needs only R x R count planes for R the largest r.

`weights_dtype=torch.bfloat16` rounds the weights of the joint counts to
bfloat16 (the marginals and neff stay float64): the lower-precision
control.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


class Sites:
    """Per-site numbering of the alleles by count, on a device: `codes`
    [nseq, nsnp] uint8 (0..r-1 by count), `r` [nsnp] float64, the weights,
    neff and the float64 marginals [R, nsnp]."""

    def __init__(self, codes: np.ndarray, w: np.ndarray, device,
                 weights_dtype=F64):
        dev = torch.device(device)
        c = torch.from_numpy(codes).to(dev)
        nsnp = c.shape[1]
        counts = torch.stack([(c == k).sum(dim=0) for k in range(5)])  # [5, nsnp]
        # rank of allele k at a site: alleles with a larger count, or an
        # equal count and a smaller code, come first
        key = counts * 8 + (7 - torch.arange(5, device=dev))[:, None]
        order = torch.argsort(key, dim=0, descending=True)  # [5, nsnp]
        rank_of = torch.empty_like(order)
        rank_of.scatter_(0, order, torch.arange(5, device=dev)[:, None].expand(5, nsnp))
        self.codes = torch.gather(rank_of, 0, c.long()).to(torch.uint8)
        del c
        self.r = (counts > 0).sum(dim=0).to(F64)
        self.R = int(self.r.max())
        self.w = torch.from_numpy(np.asarray(w, np.float64)).to(dev)
        self.wj = self.w.to(weights_dtype).to(F64)  # weights of the joint counts
        self.neff = self.w.sum()
        self.marg = torch.stack([((self.codes == x).to(F64) * self.w[:, None]).sum(dim=0)
                                 for x in range(self.R)])
        self.device = dev

    def onehot(self, cols, x: int, weighted: bool):
        m = (self.codes[:, cols] == x).to(F64)
        return m * self.wj[:, None] if weighted else m


def mi_tile(sites: Sites, rows, cols) -> torch.Tensor:
    """[len(rows), len(cols)] float64 MI of every pair (rows[i], cols[j])
    (site indices; index tensors or slices on the sites' device)."""
    R = sites.R
    rf, rt = sites.r[rows], sites.r[cols]
    nf, nt = rf.numel(), rt.numel()
    den = sites.neff + 0.5 * torch.outer(rf, rt)
    base = 0.25 * torch.outer(rf, rt)
    mi = torch.zeros((nf, nt), dtype=F64, device=sites.device)
    rhs = [sites.onehot(cols, y, False) for y in range(R)]
    for x in range(R):
        lhs = sites.onehot(rows, x, True)
        px = sites.marg[x, rows]
        for y in range(R):
            py = sites.marg[y, cols]
            pxy = lhs.T @ rhs[y] + 0.5
            denom = (torch.outer(px, py) + base + (0.5 * px * rf)[:, None]
                     + (0.5 * py * rt)[None, :])
            gate = torch.outer((x < rf).to(F64), (y < rt).to(F64))
            mi += gate * pxy / den * torch.log(pxy * den / denom)
    return mi


def mi_pairs(sites: Sites, i: np.ndarray, j: np.ndarray, batch: int = 4096) -> np.ndarray:
    """float64 MI of the pairs (i[k], j[k]), site indices."""
    out = np.empty(len(i), np.float64)
    for s in range(0, len(i), batch):
        a = torch.from_numpy(np.asarray(i[s : s + batch], np.int64)).to(sites.device)
        b = torch.from_numpy(np.asarray(j[s : s + batch], np.int64)).to(sites.device)
        R = sites.R
        rf, rt = sites.r[a], sites.r[b]
        den = sites.neff + 0.5 * rf * rt
        base = 0.25 * rf * rt
        mi = torch.zeros(a.numel(), dtype=F64, device=sites.device)
        ca, cb = sites.codes[:, a], sites.codes[:, b]
        for x in range(R):
            wa = (ca == x).to(F64) * sites.wj[:, None]
            px = sites.marg[x, a]
            for y in range(R):
                py = sites.marg[y, b]
                pxy = (wa * (cb == y).to(F64)).sum(dim=0) + 0.5
                denom = px * py + base + 0.5 * px * rf + 0.5 * py * rt
                gate = ((x < rf) & (y < rt)).to(F64)
                mi += gate * pxy / den * torch.log(pxy * den / denom)
        out[s : s + batch] = mi.cpu().numpy()
    return out


def circular_len(pos1, pos2, g: int):
    """Circular distance 0.5 g - |(pos1 - pos2) mod g - 0.5 g|, float64
    (works on numpy arrays and torch tensors alike)."""
    d = (pos1 - pos2) % g
    return 0.5 * g - abs(d - 0.5 * g)
