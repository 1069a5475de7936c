"""The reference of the genome-wide long-range screen (LDWeaver's
LR-only sweep, the JAX package's `fast_lr_topk`): its answer, worked out
again from the inputs with every pair's MI in float64.

The screen's answer is defined as a two-stage top-k, and not as the
exact top k of all pairs:
  * the sites are ordered by their number of distinct alleles r (a
    stable sort) and cut into blocks of `block` sites; a tile is a pair
    of blocks (bi <= bj), its rows the sites of bi and its columns those
    of bj, and on a diagonal tile only the pairs with row > column count;
  * a pair counts when its circular distance exceeds sr_dist;
  * stage 1 keeps, for each row of a tile and each run of CHUNK columns,
    the pair of largest MI;
  * stage 2 keeps the k largest of those.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.mi import Sites, circular_len, mi_pairs, mi_tile

CHUNK = 128


def lr_topk(sites: Sites, pos: np.ndarray, g: int, sr_dist: int, k: int,
            block: int = 4096):
    """(i, j, mi): the screen's k pairs (site indices), MI descending."""
    dev = sites.device
    order = torch.from_numpy(np.argsort(sites.r.cpu().numpy(), kind="stable")).to(dev)
    n = order.numel()
    p = torch.from_numpy(pos).to(dev).double()
    best = [torch.empty(0, dtype=dt, device=dev) for dt in (torch.float64, torch.int64,
                                                            torch.int64)]
    for a in range(0, n, block):
        rows = order[a : a + block]
        for b in range(a, n, block):
            cols = order[b : b + block]
            mi = mi_tile(sites, rows, cols)
            ok = circular_len(p[rows][:, None], p[cols][None, :], g) > sr_dist
            if a == b:
                ar = torch.arange(rows.numel(), device=dev)
                ok &= ar[:, None] > ar[None, :]
            mi = torch.where(ok, mi, float("-inf"))
            pad = (-cols.numel()) % CHUNK
            mi = torch.nn.functional.pad(mi, (0, pad), value=float("-inf"))
            v, arg = mi.reshape(rows.numel(), -1, CHUNK).max(dim=2)
            col = (torch.arange(v.shape[1], device=dev) * CHUNK)[None, :] + arg
            keep = torch.isfinite(v)
            cand = [v[keep], rows[:, None].expand_as(v)[keep], cols[col[keep]]]
            best = [torch.cat([x, y]) for x, y in zip(best, cand)]
            if best[0].numel() > k:
                _, sel = torch.topk(best[0], k)
                best = [x[sel] for x in best]
    o = torch.argsort(best[0], descending=True)
    v, i, j = (x[o].cpu().numpy() for x in best)
    return np.minimum(i, j), np.maximum(i, j), v


def compare(results, sites: Sites, pos: np.ndarray, g: int, sr_dist: int,
            k: int, block: int, ref=None):
    """The numbers that decide a screen's correctness, for each call's
    answer (pos1, pos2, mi) in `results`:

      mi_rel_err  the largest |MI - reference MI| / reference MI of an
                  answered pair;
      topk_gap    how far below the k-th MI of the reference's answer
                  the reference MI of the weakest answered pair lies, as
                  a share of that k-th MI (0 when every answered pair
                  reaches it);
      malformed   1 when the answer is not k distinct long-range pairs of
                  distinct sites in MI order (its other numbers are then
                  infinite).

    -> (a dict of those numbers for each call, the reference's k-th MI).
    `ref` is the reference's answer (i, j, mi), worked out when None."""
    if ref is None:
        ref = lr_topk(sites, pos, g, sr_dist, k, block)
    kth = float(ref[2][k - 1])
    index = {int(p): s for s, p in enumerate(pos.tolist())}
    answers = []
    for p1, p2, mi in results:
        p1, p2 = np.asarray(p1, np.int64), np.asarray(p2, np.int64)
        mi = np.asarray(mi, np.float64)
        ok = (len(mi) == k and bool(np.all(np.diff(mi) <= 0))
              and all(int(a) in index and int(b) in index for a, b in zip(p1, p2)))
        if ok:
            keys = [(min(index[a], index[b]), max(index[a], index[b]))
                    for a, b in zip(p1.tolist(), p2.tolist())]
            ok = (len(set(keys)) == k and bool(np.all(p1 != p2))
                  and bool(np.all(circular_len(p1, p2, g) > sr_dist)))
        answers.append((keys, mi) if ok else None)
    union = sorted({key for a in answers if a for key in a[0]})
    want = dict(zip(union, mi_pairs(sites, np.array([a for a, _ in union], np.int64),
                                     np.array([b for _, b in union], np.int64))))
    out = []
    for a in answers:
        if a is None:
            out.append(dict(mi_rel_err=float("inf"), topk_gap=float("inf"), malformed=1))
            continue
        ref_mi = np.array([want[key] for key in a[0]])
        out.append(dict(mi_rel_err=float((np.abs(a[1] - ref_mi) / np.abs(ref_mi)).max()),
                        topk_gap=float(max(0.0, kth - ref_mi.min()) / kth), malformed=0))
    return out, kth
