"""ARACNE indirect-link pruning (data-processing inequality test).

Reference: `runARACNE` (R/io_functions.R:101-164) plus the C++ helpers
`.compareToRow`/`.vecPosMatch`/`.compareTriplet`/`.fast_intersect`
(src/computeMI.cpp:24-77, src/fintersect.cpp:6-32).

Semantics (replicated exactly):
  for each checked link (X, Z) with MI0:
    matX = partner positions of every link in the FULL pool touching X
    matZ = partner positions of every link in the FULL pool touching Z
    common = sorted intersection of matX and matZ
    the link is INDIRECT (ARACNE = False) iff there exists a common
    neighbour Y with  MI0 < MI(X,Y)  AND  MI0 < MI(Y,Z)   (strict <,
    src/computeMI.cpp:69-74); links with no common neighbour stay True.

The reference runs an O(n_links) scan per checked link (two .compareToRow
passes over the whole pool).  Here the pool is pre-indexed once into a
sorted-adjacency structure (position -> sorted partner array + aligned MI
array), making each check O(deg_X + deg_Z); the check loop is NumPy-
vectorised per link.  Exact labels are preserved.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _build_adjacency(pos1: np.ndarray, pos2: np.ndarray, mi: np.ndarray):
    """position -> (sorted partner positions, MI aligned to partners)."""
    endpoints = np.concatenate([pos1, pos2])
    partners = np.concatenate([pos2, pos1])
    mis = np.concatenate([mi, mi])
    order = np.argsort(endpoints, kind="stable")
    endpoints = endpoints[order]
    partners = partners[order]
    mis = mis[order]
    uniq, starts = np.unique(endpoints, return_index=True)
    bounds = np.append(starts, endpoints.size)
    adj: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for k in range(uniq.size):
        sl = slice(bounds[k], bounds[k + 1])
        p = partners[sl]
        m = mis[sl]
        o = np.argsort(p, kind="stable")
        adj[int(uniq[k])] = (p[o], m[o])
    return adj


def _run_aracne_native(check_pos1, check_pos2, check_mi,
                       full_pos1, full_pos2, full_mi):
    """Native CSR path (OpenMP sorted-intersection scan); None -> fallback."""
    from ldweaver_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import os

    # CSR adjacency over unique positions
    uniq = np.unique(np.concatenate([full_pos1, full_pos2, check_pos1, check_pos2]))
    u1 = np.searchsorted(uniq, full_pos1)
    u2 = np.searchsorted(uniq, full_pos2)
    endpoints = np.concatenate([u1, u2])
    partners = np.concatenate([u2, u1])
    mis = np.concatenate([full_mi, full_mi])
    # sort by (endpoint, partner) so each row's partners are ascending
    order = np.lexsort((partners, endpoints))
    endpoints = endpoints[order]
    partners = np.ascontiguousarray(partners[order], dtype=np.int64)
    mis = np.ascontiguousarray(mis[order], dtype=np.float64)
    starts = np.searchsorted(
        endpoints, np.arange(uniq.size + 1), side="left"
    ).astype(np.int64)

    cu = np.ascontiguousarray(np.searchsorted(uniq, check_pos1), np.int64)
    cv = np.ascontiguousarray(np.searchsorted(uniq, check_pos2), np.int64)
    cm = np.ascontiguousarray(check_mi, np.float64)
    out = np.zeros(cu.size, dtype=np.uint8)
    lib.ldw_aracne(
        cu, cv, cm, cu.size, starts, partners, mis, out,
        os.cpu_count() or 1,
    )
    return out.astype(bool)


def run_aracne(
    check_pos1: np.ndarray,
    check_pos2: np.ndarray,
    check_mi: np.ndarray,
    full_pos1: np.ndarray,
    full_pos2: np.ndarray,
    full_mi: np.ndarray,
    use_native: bool = True,
) -> np.ndarray:
    """Boolean direct/indirect labels for the checked links.

    True = direct (kept), False = indirect - matching runARACNE's return
    (R/io_functions.R:112,157).
    """
    check_pos1 = np.asarray(check_pos1, dtype=np.int64)
    check_pos2 = np.asarray(check_pos2, dtype=np.int64)
    check_mi = np.asarray(check_mi, dtype=np.float64)
    if use_native:
        res = _run_aracne_native(
            check_pos1, check_pos2, check_mi,
            np.asarray(full_pos1, np.int64),
            np.asarray(full_pos2, np.int64),
            np.asarray(full_mi, np.float64),
        )
        if res is not None:
            return res
    adj = _build_adjacency(
        np.asarray(full_pos1, dtype=np.int64),
        np.asarray(full_pos2, dtype=np.int64),
        np.asarray(full_mi, dtype=np.float64),
    )
    n = check_pos1.size
    out = np.ones(n, dtype=bool)
    for i in range(n):
        x = int(check_pos1[i])
        z = int(check_pos2[i])
        ax = adj.get(x)
        az = adj.get(z)
        if ax is None or az is None:
            continue
        px, mx = ax
        pz, mz = az
        # sorted intersection (src/fintersect.cpp) - partners are unique
        # per endpoint because (pos1,pos2) pairs are unique in the pool.
        common, ix, iz = np.intersect1d(
            px, pz, assume_unique=False, return_indices=True
        )
        # the reference removes self-partners (matX = matX[matX != pX]);
        # with unique pairs the only way x appears in px is a direct
        # (x, z=x) link which cannot exist, but z CAN appear in px (the
        # checked link itself) - and x in pz.  Those entries correspond to
        # the checked link; keep them out of the triplet test exactly as
        # the reference does by construction (it removes only the
        # endpoint itself from its own partner list, so the X-Z link
        # contributes Y=z to matX and Y=x to matZ; but such Y is only
        # *common* if (x,x) or (z,z) links existed).  No filtering needed.
        if common.size == 0:
            continue
        mi0 = check_mi[i]
        if np.any((mi0 < mx[ix]) & (mi0 < mz[iz])):
            out[i] = False
    return out
