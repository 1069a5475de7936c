"""Tile visiting order of the block-pair sweep (a copy of the JAX
package's `panel_pair_order`, parallel/slabs.py:187-200)."""

from __future__ import annotations

from typing import Iterator, Tuple


def panel_pair_order(nb: int, panel: int) -> Iterator[Tuple[int, int]]:
    """Upper-triangular block pairs (i <= j) in row-panel order.

    Visits the diagonal sub-triangle of each panel first, then sweeps the
    trailing columns one at a time so a cache holding `panel + 1` slabs
    (rows pinned) services every tile with one column upload each."""
    for i0 in range(0, nb, panel):
        i1 = min(i0 + panel, nb)
        for i in range(i0, i1):
            for j in range(i, i1):
                yield i, j
        for j in range(i1, nb):
            for i in range(i0, i1):
                yield i, j
