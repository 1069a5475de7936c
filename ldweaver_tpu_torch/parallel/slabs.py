"""Tile visiting order and the device-memory check of the block-pair
sweep: a copy of the JAX package's `panel_pair_order`, the streaming
decision of its `plan_budget` (parallel/slabs.py:187-237), and
`auto_budget` reading a CUDA card's memory.  The slab cache itself
(streaming) is not ported (ROADMAP.md item 9)."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch


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


def auto_budget(device) -> Optional[int]:
    """The device's memory capacity in bytes when it has one to report (a
    CUDA card's total memory; None on the CPU).  The default slab budget,
    as in the JAX package."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return None


def would_stream(nseq: int, block: int, nb: int,
                 budget_bytes: Optional[int]) -> bool:
    """The streaming decision of the JAX package's `plan_budget`: True when
    the nb u8 code slabs exceed 60% of the device byte budget (~40% is kept
    for tile workspace).  The slab and panel sizing a streaming sweep needs
    comes with the slab cache (ROADMAP.md item 9)."""
    if budget_bytes is None:
        return False
    return nseq * block * nb > int(budget_bytes * 0.6)
