"""Device-slab LRU cache and cache-aware pair traversal of the block-pair
sweep, for rank-code tensors larger than a device budget (the JAX
package's parallel/slabs.py).

The kernels K1 and K2 read one sequence-major code tensor at column
offsets, so the cache is ONE device pool `[nseq, n_slots * block]` u8: a
slab is a column strip of the pool, `SlabCache.get(bi)` uploads block
`bi`'s strip on a miss and returns its column offset, and a tile is
computed on the pool with the offsets of its two slabs.  With
`max_slabs=None` the pool holds every block (the resident path, the same
code).  Slabs cross to the card nibble-packed and are unpacked there into
their strip.

Reusing a slot is safe without events: uploads are queued on the stream
that runs the tiles, so every tile queued before an upload reads the
slot's old contents before the upload overwrites them.

The pairs are visited in row PANELS (`panel_pair_order`): the panel's
row slabs stay pinned while the trailing columns stream through the free
slots, so uploads drop from 2 per tile to ~nb + nb^2/(2 * panel).
`plan_budget` sizes the pool and the panel from a byte budget;
`auto_budget` reads a CUDA card's memory.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Optional, Set, Tuple

import numpy as np
import torch

from ldweaver_tpu_torch.utils.profiling import span


def pack_nibbles(host: np.ndarray, pad: int = 0) -> np.ndarray:
    """Host-side nibble pack: [B, n] u8 (values <= 0xF) -> [B, ceil(n/2)]
    u8 with `pad` filling an odd final column; `unpack_nibbles` is its
    exact device inverse."""
    if host.shape[1] % 2:
        host = np.concatenate(
            [host, np.full((host.shape[0], 1), pad, np.uint8)], axis=1
        )
    return host[:, 0::2] | (host[:, 1::2] << 4)


def unpack_nibbles(packed: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ceil(n/2)] u8 -> [B, n] u8 with columns (lo_0, hi_0, lo_1,
    hi_1, ...), on the tensor's device."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)[:, :n]


class SlabCache:
    """LRU cache of rank-code slabs in one device pool.

    `get(bi)` returns the pool column offset of block `bi`'s codes,
    uploading them on a miss into the least recently used unpinned slot;
    `pin` protects a working set (the panel rows) from eviction."""

    def __init__(self, rank_codes: np.ndarray, block: int,
                 max_slabs: Optional[int], device):
        self.rank_codes = rank_codes  # [nseq, nsnp_padded] host
        self.block = block
        self.nb = rank_codes.shape[1] // block
        self.max_slabs = max_slabs  # None = every block (resident)
        self.device = torch.device(device)
        n_slots = self.nb if max_slabs is None else min(max_slabs, self.nb)
        self.pool = torch.empty((rank_codes.shape[0], n_slots * block),
                                dtype=torch.uint8, device=self.device)
        self._slots: "OrderedDict[int, int]" = OrderedDict()  # bi -> slot
        self._free = list(range(n_slots))
        self._pinned: Set[int] = set()
        self.uploads = 0
        self.hits = 0

    def write_slab(self, bi: int, dest: torch.Tensor) -> None:
        """Queue the upload of block `bi`'s [nseq, block] codes into
        `dest` (a pool strip or any tensor of that shape)."""
        host = self.rank_codes[:, bi * self.block : (bi + 1) * self.block]
        # rank codes are 0..4 (rank_encode): two fit a byte
        t = torch.from_numpy(np.ascontiguousarray(pack_nibbles(host)))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        dest.copy_(unpack_nibbles(t, self.block))

    def get(self, bi: int) -> int:
        bi = int(bi)
        slot = self._slots.get(bi)
        if slot is not None:
            self._slots.move_to_end(bi)
            self.hits += 1
            return slot * self.block
        if not self._free:
            victim = next((b for b in self._slots if b not in self._pinned), None)
            if victim is None:
                raise RuntimeError(
                    f"SlabCache: all {len(self._slots)} slots are pinned"
                )
            self._free.append(self._slots.pop(victim))
        slot = self._free.pop()
        off = slot * self.block
        with span("ldw.slab.upload"):
            self.write_slab(bi, self.pool[:, off : off + self.block])
        self.uploads += 1
        self._slots[bi] = slot
        return off

    def pin(self, blocks) -> None:
        self._pinned.update(int(b) for b in blocks)

    def unpin(self) -> None:
        self._pinned.clear()


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


def plan_budget(nseq: int, block: int, nb: int,
                budget_bytes: Optional[int]) -> Tuple[bool, Optional[int], int]:
    """(streaming?, max_slabs, panel) for a device byte budget.

    Reserves ~40% of the budget for tile workspace; the rest holds slabs.
    Streaming keeps the panel's rows pinned plus two free slots (the
    current column and the next one)."""
    if budget_bytes is None:
        return False, None, nb
    slab_bytes = nseq * block  # uint8
    usable = int(budget_bytes * 0.6)
    if slab_bytes * nb <= usable:
        return False, None, nb
    max_slabs = max(4, usable // slab_bytes)
    panel = max(1, max_slabs - 2)
    return True, max_slabs, panel
