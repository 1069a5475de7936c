"""Several processes, joined by `torch.distributed` (the JAX package's
parallel/multihost.py).

Every process runs the same program on the same inputs; BLK5's tiles are
cut into contiguous ranges, one a shard, where a shard is one (process,
local device) pair (`shard_ranges`).  The processes meet only at fixed
points of the host program, where `allgather_object` hands every process
the results of all of them, in rank order.  The collectives run on the
gloo backend and carry host tensors, as `process_allgather` does in the
JAX package; so two processes may share one card.

Collective order: gloo needs every process to issue its collectives in
the same order.  The callers issue them from the main thread only, at
points that do not depend on the process's own data; a choice a process
makes from its own environment (BLK5's SR reduction, from its SR budget)
is gathered and compared first, and a mismatch raises.

Outputs: every process ends with every tile's links and writes the same
files; `is_writer` is there for callers that want one writer.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

# one gloo message at most: larger payloads are sent in pieces
CHUNK_BYTES = 256 << 20


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 1800.0,
) -> None:
    """Join the process group (gloo).  Call it before anything touches
    CUDA.  `coordinator_address` is host:port of process 0; without it the
    standard MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK environment is
    read.  A failed bring-up raises: the program never goes on as a single
    process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                "initialize_multihost: a multi-process run needs a"
                f" coordinator address, or {', '.join(missing)} in the"
                " environment"
            )
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_multihost: a coordinator address"
                             " needs num_processes and process_id")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} outside"
                             f" [0, {num_processes})")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=None if num_processes is None else int(num_processes),
        rank=None if process_id is None else int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    return process_index() == 0


def shard_layout(device="cuda", n_devices: Optional[int] = None
                 ) -> Tuple[list, int, int]:
    """(this process's local devices, its first global shard, the shard
    count): shard s = process * L + local device l, the port's counterpart
    of the JAX package's 1-D mesh over every device of every process.  The
    devices follow `support.resolve_devices(device, n_devices)`."""
    from ldweaver_tpu_torch.support import resolve_devices

    devices = resolve_devices(device, n_devices)
    L = len(devices)
    return devices, process_index() * L, process_count() * L


def shard_ranges(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of `n_shards` contiguous ranges of n items, the
    split of `process_pairs`: ceil(n / n_shards) items a shard, the last
    ones shorter or empty."""
    per = -(-n // n_shards) if n_shards else 0
    return [(min(n, s * per), min(n, (s + 1) * per)) for s in range(n_shards)]


def process_pairs(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a global block-pair list into (this process's range, its
    global slot indices); slots stay global."""
    lo, hi = shard_ranges(len(pairs), process_count())[process_index()]
    return pairs[lo:hi], np.arange(lo, hi, dtype=np.int32)


class GatherStats:
    """Wall seconds and bytes received of the gathers of one run."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.nbytes = 0


def allgather_bytes(buf: np.ndarray, stats: Optional[GatherStats] = None
                    ) -> List[np.ndarray]:
    """Every process's u8 buffer, in rank order, on every process: the
    sizes first, then the buffers padded to the largest, in pieces of at
    most CHUNK_BYTES."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    world = process_count()
    buf = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    if world == 1:
        return [buf]
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([buf.size], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    out = [np.empty(top, np.uint8) for _ in range(world)]
    src = np.zeros(top, np.uint8)
    src[: buf.size] = buf
    for lo in range(0, top, CHUNK_BYTES):
        hi = min(top, lo + CHUNK_BYTES)
        parts = [torch.from_numpy(o[lo:hi]) for o in out]
        dist.all_gather(parts, torch.from_numpy(src[lo:hi]))
    if stats is not None:
        stats.seconds += time.perf_counter() - t0
        stats.nbytes += sum(sizes)
    return [o[:s] for o, s in zip(out, sizes)]


def allgather_object(obj, stats: Optional[GatherStats] = None) -> list:
    """Every process's picklable `obj` (numpy arrays inside travel as raw
    bytes), in rank order, on every process."""
    if process_count() == 1:
        return [obj]
    data = np.frombuffer(pickle.dumps(obj, protocol=5), np.uint8)
    return [pickle.loads(b.tobytes())
            for b in allgather_bytes(data, stats)]

