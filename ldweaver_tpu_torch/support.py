"""What the port runs, and the devices it runs on.

Entry points call `check_supported` with the options they were given.
`resolve_device` turns the `device` argument into a torch.device, refuses
a CUDA device when no card is present (the port never falls back to the
CPU silently), and turns TF32 off for the port's f32 matrix products on
the card.  `resolve_devices` adds `n_devices`: the local devices of one
process, one shard each (parallel/multihost.py).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

PORTED_BACKENDS = ("fast", "spmd", "jax", "pallas", "numpy")


def check_supported(
    backend: str = "spmd",
    n_devices: Optional[int] = None,
) -> None:
    if backend not in PORTED_BACKENDS:
        raise ValueError(f"unknown MI backend {backend!r}")
    if n_devices is not None and int(n_devices) < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is available;"
                " pass device='cpu' to run the plain PyTorch versions"
            )
        # the port's f32 products (the plain versions, mi_tile_jax, BLK4)
        # run at full f32 precision, as XLA's Precision.HIGHEST in the JAX
        # package; TF32 would keep 10 mantissa bits
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def resolve_devices(device, n_devices: Optional[int] = None) -> List[torch.device]:
    """The local devices of this process, one shard each.

    "cpu": `n_devices` shards (default 1) on the one CPU device, the
    counterpart of the JAX tests' virtual host devices.  "cuda" without an
    index: every card (`torch.cuda.device_count()`) by default; under
    several processes one card a process, cuda:{LOCAL_RANK}.  A named card
    "cuda:k": that card, or with `n_devices` the cards k, k+1, ....  More
    cards than the machine has raise ValueError: a card is never shared
    quietly."""
    from ldweaver_tpu_torch.parallel.multihost import process_count, process_index

    check_supported(n_devices=n_devices)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (1 if n_devices is None else int(n_devices))
    count = torch.cuda.device_count()
    if dev.index is None:
        if n_devices is None and process_count() > 1:
            first = int(os.environ.get("LOCAL_RANK", process_index()))
            n = 1
        else:
            first, n = 0, count if n_devices is None else int(n_devices)
    else:
        first, n = dev.index, 1 if n_devices is None else int(n_devices)
    if first + n > count:
        raise ValueError(
            f"n_devices={n} from cuda:{first} needs {first + n} cards;"
            f" this machine has {count}"
        )
    return [torch.device("cuda", first + i) for i in range(n)]
