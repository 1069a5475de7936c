"""What the port runs so far, and the device it runs on.

Entry points call `check_supported` with the options they were given:
anything the reference package offers but the port does not yet raises
NotImplementedError naming its ROADMAP.md item.  `resolve_device` turns
the `device` argument into a torch.device, refuses a CUDA device when no
card is present (the port never falls back to the CPU silently), and
turns TF32 off for the port's f32 matrix products on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

PORTED_BACKENDS = ("fast", "spmd", "jax", "pallas", "numpy")


def check_supported(
    backend: str = "spmd",
    n_devices: Optional[int] = None,
) -> None:
    if backend not in PORTED_BACKENDS:
        raise ValueError(f"unknown MI backend {backend!r}")
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            "n_devices > 1: multi-GPU is not ported yet (ROADMAP.md item 10)"
        )


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
