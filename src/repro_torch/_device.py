"""Device resolution for the port's entry points (no reference counterpart:
JAX places arrays on its default backend implicitly)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is wanted (explicitly or by default)
    but absent — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return dev
