"""The reference's ``examples/`` on the port: ``quickstart``, ``serve_lm``,
``train_lm``, ``map_workload`` and ``paper_repro``, each run as
``python -m repro_torch.examples.<name>`` with the reference script's
sizes, operating points and seeds, printing its lines.

Each takes ``--device`` (``cuda`` unless asked otherwise) and exposes
``main(argv=None) -> dict`` of the values it prints.  On the card the
photonic GEMMs take the ``kernel`` backend (the CUDA kernels); on the CPU
the ``ref`` backend, as the reference's scripts do.
"""

import torch

from repro_torch._device import resolve_device


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def backend_for(device: torch.device) -> str:
    """The photonic backend an example runs on ``device``."""
    return "kernel" if resolve_device(device).type == "cuda" else "ref"
