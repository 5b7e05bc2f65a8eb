"""Public entry points for the photonic GEMM kernel.

Port of ``repro.kernels.photonic_gemm.ops``: thin compatibility wrappers
that delegate to :class:`repro_torch.photonic.engine.PhotonicEngine` with
``site=None`` (no site folding) — same backend dispatch, same tiling, same
seed derivation as the engine.  New code should use the engine directly
(per-site routing, prepacked weights, threaded PRNG keys).

``photonic_gemm(x, w, cfg)`` — float in/out, quantize → kernel → dequantize.
Backend selection:

* ``"kernel"``  — the hand-written CUDA kernel (the reference's
                  ``"pallas"``); on a CPU tensor its plain twin, which is
                  taken only because the caller put the operands on the CPU;
* ``"ref"``     — the untiled torch oracle;
* ``"exact"``   — plain int GEMM of the quantized operands (the ideal the
                  DPU converges to).

The reference's ``interpret`` switch has no counterpart: the operands'
device picks the kernel or its twin, and any other device raises.  Noisy
calls need ``prng_key`` (a :mod:`repro_torch.prng` key) or
``cfg.noise_seed``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dpu import DPUConfig
from repro_torch.photonic.engine import engine_for


def photonic_gemm_int(
    xq: torch.Tensor,
    wq: torch.Tensor,
    cfg: DPUConfig,
    *,
    backend: str = "kernel",
    tile_r: int = 128,
    tile_c: int = 128,
    prng_key=None,
) -> torch.Tensor:
    """Integer-level DPU GEMM with automatic padding to kernel tiles.
    Reference: ``repro.kernels.photonic_gemm.ops:photonic_gemm_int``."""
    eng = engine_for(cfg, backend)
    return eng.int_gemm(xq, wq, prng_key=prng_key, tile_r=tile_r, tile_c=tile_c)


def photonic_gemm(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: DPUConfig = DPUConfig(),
    backend: str = "kernel",
    prng_key=None,
) -> torch.Tensor:
    """Float GEMM through the photonic DPU; differentiable by the
    straight-through estimator.  Reference:
    ``repro.kernels.photonic_gemm.ops:photonic_gemm``."""
    return engine_for(cfg, backend).matmul_float(x, w, prng_key=prng_key)
