"""Feed-forward layer (dense MLP), in PyTorch.

Port of ``repro.models.ffn`` (the MoE layer waits for its slice).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.photonic_gemm.epilogue import EpilogueSpec
from repro_torch.models.common import ModelConfig, dense, qdense_def


def mlp_def(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, Any]:
    """Reference: ``repro.models.ffn:mlp_def``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    width = 2 * f if cfg.ffn_act == "swiglu" else f
    return {
        "wi": qdense_def(cfg, d, width, (None, "d_ff")),
        "wo": qdense_def(cfg, f, d, ("d_ff", None)),
    }


def mlp(params, x: torch.Tensor, cfg: ModelConfig, layer=None, site="ffn") -> torch.Tensor:
    """Reference: ``repro.models.ffn:mlp``.  SwiGLU splits the GEMM output
    before gating, so its split and ``silu`` are digital; gelu rides the
    fused epilogue."""
    if cfg.ffn_act == "swiglu":
        h = dense(params["wi"], x, cfg, site=f"{site}.wi", layer=layer)
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.silu(g)
    else:
        h = dense(
            params["wi"], x, cfg, site=f"{site}.wi", layer=layer,
            epilogue=EpilogueSpec(activation="gelu"),
        )
    return dense(params["wo"], h, cfg, site=f"{site}.wo", layer=layer)
