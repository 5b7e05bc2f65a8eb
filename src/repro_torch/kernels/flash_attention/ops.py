"""Layout and block-size handling in front of the flash-attention kernel.

Port of ``repro.kernels.flash_attention.ops``.  The reference pads ``T`` to
the blocks and transposes to the TPU's ``(B, H, T, hd)``; the port hands
the ``(B, T, H, hd)`` tensors to :func:`flash_attention_fwd` as they are
(the CUDA kernel reads strides and masks the ragged edge; the CPU twin
pads for itself)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import _round_up, flash_attention_fwd


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid: Optional[int] = None,
    scale: Optional[float] = None,
    bq: int = 128,
    bk: int = 128,
) -> torch.Tensor:
    """Reference: ``repro.kernels.flash_attention.ops:flash_attention``
    (the ``interpret`` switch has no counterpart: the tensor's device picks
    the kernel or its twin)."""
    _, tq, h, hd = q.shape
    _, tk, kvh, _ = k.shape
    scale = scale if scale is not None else hd**-0.5
    kv_valid = tk if kv_valid is None else kv_valid
    return flash_attention_fwd(
        q, k, v,
        scale=scale,
        causal=causal,
        q_offset=q_offset,
        kv_valid=min(kv_valid, tk),
        n_rep=h // kvh,
        bq=min(bq, _round_up(tq, 8)),
        bk=min(bk, _round_up(tk, 8)),
    )
