"""Plain PyTorch oracle for the flash-attention kernel: exact softmax
attention with GQA head grouping, causal masking and kv-length masking.

Port of ``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_valid: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference: ``repro.kernels.flash_attention.ref:attention_ref``."""
    b, tq, h, hd = q.shape
    _, tk, kvh, _ = k.shape
    rep = h // kvh
    scale = scale if scale is not None else hd**-0.5
    kf = torch.repeat_interleave(k, rep, dim=2).to(torch.float32)
    vf = torch.repeat_interleave(v, rep, dim=2).to(torch.float32)
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32) * scale, kf)
    kv_pos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if kv_valid is not None:
        mask &= (kv_pos < kv_valid)[None, :]
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, vf)
    return out.to(q.dtype)
