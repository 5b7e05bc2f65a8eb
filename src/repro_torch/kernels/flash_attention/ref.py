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


# ---------------------------------------------------------------------------
# The bf16 gate: an f64 oracle and a forward-error bound
# ---------------------------------------------------------------------------
def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``x``: ``2^(floor(log2|x|) - 7)``,
    and the smallest normal's ulp at zero."""
    _, e = torch.frexp(x.abs().clamp(min=2.0**-126))
    return torch.ldexp(torch.ones_like(x), (e - 8).to(torch.int32))


def oracle_and_bound(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    scale: float,
    causal: bool,
    q_offset: int,
    kv_valid: int,
    bk: int,
) -> tuple:
    """``(o, b)``, both float64 ``(B, Tq, H, hd)``: the exact attention of
    the given (bf16-exact) inputs and the rounding a float32 kernel may add
    to it.  A result ``got`` passes where :func:`gate_ratio` is <= 1, i.e.

        |got - o| <= max(ulp_bf16(o), ulp_bf16(got)) + b,
        b = 2^-22 * (n_i * S + (hd + 16) * A_i * (S + |o|)),

    per row ``i`` of each head: ``S = (P @ |V|) / l`` is the magnitude of
    the terms summed into the output, ``A_i = max over live j of scale *
    |q_i| * |k_j|`` the score magnitude, ``n_i`` the number of live keys.
    That is the first-order bound of f32 recursive summation (the ``n_i S``
    of P.V and l) plus the rounding of the hd-term scores carried through
    ``exp`` (``hd A_i``, each score error moving the output by up to
    ``S + |o|``), with a factor 4 (2^-22 = 4 * 2^-24) for the few further
    roundings (``exp``, ``corr``, the division) and 16 more score terms
    for the scaling.  The constants are fixed, not fitted.

    Live keys are ``j < kv_valid`` and, when causal, ``j <= q_offset + i``.
    A row with no live key follows the reference kernel: every one of the
    ``round_up(Tk, bk)`` logical keys takes part with ``p = 1`` (V is zero
    past ``Tk``), so ``o`` is the mean of that padded V, those keys are its
    terms (``n_i``, ``S``) and no score enters it (``A_i = 0``).

    Computed per head in float64 with matmuls, so ``T = 4096`` fits."""
    b_, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    f64 = torch.float64
    dev = q.device
    kv_pos = torch.arange(tk, device=dev)
    live = (kv_pos < kv_valid)[None, :].expand(tq, tk)
    if causal:
        live = live & (kv_pos[None, :] <= (q_offset + torch.arange(tq, device=dev))[:, None])
    n_live = live.sum(-1).to(f64)[:, None]  # (Tq, 1)
    empty = n_live[:, 0] == 0
    n_logical = float(-(-tk // bk) * bk)
    o = torch.empty((b_, tq, h, hd), dtype=f64, device=dev)
    bound = torch.empty_like(o)
    for bi in range(b_):
        for g in range(kvh):
            kf = k[bi, :, g].to(f64)  # (Tk, hd)
            vf = v[bi, :, g].to(f64)
            va = vf.abs()
            knorm = torch.linalg.vector_norm(kf, dim=-1)
            kmax = torch.where(live, knorm[None, :], torch.zeros((), dtype=f64, device=dev)).amax(-1)
            for hh in range(g * n_rep, (g + 1) * n_rep):
                qf = q[bi, :, hh].to(f64)  # (Tq, hd)
                s = (qf @ kf.T) * scale
                s = s.masked_fill(~live, float("-inf"))
                m = s.amax(-1, keepdim=True)
                p = torch.exp(s - torch.where(empty[:, None], torch.zeros_like(m), m))
                p = p.masked_fill(~live, 0.0)
                l_sum = p.sum(-1, keepdim=True)
                l_sum = torch.where(empty[:, None], torch.full_like(l_sum, n_logical), l_sum)
                p = torch.where(empty[:, None], torch.ones_like(p), p)  # empty rows: p = 1 over Tk
                oo = (p @ vf) / l_sum
                ss = (p @ va) / l_sum
                nn = torch.where(empty[:, None], torch.full_like(n_live, n_logical), n_live)
                a = scale * torch.linalg.vector_norm(qf, dim=-1, keepdim=True) * kmax[:, None]
                o[bi, :, hh] = oo
                bound[bi, :, hh] = 2.0**-22 * (nn * ss + (hd + 16) * a * (ss + oo.abs()))
    return o, bound


def gate_ratio(got: torch.Tensor, o: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|got - o| / (max(ulp_bf16(o), ulp_bf16(got)) + b)`` in float64 for
    the ``(o, b)`` of :func:`oracle_and_bound`; ``got`` passes where it is
    <= 1 everywhere."""
    g = got.to(torch.float64)
    return (g - o).abs() / (torch.maximum(bf16_ulp(o), bf16_ulp(g)) + b)
