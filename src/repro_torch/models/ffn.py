"""Feed-forward layers, in PyTorch: the dense MLP (SwiGLU / GELU) and the
top-k mixture of experts.

Port of ``repro.models.ffn``.  The MoE keeps the reference's
capacity-based dense dispatch: one-hot dispatch and combine tensors and
``einsum``s over them, filled slot by slot.  The routed experts are plain
``torch.einsum``s (as they are ``jnp.einsum``s there, outside any Pallas
kernel), the router is a ``dense`` call that the default site policy keeps
digital, and the shared experts are a dense MLP through the engine.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import P, ModelConfig, dense, qdense_def, with_logical
from repro_torch.photonic import EpilogueSpec


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


def moe_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.ffn:moe_def``: the router, the stacked
    routed experts ``wi (E, d, 2f)`` and ``wo (E, f, d)``, and the shared
    experts as one MLP of width ``num_shared_experts * f``."""
    d, f, e = cfg.d_model, cfg.moe_hidden, cfg.num_experts
    defs: Dict[str, Any] = {
        "router": qdense_def(cfg, d, e, (None, None), init="normal"),
        "wi": P((e, d, 2 * f), ("experts", None, None)),
        "wo": P((e, f, d), ("experts", None, None), fan_axis=1),
    }
    if cfg.num_shared_experts:
        defs["shared"] = mlp_def(cfg, cfg.num_shared_experts * f)
    return defs


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert and batch row.  Reference: ``repro.models.ffn:_capacity``."""
    c = int(tokens * cfg.num_experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(c, 1)


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest gates and their experts, ties to the lower index
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params, x: torch.Tensor, cfg: ModelConfig, layer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, aux load-balancing loss)``.  Reference:
    ``repro.models.ffn:moe``.

    The router is ``dense(site="ffn.router")`` on ``x`` in f32, digital
    under the default site policy; its softmax, top-k and renormalization
    are f32.  Tokens take slots in order along T, per batch row, slot by
    slot; a token whose expert is full is dropped for that expert.  The
    one-hot over slots is a compare with ``arange`` so that a position
    past the capacity gives a zero row, as ``jax.nn.one_hot`` does.  The
    combine weights are f32 and round to ``x.dtype`` before the last
    ``einsum``."""
    b, t, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = _capacity(cfg, t)
    dev = x.device

    logits = dense(params["router"], x.to(torch.float32), cfg, site="ffn.router", layer=layer)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates, k)
    topv = topv / torch.maximum(topv.sum(-1, keepdim=True), torch.full((), 1e-9, device=dev))

    experts = torch.arange(e, device=dev)
    slots = torch.arange(cap, device=dev)
    dispatch = torch.zeros((b, t, e, cap), dtype=x.dtype, device=dev)
    combine = torch.zeros((b, t, e, cap), dtype=torch.float32, device=dev)
    used = torch.zeros((b, e), dtype=torch.int64, device=dev)
    for slot in range(k):
        mask = (topi[..., slot, None] == experts).to(torch.int64)  # (B, T, E)
        pos = torch.cumsum(mask, dim=1) - 1 + used[:, None, :]
        ok = (pos < cap) & (mask > 0)
        oh = ((pos[..., None] == slots) & ok[..., None]).to(x.dtype)  # (B, T, E, C)
        dispatch = dispatch + oh * mask[..., None].to(x.dtype)
        combine = combine + oh.to(torch.float32) * (mask[..., None] * topv[..., slot, None, None])
        used = used + mask.sum(dim=1)

    xin = torch.einsum("btec,btd->becd", dispatch, x)  # (B, E, C, D)
    xin = with_logical(xin, ("batch", "experts", None, None))
    h = torch.einsum("becd,edf->becf", xin, params["wi"].to(x.dtype))
    u, g = torch.chunk(h, 2, dim=-1)
    h = u * F.silu(g)
    out_e = torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))
    out_e = with_logical(out_e, ("batch", "experts", None, None))
    out = torch.einsum("btec,becd->btd", combine.to(x.dtype), out_e)

    if cfg.num_shared_experts:
        out = out + mlp(params["shared"], x, cfg, layer=layer, site="ffn.shared")

    # Switch-style load-balancing loss: E * sum_e f_e * p_e.
    frac = torch.mean((topi[..., 0, None] == experts).to(torch.float32), dim=(0, 1))
    prob = torch.mean(gates, dim=(0, 1))
    aux = e * torch.sum(frac * prob)
    return out, aux
