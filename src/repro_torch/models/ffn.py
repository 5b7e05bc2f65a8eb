"""Feed-forward layers, in PyTorch: the dense MLP (SwiGLU / GELU) and the
top-k mixture of experts.

Port of ``repro.models.ffn``.  The MoE keeps the reference's
capacity-based dense dispatch: one-hot dispatch and combine tensors and
``einsum``s over them, filled slot by slot.  The routed experts are plain
``torch.einsum``s (as they are ``jnp.einsum``s there, outside any Pallas
kernel), the router is a ``dense`` call that the default site policy keeps
digital, and the shared experts are a dense MLP through the engine.

Under a placement of ``"experts"`` over ``model`` (the MoE decoders'
placed parameters) the MoE is expert-parallel, as the reference's GSPMD
partitions it: a rank holds its block of the expert stacks, builds the
dispatch and combine of its experts only, and the ranks' partial outputs
meet in one SUM all-reduce (the combine contracts over the experts).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import P, ModelConfig, dense, qdense_def, with_logical
from repro_torch.photonic import EpilogueSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import block, copy_to_model, mean_over_rows, reduce_rows


def mlp_def(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, Any]:
    """Reference: ``repro.models.ffn:mlp_def``."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    swiglu = cfg.ffn_act == "swiglu"
    return {
        "wi": qdense_def(cfg, d, 2 * f if swiglu else f, (None, "d_ff"), parts=(f, f) if swiglu else ()),
        "wo": qdense_def(cfg, f, d, ("d_ff", None)),
    }


def columns_placed(params, cfg: ModelConfig) -> bool:
    """Whether :func:`mlp`'s ``wi``, the one GEMM that reads its input, is
    column-parallel on this rank's columns of a placed weight (the
    Megatron entry of ``sharding.seq_block``)."""
    placed, wo = block("d_ff"), params["wo"]["w"]
    if placed is None or not isinstance(wo, torch.Tensor):
        return False
    cols = (("d_ff", wo.shape[-2] * placed.count),) * (2 if cfg.ffn_act == "swiglu" else 1)
    return shd.placed_columns(params["wi"]["w"], cols)


def mlp(params, x: torch.Tensor, cfg: ModelConfig, layer=None, site="ffn") -> torch.Tensor:
    """Reference: ``repro.models.ffn:mlp``.  SwiGLU splits the GEMM output
    before gating, so its split and ``silu`` are digital; gelu rides the
    fused epilogue.

    Under a placement of ``"d_ff"`` over ``model`` (placed parameters)
    ``wi`` is column-parallel and ``wo`` row-parallel over ``d_ff``, and
    the hidden activation is this rank's block.
    SwiGLU's ``wi`` is ``[u | g]`` on one ``d_ff``-named axis of width
    ``2f``, so a contiguous block of it would give half the ranks only
    ``u``: a rank holds its block of ``u`` and its block of ``g`` (the same
    bytes a rank as the reference's spec; the reference's GSPMD reshards
    the ``2f`` axis around the split instead), the two halves' columns at
    global origins ``c0`` and ``f + c0``.  The hidden width ``f`` is read
    off ``wo``: its rows, of which a placed tensor holds its block
    (``place_params``; a prepacked bank stays whole)."""
    cols, placed = None, block("d_ff")
    if placed is not None:
        wo = params["wo"]["w"]
        f = wo.shape[-2] * placed.count if isinstance(wo, torch.Tensor) else wo.k
        cols = (("d_ff", f),) * (2 if cfg.ffn_act == "swiglu" else 1)
    if cfg.ffn_act == "swiglu":
        h = dense(params["wi"], x, cfg, site=f"{site}.wi", layer=layer, columns=cols)
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.silu(g)
    else:
        h = dense(
            params["wi"], x, cfg, site=f"{site}.wi", layer=layer,
            epilogue=EpilogueSpec(activation="gelu"), columns=cols,
        )
    return dense(params["wo"], h, cfg, site=f"{site}.wo", layer=layer, k_local="d_ff")


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


def _dispatch(topi: torch.Tensor, topv: torch.Tensor, experts: torch.Tensor, cap: int, dtype):
    """The capacity-ranked ``(dispatch, combine)``, ``(B, T, E', C)`` in
    ``dtype`` and f32, of the ``E'`` experts numbered ``experts`` (all of
    them, or a rank's block): tokens take slots in order along T, per batch
    row, slot by slot; a token whose expert is full is dropped for that
    expert.  An expert's slots depend on its own column of the one-hot
    choices alone, so a block's are those columns of the whole, bit for
    bit.  The one-hot over slots is a compare with ``arange`` so that a
    position past the capacity gives a zero row, as ``jax.nn.one_hot``
    does."""
    b, t, k = topi.shape
    dev = topi.device
    slots = torch.arange(cap, device=dev)
    dispatch = torch.zeros((b, t, experts.shape[0], cap), dtype=dtype, device=dev)
    combine = torch.zeros((b, t, experts.shape[0], cap), dtype=torch.float32, device=dev)
    used = torch.zeros((b, experts.shape[0]), dtype=torch.int64, device=dev)
    for slot in range(k):
        mask = (topi[..., slot, None] == experts).to(torch.int64)  # (B, T, E')
        pos = torch.cumsum(mask, dim=1) - 1 + used[:, None, :]
        ok = (pos < cap) & (mask > 0)
        oh = ((pos[..., None] == slots) & ok[..., None]).to(dtype)  # (B, T, E', C)
        dispatch = dispatch + oh * mask[..., None].to(dtype)
        combine = combine + oh.to(torch.float32) * (mask[..., None] * topv[..., slot, None, None])
        used = used + mask.sum(dim=1)
    return dispatch, combine


def _expert_inputs(x: torch.Tensor, topv: torch.Tensor, part):
    """``(x, topv)`` as the inputs of a rank's experts over the mesh axes
    ``part``: unchanged; their gradients, each rank's from its own experts'
    slots, summed over ``part`` in one f32 all-reduce in the backward
    (``copy_to_model``).  The router's other use of the gates, the aux
    loss, reads them whole on every rank and is not summed."""
    if not torch.is_grad_enabled():
        return x, topv
    both = copy_to_model(torch.cat([x.to(torch.float32), topv], dim=-1), part, "expert_input")
    return both[..., : x.shape[-1]].to(x.dtype), both[..., x.shape[-1]:]


def moe(params, x: torch.Tensor, cfg: ModelConfig, layer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, aux load-balancing loss)``.  Reference:
    ``repro.models.ffn:moe``.

    The router is ``dense(site="ffn.router")`` on ``x`` in f32, digital
    under the default site policy; its softmax, top-k and renormalization
    are f32.  Dispatch and combine as :func:`_dispatch` builds them.  The
    combine weights are f32 and round to ``x.dtype`` before the last
    ``einsum``.

    Expert-parallel under a placement of ``"experts"``: the router stays
    whole on every rank; a rank dispatches to its block of experts only,
    runs its ``wi`` / ``wo`` block (``params`` holds the placed stacks), and
    its partial combine, in f32, is summed over the experts' mesh axes
    (``reduce_from_model``, one ``PARAM_REDUCES["expert_combine"]``): the
    reference's GSPMD sum over the experts axis, the floats added in
    another order than the replicated ``einsum``'s."""
    b, t, _ = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = _capacity(cfg, t)
    dev = x.device

    logits = dense(params["router"], x.to(torch.float32), cfg, site="ffn.router", layer=layer)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates, k)
    topv = topv / torch.maximum(topv.sum(-1, keepdim=True), torch.full((), 1e-9, device=dev))

    # The shared experts first: their GEMMs read x alone, so an
    # expert-parallel rank runs them before any float is summed in another
    # order (``out`` adds them last, as the reference does).
    shared = None
    if cfg.num_shared_experts:
        shared = mlp(params["shared"], x, cfg, layer=layer, site="ffn.shared")

    experts = torch.arange(e, device=dev)
    xe = x
    eb = block("experts")
    if eb is not None:
        mine = experts[eb.index * eb.local: (eb.index + 1) * eb.local]
        xe, topv = _expert_inputs(x, topv, eb.part)
    dispatch, combine = _dispatch(topi, topv, experts if eb is None else mine, cap, x.dtype)

    xin = torch.einsum("btec,btd->becd", dispatch, xe)  # (B, E, C, D)
    xin = with_logical(xin, ("batch", "experts", None, None))
    h = torch.einsum("becd,edf->becf", xin, params["wi"].to(x.dtype))
    u, g = torch.chunk(h, 2, dim=-1)
    h = u * F.silu(g)
    out_e = torch.einsum("becf,efd->becd", h, params["wo"].to(x.dtype))
    out_e = with_logical(out_e, ("batch", "experts", None, None))
    if eb is None:
        out = torch.einsum("btec,becd->btd", combine.to(x.dtype), out_e)
    else:
        part = torch.einsum("btec,becd->btd", combine.to(x.dtype).to(torch.float32), out_e.to(torch.float32))
        out = reduce_rows(part, eb.part, "expert_combine").to(x.dtype)

    if shared is not None:
        # inside a block's Megatron form either sum may be this rank's positions alone: cut the other
        out, shared = (shd.seq_scatter(t, None) if t.shape[1] > min(out.shape[1], shared.shape[1]) else t
                       for t in (out, shared))
        out = out + shared

    # Switch-style load-balancing loss: E * sum_e f_e * p_e.  With placed
    # rows f is the mean over every rank's rows and p this rank's: the
    # step's mean of the ranks' losses is then the global aux, and its
    # gradient (through p) the global one.
    frac = mean_over_rows(torch.mean((topi[..., 0, None] == experts).to(torch.float32), dim=(0, 1)))
    prob = torch.mean(gates, dim=(0, 1))
    aux = e * torch.sum(frac * prob)
    return out, aux
