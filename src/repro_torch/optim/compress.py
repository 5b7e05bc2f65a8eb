"""Gradient compression for data-parallel training.

Port of ``repro.optim.compress``.  The reference runs inside ``shard_map``
over a named mesh axis; here a collective runs over a ``torch.distributed``
process group (``None``: the default group) and every rank calls it with
its own tree.

* :func:`compressed_psum` — int8-quantized all-reduce: each leaf is
  symmetric-quantized at the largest per-rank scale (an ``all_reduce(MAX)``
  of the scales), the int8 codes are summed in int32 (exact) and the sum is
  dequantized with that scale.
* :func:`ring_int8_allreduce` — an all-reduce whose wire carries int8: a
  reduce-scatter ring of quantized chunks (each rank sends to
  ``(rank + 1) % n`` and receives from ``(rank - 1) % n``, accumulating in
  f32) and then an all-gather ring, quantizing at every hop, in the
  reference's order.  The owner of a chunk keeps its f32 sum and the others
  hold its requantized copies, so ranks may differ by a quantization step,
  as the reference's devices do.
* :func:`quantize_dequantize`, :func:`with_error_feedback` — the
  per-step residual carried into the next step's gradients.

Every collective and hop goes through :mod:`repro_torch.runtime.collectives`,
which stages CUDA tensors through host tensors on a ``gloo`` group (the
int8 payload and its f32 scale are copied to the host, exchanged, and
copied back); ``nccl`` groups exchange the CUDA tensors themselves.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_items, tree_map, tree_unflatten
from repro_torch.runtime import collectives


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 codes, f32 scale)`` at the leaf's abs-max: ``scale =
    max(amax, 1e-12) x (1/127)``, codes ``clip(round(g / scale))``.  A
    zero-size leaf (zero-layer variants) gets scale 1.  Reference:
    ``repro.optim.compress:_quantize``."""
    if g.numel() == 0:
        return g.to(torch.int8), torch.ones((), dtype=torch.float32, device=g.device)
    amax = g.abs().max().to(torch.float32)
    scale = torch.maximum(amax, _f32(1e-12, amax)) * _f32(1.0 / 127.0, amax)
    return _codes(g, scale), scale


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127).to(torch.int8)


def _group(group):
    return dist.group.WORLD if group is None else group


def compressed_psum(tree: Any, group=None) -> Any:
    """int8 all-reduce of a tree over ``group``: per leaf, the scales'
    maximum over the group, the leaf's codes at that scale summed in int32,
    the sum dequantized with it, in the leaf's dtype.  Reference:
    ``repro.optim.compress:compressed_psum``."""
    group = _group(group)

    def leaf(g):
        _, scale = _quantize(g)
        # The largest scale, so every rank dequantizes alike.
        collectives.all_reduce(scale, dist.ReduceOp.MAX, group=group)
        total = _codes(g, scale).to(torch.int32)
        collectives.all_reduce(total, group=group)
        return (total.to(torch.float32) * scale).to(g.dtype)

    return tree_map(leaf, tree)


def ring_int8_allreduce(tree: Any, group=None) -> Any:
    """All-reduce with int8 on the wire: per leaf, the f32 values padded to
    a multiple of ``n`` and cut into ``n`` chunks (chunk ``c`` owned by rank
    ``c``); ``n - 1`` reduce-scatter hops (at hop ``s`` rank ``d`` sends
    its chunk ``d - s``, quantized, and adds the received codes times their
    scale into chunk ``d - s - 1``), then ``n - 1`` all-gather hops (rank
    ``d`` sends chunk ``d + 1 - t``, quantized, and overwrites chunk
    ``d - t`` with the received one), in the leaf's dtype.  The identity on
    a group of one.  Reference: ``repro.optim.compress:ring_int8_allreduce``."""
    group = _group(group)
    n = dist.get_world_size(group)
    if n == 1:
        return tree
    idx = dist.get_rank(group)
    nxt, prv = (idx + 1) % n, (idx - 1) % n

    def leaf(g):
        if g.numel() == 0:
            return g
        flat = g.to(torch.float32).reshape(-1)
        pad = (-flat.numel()) % n
        acc = torch.cat([flat, flat.new_zeros(pad)]).reshape(n, -1)
        for s in range(n - 1):
            q, scale = _quantize(acc[(idx - s) % n])
            q_recv, s_recv = collectives.exchange([q, scale], group, nxt, prv)
            r = (idx - s - 1) % n
            acc[r] = acc[r] + q_recv.to(torch.float32) * s_recv
        # rank d now owns the fully reduced chunk (d + 1) % n
        for t in range(n - 1):
            q, scale = _quantize(acc[(idx + 1 - t) % n])
            q_recv, s_recv = collectives.exchange([q, scale], group, nxt, prv)
            acc[(idx - t) % n] = q_recv.to(torch.float32) * s_recv
        return acc.reshape(-1)[: g.numel()].reshape(g.shape).to(g.dtype)

    return tree_map(leaf, tree)


def quantize_dequantize(tree: Any) -> Tuple[Any, Any]:
    """``(compressed value, residual)`` per leaf, each a tree shaped like
    ``tree``: the error-feedback building block.  Reference:
    ``repro.optim.compress:quantize_dequantize``."""
    items = tree_items(tree)
    comp, resid = [], []
    for g in items.values():
        q, scale = _quantize(g)
        deq = (q.to(torch.float32) * scale).to(g.dtype)
        comp.append(deq)
        resid.append(g - deq)
    return tree_unflatten(tree, comp), tree_unflatten(tree, resid)


def with_error_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Add the carried residual, compress, and return ``(compressed, new
    residual)``.  Reference: ``repro.optim.compress:with_error_feedback``."""
    fed = tree_map(lambda g, r: g + r.to(g.dtype), grads, residual)
    return quantize_dequantize(fed)
