"""The port's collectives: every data collective of ``torch.distributed``
the port issues goes through this module.

On a ``gloo`` group a CUDA tensor is staged through the host: a
synchronous copy to a pinned host tensor on the current stream (the copy
waits for every kernel queued before it, and returns once the bytes have
landed), the collective on the host tensors, and a ``copy_`` back into the
CUDA tensor on the current stream, which orders it before any kernel
queued after.  Nothing of gloo's own CUDA path (its copies on an internal
stream, their events and its asynchronous copy back) is used, so every
rank's result is in place, and the same, when a later kernel reads it.
On ``nccl``, and for host tensors, the tensors pass through as they are.

* :func:`all_reduce` — in place, ``op`` SUM by default;
* :func:`all_gather` — ``parts`` (one per rank, preallocated) from ``t``;
* :func:`reduce_scatter` — ``out`` from the SUM of every rank's
  ``inputs[rank]``;
* :func:`exchange` — send tensors to one rank of the group and receive as
  many from another (the int8 ring's hop).

Callers count their collectives as before (``repro_torch.analysis.
contracts``); these functions count nothing.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def _group(group):
    return dist.group.WORLD if group is None else group


def staged(t: torch.Tensor, group=None) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through host
    tensors: a CUDA tensor on a ``gloo`` group."""
    return t.is_cuda and dist.get_backend(_group(group)) == "gloo"


def _empty_host(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="cpu", pin_memory=True)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``, complete when this
    returns (a blocking copy: it synchronizes with the current stream)."""
    return _empty_host(t.shape, t.dtype).copy_(t)


def all_reduce(t: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """``t`` all-reduced in place over ``group`` with ``op`` (SUM when
    ``None``); returns ``t``."""
    op = dist.ReduceOp.SUM if op is None else op
    if not staged(t, group):
        dist.all_reduce(t, op=op, group=group)
        return t
    h = _host(t)
    dist.all_reduce(h, op=op, group=group)
    return t.copy_(h)


def all_gather(parts: List[torch.Tensor], t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` into ``parts`` (one preallocated tensor per rank
    of ``group``, in rank order); returns ``parts``."""
    if not staged(t, group):
        dist.all_gather(parts, t, group=group)
        return parts
    hosts = [_empty_host(p.shape, p.dtype) for p in parts]
    dist.all_gather(hosts, _host(t), group=group)
    for p, h in zip(parts, hosts):
        p.copy_(h)
    return parts


def reduce_scatter(out: torch.Tensor, inputs: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """``out`` = the SUM over the ranks of ``group`` of their
    ``inputs[rank]`` (one tensor per rank, each shaped as ``out``); returns
    ``out``."""
    if not staged(out, group):
        dist.reduce_scatter(out, list(inputs), op=dist.ReduceOp.SUM, group=group)
        return out
    h = _empty_host(out.shape, out.dtype)
    dist.reduce_scatter(h, [_host(t) for t in inputs], op=dist.ReduceOp.SUM, group=group)
    return out.copy_(h)


def exchange(tensors: Sequence[torch.Tensor], group, dst: int, src: int) -> List[torch.Tensor]:
    """Send ``tensors`` to group rank ``dst`` and receive as many (same
    shapes and dtypes) from group rank ``src``, one tensor at a time;
    returns the received tensors on the senders' device."""
    group = _group(group)
    out = []
    for t in tensors:
        host = staged(t, group)
        send = _host(t) if host else t.contiguous()
        recv = _empty_host(t.shape, t.dtype) if host else torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group),
               dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out.append(recv.to(t.device) if host else recv)
    return out
