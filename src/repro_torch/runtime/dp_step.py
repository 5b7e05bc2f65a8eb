"""The data-parallel train step: replicated parameters, one gradient
reduction.

Port of ``repro.runtime.dp_step``.  The reference pins the step with
``shard_map``: params and optimizer state replicated, the batch sharded
over the mesh's data-parallel axes, gradients averaged once (``pmean``
over every axis, or the int8 ring of ``repro.optim.compress``), the
update replicated.  The port is SPMD over ``torch.distributed``: every
rank calls the step with the same params, state and global batch, takes
its rows of the batch, and the averages are collectives over all the
mesh's ranks.  With ``tp_axis`` the routed GEMMs K-shard over that axis
under ``manual_tp`` (the rank's group on the axis); TP peers hold the same
rows and so the same gradients, and the one reduction over every rank
stays correct unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch._tree import tree_items, tree_unflatten
from repro_torch.data.pipeline import local_rows
from repro_torch.optim import adamw
from repro_torch.optim.compress import ring_int8_allreduce
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shd


def _mesh_group(mesh):
    """The default group, which the mesh must span in rank order (the
    reference's reduction runs over every mesh axis)."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the DP step's mesh must span the default group in rank order; it holds ranks {ranks}")
    return dist.group.WORLD


def _pmean(tree, group, n_dev: int):
    """Average ``tree`` over ``group`` in place of the reference's ``pmean``:
    the leaves flattened into one buffer per dtype, one ``all_reduce(SUM)``
    each, then each leaf divided by ``n_dev`` in its dtype.  Returns the
    averaged tree."""
    items = tree_items(tree)
    by_dtype = {}
    for k, g in items.items():
        by_dtype.setdefault(g.dtype, []).append(k)
    out = {}
    for dtype, keys in by_dtype.items():
        flat = torch.cat([items[k].reshape(-1) for k in keys])
        collectives.all_reduce(flat, group=group)
        at = 0
        for k in keys:
            g = items[k]
            out[k] = flat[at : at + g.numel()].view(g.shape) / n_dev
            at += g.numel()
    return tree_unflatten(tree, [out[k] for k in items])


def make_dp_train_step(
    loss_fn: Callable,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    *,
    compress_grads: bool = False,
    tp_axis: Optional[str] = None,
) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm)`` on ``mesh`` (a :class:`DeviceMesh` with named axes): this
    rank's rows of the global ``batch`` over the data-parallel axes (every
    axis but ``tp_axis``, row-major), the loss and its gradient (under
    ``manual_tp(tp_axis)`` with the rank's group on that axis), the
    gradients averaged over all ranks (or summed by
    :func:`~repro_torch.optim.compress.ring_int8_allreduce` and divided when
    ``compress_grads``), the loss averaged, and ``adamw.update``.  Raises
    ``ValueError`` for a ``tp_axis`` the mesh lacks.  Reference:
    ``repro.runtime.dp_step:make_dp_train_step``."""
    from repro_torch.runtime.train_loop import _value_and_grad

    sizes = shd.mesh_axis_sizes(mesh)
    axes = tuple(sizes)
    if tp_axis is not None and tp_axis not in axes:
        raise ValueError(f"tp_axis {tp_axis!r} not in mesh axes {axes}")
    n_dev = math.prod(sizes.values())
    dp_axes = tuple(a for a in axes if a != tp_axis)
    batch_sharding = shd.NamedSharding(mesh, (dp_axes,))
    group = _mesh_group(mesh)
    tp_group = mesh.get_group(tp_axis) if tp_axis is not None else None

    def step(params, opt_state, batch):
        local = {k: local_rows(v, batch_sharding) for k, v in batch.items()}
        # logical constraints are the reference's GSPMD hints; none here
        with shd.no_constraints():
            if tp_axis is not None:
                from repro_torch.photonic import sharded as tp_sharded

                with tp_sharded.manual_tp(tp_axis, group=tp_group):
                    loss, grads = _value_and_grad(loss_fn, params, local)
            else:
                loss, grads = _value_and_grad(loss_fn, params, local)
        if compress_grads:
            # the int8-wire ring halves the only collective's bytes
            grads = ring_int8_allreduce(grads, group)
            grads = tree_unflatten(grads, [(g / n_dev).to(g.dtype) for g in tree_items(grads).values()])
        else:
            grads = _pmean(grads, group, n_dev)
        loss = _pmean(loss.to(torch.float32), group, n_dev)
        params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, loss, metrics["grad_norm"]

    return step
