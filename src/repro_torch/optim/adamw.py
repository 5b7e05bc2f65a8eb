"""AdamW with decoupled weight decay, global-norm clipping and LR schedules.

Port of ``repro.optim.adamw``, spelled as plain tensor ops over the
parameter tree in the reference's order (``torch.optim.AdamW`` places eps
and the decay differently).  The moments are f32 whatever the parameter
dtype, so bf16 parameters keep f32 statistics; the step counter is a 0-dim
int32 tensor on the parameters' device, and the schedule is computed from
it in f32 tensor ops as the reference computes it from its array.

ZeRO-1 (:class:`Zero1`, the reference dry run's train step,
``repro.launch.dryrun``): each moment leaf holds this rank's block along
the dimension ``zero1_axes`` names, and :func:`update` runs the
elementwise step on the matching blocks of the gradient and parameter,
then all-gathers the updated parameter over the data axes.  Given the same
gradient it is bitwise the replicated update.

Placed parameters (:class:`Placed`, the dry run's train step on the dense
and MoE decoders' blocks, expert stacks included): a leaf that is this
rank's block contributes its
squares to the gradient norm summed over the mesh axes it is placed over,
a leaf held whole contributes them once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import tree_items, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Reference: ``repro.optim.adamw:AdamWConfig`` (same fields and
    defaults)."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


class OptState(NamedTuple):
    """Reference: ``repro.optim.adamw:OptState``."""

    step: torch.Tensor  # 0-dim int32
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class Zero1:
    """The ZeRO-1 layout of the moments: ``dims`` is a tree like the
    params holding the dimension each leaf's moments split along (``None``:
    replicated) into ``count`` blocks over the mesh axes ``part`` of
    ``mesh`` (a ``DeviceMesh``, or an ``AbstractMesh`` for shapes alone)."""

    dims: Any
    part: Any
    count: int
    mesh: Any

    def take(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``."""
        if dim is None:
            return t
        from repro_torch.runtime.sharding import local_block

        n = t.shape[dim] // self.count
        return t.narrow(dim, local_block(self.part, self.mesh)[0] * n, n)


@dataclasses.dataclass(frozen=True)
class Placed:
    """Which parameter leaves are this rank's blocks: ``parts`` is a tree
    like the params of the comma-joined mesh axes each leaf is placed over
    (``""``: held whole; ``sharding.placed_leaf_parts``) on ``mesh``."""

    parts: Any
    mesh: Any


def zero1(params: Any, param_axes: Any, mesh, rules=None) -> Zero1:
    """The :class:`Zero1` layout of ``params`` on ``mesh``: moments by
    ``zero1_axes`` over the data degree, through :func:`opt_state_axes`,
    placed along their ``"zero1"`` dimension only (the port keeps the
    params' own axes replicated).  ``params`` gives the *global* shapes
    (tensors or definitions): a rank holding blocks of placed parameters
    passes their definitions, so the axes are derived as the reference
    derives them, and the block of each leaf splits along the same
    (unplaced) dimension.  Reference: the moment shardings of
    ``repro.launch.dryrun``'s train step."""
    from repro_torch.runtime import sharding as shd

    sizes = shd.mesh_axis_sizes(mesh)
    dp = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
    moments = opt_state_axes(shd.zero1_axes(param_axes, params, dp)).mu
    items = tree_items(params)
    axes = shd._axes_items(moments, items)
    dims, part = [], None
    for key, p in items.items():
        spec, _ = shd.port_spec(tuple(p.shape), axes[key], mesh, ("zero1",), rules)
        d = next((i for i, a in enumerate(spec) if a is not None), None)
        if d is not None:
            part = spec[d]
        dims.append(d)
    count = 1 if part is None else math.prod(sizes[a] for a in (part if isinstance(part, tuple) else (part,)))
    return Zero1(tree_unflatten(params, dims), part, count, mesh)


def init(params: Any, shards: Optional[Zero1] = None) -> OptState:
    """Zero f32 moments shaped like ``params`` (with ``shards``, like this
    rank's block of each), step 0.  Reference: ``repro.optim.adamw:init``."""
    dev = tree_leaves(params)[0].device
    dims = tree_map(lambda p: None, params) if shards is None else shards.dims

    def zeros(p, d):
        shape = list(p.shape)
        if d is not None:
            shape[d] //= shards.count
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return OptState(
        torch.zeros((), dtype=torch.int32, device=dev), tree_map(zeros, params, dims), tree_map(zeros, params, dims)
    )


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine (to 0.1 x), linear (to 0.1 x) or constant
    decay; 0-dim f32.  Reference: ``repro.optim.adamw:schedule_lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = _f32(1.0, step)
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        if cfg.schedule == "linear":
            decay = 1.0 - 0.9 * frac
        else:  # cosine
            decay = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree: Any, placed: Optional[Placed] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  Reference:
    ``repro.optim.adamw:global_norm``.  With ``placed``, a leaf that is
    this rank's block adds its squares summed over the mesh axes it is
    placed over (one SUM all-reduce for each set of axes)."""
    if placed is None:
        return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)))
    from repro_torch.runtime.sharding import all_reduce_over

    whole, blocks = [], {}
    for x, part in zip(tree_leaves(tree), tree_leaves(placed.parts)):
        sq = torch.sum(x.to(torch.float32) ** 2)
        (blocks.setdefault(part, []) if part else whole).append(sq)
    total = sum(whole)
    for part, sqs in blocks.items():
        total = total + all_reduce_over(sum(sqs).reshape(1), tuple(part.split(",")), placed.mesh).reshape(())
    return torch.sqrt(total)


def update(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState, *, shards: Optional[Zero1] = None,
    placed: Optional[Placed] = None,
) -> Tuple[Any, OptState, dict]:
    """One AdamW step; returns ``(new_params, new_state, {"lr",
    "grad_norm"})``.  Reference: ``repro.optim.adamw:update``.  With
    ``shards`` the moments are this rank's blocks (module docstring): the
    norm is the whole gradient's, the step runs on the blocks, and each
    updated block is all-gathered over ``shards.part``.  With ``placed``
    the parameters it names are this rank's blocks, and the norm is still
    the whole gradient's (:func:`global_norm`)."""
    gnorm = global_norm(grads, placed)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(_f32(b1, step), step.to(torch.float32))
    bc2 = 1.0 - torch.pow(_f32(b2, step), step.to(torch.float32))

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * g32 * g32
        mhat = mu / bc1
        vhat = nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    if shards is None:
        out = [
            upd(p, g, m, n)
            for p, g, m, n in zip(
                tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
            )
        ]
    else:
        from repro_torch.runtime.sharding import all_gather_over

        out = []
        for p, g, m, n, d in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                                 tree_leaves(state.nu), tree_leaves(shards.dims)):
            new, m, n = upd(shards.take(p, d), shards.take(g, d), m, n)
            out.append((new if d is None else all_gather_over(new, shards.part, shards.mesh, d), m, n))
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_p, OptState(step, new_mu, new_nu), {"lr": lr, "grad_norm": gnorm}


def opt_state_axes(param_axes: Any) -> OptState:
    """Logical axes of the optimizer state: the step unsharded, the
    moments sharded like the params.  Reference:
    ``repro.optim.adamw:opt_state_axes``."""
    return OptState((), param_axes, param_axes)
