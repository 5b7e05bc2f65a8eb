"""Logical-axis sharding: rules, the constraint helper, parameter shardings.

Port of ``repro.runtime.sharding``.  Tensors (params and activations) carry
*logical* axis names ("batch", "heads", "d_ff", ...); a rule table maps
them to mesh axes ("pod", "data", "model").  Resolution is shape-aware: a
dimension the mapped mesh axes do not divide falls back to a prefix of an
axis tuple, else to replication, and the fallback is recorded
(:func:`fallback_log`); a mesh axis appears at most once in a spec.

The reference resolves to a ``PartitionSpec``; here a spec is a tuple with
one entry per leading dimension (``None``, a mesh axis name, or a tuple of
names), trailing ``None`` entries dropped as ``PartitionSpec`` drops them.
A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with named
axes, or :func:`abstract_mesh` (axis sizes without ranks, the counterpart
of ``repro.compat.abstract_mesh``), so specs resolve with no process group.
:func:`named_sharding` / :func:`tree_shardings` turn specs into DTensor
placements (``Shard`` / ``Replicate``, one per mesh axis).

The port is SPMD: every rank holds activations replicated, so
:func:`logical_constraint` changes no value; it still resolves the spec
and records fallbacks exactly as the reference does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch._tree import tree_items, tree_unflatten

AxisName = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[AxisName], ...]

# Logical axis -> mesh axis (or tuple of mesh axes).
DEFAULT_RULES: Dict[str, AxisName] = {
    "batch": ("pod", "data"),
    "seq_sp": "model",    # sequence-parallel residual stream
    "kv_seq": "data",     # long-context KV-cache sequence sharding
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "inner": "model",     # xlstm / mamba inner projection dim
    "mamba_heads": "model",
    "state": None,
    # ZeRO-1: optimizer moments additionally shard a replicated dim over data.
    "zero1": ("pod", "data"),
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axis sizes without ranks.  Reference:
    ``repro.compat.abstract_mesh`` (``jax.sharding.AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str]) -> AbstractMesh:
    """A rank-free mesh for sharding resolution.  Reference:
    ``repro.compat:abstract_mesh``."""
    axis_shapes, axis_names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"axis_shapes {axis_shapes} and axis_names {axis_names} disagree")
    return AbstractMesh(axis_shapes, axis_names)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`DeviceMesh` or an
    :class:`AbstractMesh` (the reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def zero1_axes(param_axes: Any, param_shapes: Any, divisor: int) -> Any:
    """Optimizer-moment axes: the param's, with its first unsharded dim
    that ``divisor`` (the data-parallel degree) divides renamed "zero1"
    (ZeRO-1).  ``param_shapes`` leaves have ``.shape``.  Reference:
    ``repro.runtime.sharding:zero1_axes``."""
    shapes = tree_items(param_shapes)
    axes = _axes_items(param_axes, shapes)
    out = []
    for key, s in shapes.items():
        a = axes[key]
        best = next((i for i, (dim, n) in enumerate(zip(s.shape, a)) if n is None and dim % divisor == 0), None)
        if best is None:
            out.append(a)
        else:
            new = list(a)
            new[best] = "zero1"
            out.append(tuple(new))
    return tree_unflatten(param_shapes, out)


def _axes_items(axes: Any, like: Dict[str, Any]) -> Dict[str, Tuple]:
    """The axes tree's leaves (tuples of logical names) under the paths of
    ``like``'s leaves: the tree walks stop at a tuple of names, as the
    reference's ``flatten_up_to`` does."""
    out = {}
    for key in like:
        node = axes
        for part in key.split("/") if key else ():
            node = node[int(part)] if isinstance(node, list) else (
                getattr(node, part) if hasattr(node, "_fields") else node[part])
        out[key] = tuple(node)
    return out


class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Dict[str, AxisName]] = None
    fallbacks: list = []
    suspended: bool = False


_CTX = _Ctx()


@contextlib.contextmanager
def no_constraints():
    """Suspend :func:`logical_constraint` (the reference's mode inside
    ``shard_map`` bodies, where mesh axes are manual).  Reference:
    ``repro.runtime.sharding:no_constraints``."""
    prev = _CTX.suspended
    _CTX.suspended = True
    try:
        yield
    finally:
        _CTX.suspended = prev


@contextlib.contextmanager
def use_rules(mesh, rules: Optional[Dict[str, AxisName]] = None):
    """Activate a mesh and rule table (the defaults overridden by
    ``rules``) for :func:`logical_constraint` resolution; clears the
    fallback log.  Reference: ``repro.runtime.sharding:use_rules``."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES, **(rules or {}))
    # JSON-sourced overrides arrive as lists; normalize to tuples.
    _CTX.rules = {k: tuple(v) if isinstance(v, list) else v for k, v in merged.items()}
    _CTX.fallbacks = []
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def fallback_log() -> list:
    """Divisibility fallbacks recorded during the last :func:`use_rules`
    scope: ``(shape, logical name, mesh axes, dim, size)`` each.
    Reference: ``repro.runtime.sharding:fallback_log``."""
    return list(_CTX.fallbacks)


def _axis_size(sizes: Dict[str, int], axis: AxisName) -> int:
    if isinstance(axis, tuple):
        return math.prod(_axis_size(sizes, a) for a in axis)
    return sizes[axis]


def _filter_axis(sizes: Dict[str, int], axis: AxisName) -> Optional[AxisName]:
    """Drop mesh axes this mesh does not have (e.g. no 'pod')."""
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in sizes)
        return kept if kept else None
    return axis if axis in sizes else None


def resolve_spec(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[Dict[str, AxisName]] = None,
) -> Spec:
    """Logical axes -> a spec (one entry per dim, trailing ``None`` dropped)
    with the shape-aware divisibility fallback.  Reference:
    ``repro.runtime.sharding:resolve_spec``."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    if mesh is None:
        raise ValueError("resolve_spec needs a mesh (use use_rules)")
    sizes = mesh_axis_sizes(mesh)
    parts: list = []
    used: set = set()
    for dim, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        mapped = rules.get(name)
        if mapped is None:
            parts.append(None)
            continue
        mapped = _filter_axis(sizes, mapped)
        if mapped is None:
            parts.append(None)
            continue
        # A mesh axis may appear at most once in a spec.
        flat = mapped if isinstance(mapped, tuple) else (mapped,)
        if any(a in used for a in flat):
            parts.append(None)
            continue
        size = _axis_size(sizes, mapped)
        if dim % size != 0:
            # Try a prefix of the axis tuple (e.g. ("pod","data") -> ("pod",)).
            ok = None
            if isinstance(mapped, tuple):
                for cut in range(len(mapped) - 1, 0, -1):
                    sub = mapped[:cut]
                    if dim % _axis_size(sizes, sub) == 0:
                        ok = sub
                        break
            if ok is None:
                _CTX.fallbacks.append((tuple(shape), name, mapped, dim, size))
                parts.append(None)
                continue
            mapped = ok
            flat = mapped if isinstance(mapped, tuple) else (mapped,)
        used.update(flat)
        parts.append(mapped)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def logical_constraint(x, axes: Sequence[Optional[str]]):
    """The reference's ``with_sharding_constraint`` by logical names.  The
    port's activations are replicated on every rank, so ``x`` comes back
    unchanged; within a :func:`use_rules` scope (and outside
    :func:`no_constraints`) the spec is resolved and its fallbacks
    recorded, as the reference's are.  Reference:
    ``repro.runtime.sharding:logical_constraint``."""
    if _CTX.mesh is None or _CTX.suspended:
        return x
    resolve_spec(tuple(x.shape), axes)
    return x


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a :class:`DeviceMesh`: the reference's ``NamedSharding``.
    :attr:`placements` are the DTensor placements, one per mesh axis."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, part in enumerate(self.spec)
                    if part == name or (isinstance(part, tuple) and name in part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named_sharding(mesh, shape: Sequence[int], axes: Sequence[Optional[str]],
                   rules: Optional[Dict[str, AxisName]] = None) -> NamedSharding:
    """Reference: ``repro.runtime.sharding:named_sharding``."""
    return NamedSharding(mesh, resolve_spec(shape, axes, mesh, rules))


def tree_shardings(mesh, shapes: Any, axes: Any, rules: Optional[Dict[str, AxisName]] = None) -> Any:
    """A :class:`NamedSharding` per leaf of ``shapes`` (tensors, or any
    leaves with ``.shape``), from the matching leaf of ``axes`` (tuples of
    logical names).  Reference: ``repro.runtime.sharding:tree_shardings``."""
    items = tree_items(shapes)
    ax = _axes_items(axes, items)
    return tree_unflatten(shapes, [named_sharding(mesh, s.shape, ax[k], rules) for k, s in items.items()])


def local_block(spec_part: Optional[AxisName], mesh) -> Tuple[int, int]:
    """``(index, count)``: which of the equal blocks of a dimension sharded
    over ``spec_part`` this rank holds, by its coordinate over those mesh
    axes taken row-major (the layout of ``P(spec_part)``); ``(0, 1)`` for
    a replicated dimension."""
    if spec_part is None:
        return 0, 1
    names = spec_part if isinstance(spec_part, tuple) else (spec_part,)
    sizes = mesh_axis_sizes(mesh)
    index, count = 0, 1
    for a in names:
        index = index * sizes[a] + mesh.get_local_rank(a)
        count *= sizes[a]
    return index, count
