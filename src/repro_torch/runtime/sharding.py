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

The port is SPMD.  Outside a :func:`placement` every rank holds the
activations replicated and :func:`logical_constraint` changes no value; it
still resolves the spec and records fallbacks exactly as the reference
does.  Under a :func:`placement` a step's inputs are this rank's blocks
(:func:`local_block`) along the logical dimensions the port places, the
ones the reference's per-device program holds in blocks (``"batch"`` over
the data axes; ``"heads"`` / ``"kv_heads"`` over ``model`` in prefill and
decode): :func:`place_tree` cuts them from global tensors,
:func:`gather_tree` rebuilds an output the reference replicates, and
:func:`logical_constraint` raises on a placed dimension that does not have
its block size.  Every other logical name stays replicated
(:func:`replicated_by_port` lists them).
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
            if hasattr(node, "_fields"):
                node = getattr(node, part)
            else:
                node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        out[key] = tuple(node)
    return out


class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Dict[str, AxisName]] = None
    fallbacks: list = []
    suspended: bool = False
    placement: Optional["Placement"] = None


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
    """The reference's ``with_sharding_constraint`` by logical names.  ``x``
    comes back unchanged: under a :func:`placement` it already is this
    rank's block, and a dimension whose logical name is placed must have
    the block's size (a ``ValueError`` otherwise: a global-sized dimension
    there is a value some code forgot to place, and nothing slices it
    quietly).  Within a :func:`use_rules` scope (and outside
    :func:`no_constraints`) the spec of the global shape is resolved and
    its fallbacks recorded, as the reference's are.  Reference:
    ``repro.runtime.sharding:logical_constraint``."""
    shape = list(x.shape)
    pl = _CTX.placement
    if pl is not None:
        for d, name in enumerate(axes):
            b = pl.blocks.get(name)
            if b is None:
                continue
            if shape[d] != b.local:
                raise ValueError(f"dimension {d} ({name!r}) of a {tuple(x.shape)} tensor is {shape[d]}, not its "
                                 f"block {b.local} of {b.size} over {b.part}: the value is not placed")
            shape[d] = b.size
    if _CTX.mesh is None or _CTX.suspended:
        return x
    resolve_spec(tuple(shape), axes)
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


# ---------------------------------------------------------------------------
# Placement: this rank's blocks of the values the reference places
# ---------------------------------------------------------------------------
# The logical names the port places; every other name stays replicated.
PLACED = ("batch", "heads", "kv_heads")


def _names(part: AxisName) -> Tuple[str, ...]:
    return part if isinstance(part, tuple) else (part,)


@dataclasses.dataclass(frozen=True)
class Block:
    """A logical dimension of global ``size`` placed over the mesh axes
    ``part``: this rank holds block ``index`` of ``count`` equal blocks."""

    part: AxisName
    index: int
    count: int
    size: int

    @property
    def local(self) -> int:
        return self.size // self.count

    def take(self, x, dim: int):
        """This rank's block of ``x``'s global dimension ``dim``."""
        return x.narrow(dim, self.index * self.local, self.local)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The mesh and the :class:`Block` of each placed logical name."""

    mesh: Any
    blocks: Dict[str, Block]


def placed_parts(sizes: Dict[str, int], mesh, rules: Optional[Dict[str, AxisName]] = None) -> Dict[str, AxisName]:
    """The mesh axes each of ``sizes``' logical names (global sizes) is
    placed over, by :func:`resolve_spec` (its fallbacks recorded); names
    that resolve to replication are left out.  Heads and KV heads are
    placed together or not at all: the GQA map reads q head ``h`` from KV
    head ``h // n_rep``, so a rank's q heads read its KV heads only when the
    same axes cut both into the same number of blocks."""
    unknown = set(sizes) - set(PLACED)
    if unknown:
        raise ValueError(f"the port places {PLACED}, not {sorted(unknown)}")
    out = {}
    for name, size in sizes.items():
        spec = resolve_spec((int(size),), (name,), mesh, rules)
        if spec:
            out[name] = spec[0]
    if "heads" in sizes or "kv_heads" in sizes:
        if out.get("heads") != out.get("kv_heads"):
            out.pop("heads", None)
            out.pop("kv_heads", None)
    return out


def placement(mesh, sizes: Dict[str, int], rules: Optional[Dict[str, AxisName]] = None):
    """Place ``sizes``' logical names (their global sizes) for the scope
    (a context manager yielding the :class:`Placement`): a step run inside
    takes this rank's blocks (:func:`place_tree`) and keeps every value
    placed along those names.  The reference holds the same blocks through
    ``in_shardings`` and ``with_sharding_constraint``
    (``repro.launch.dryrun``, ``repro.runtime.train_loop``)."""
    blocks = {}
    for name, part in placed_parts(sizes, mesh, rules or _CTX.rules).items():
        index, count = local_block(part, mesh)
        if count > 1:  # axes of one rank place nothing
            blocks[name] = Block(part, index, count, int(sizes[name]))
    return reenter(Placement(mesh, blocks))


def resized(name: str, size: int):
    """The active placement with ``name``'s global size changed (a
    microbatch of the placed rows), as a context manager; nothing changes
    where ``name`` is not placed."""
    pl = _CTX.placement
    if pl is None or name not in pl.blocks:
        return reenter(pl)
    b = pl.blocks[name]
    if size % b.count:
        raise ValueError(f"{size} {name} do not split into {b.count} blocks")
    return reenter(Placement(pl.mesh, {**pl.blocks, name: dataclasses.replace(b, size=int(size))}))


def current_placement() -> Optional[Placement]:
    return _CTX.placement


@contextlib.contextmanager
def reenter(pl: Optional[Placement]):
    """Make ``pl`` (a placement :func:`current_placement` returned earlier,
    or ``None``) the active one for the scope: the scope is thread-local,
    and a remat recompute runs on autograd's device thread on the card."""
    prev = _CTX.placement
    _CTX.placement = pl
    try:
        yield pl
    finally:
        _CTX.placement = prev


def block(name: str) -> Optional[Block]:
    """The active placement's :class:`Block` of ``name``, or ``None``
    (not placed)."""
    pl = _CTX.placement
    return None if pl is None else pl.blocks.get(name)


def all_reduce_over(t, part: AxisName, mesh, op=None):
    """``t`` all-reduced in place over the mesh axes ``part``, one axis
    after the other."""
    import torch.distributed as dist

    for a in _names(part):
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=mesh.get_group(a))
    return t


def all_gather_over(t, part: AxisName, mesh, dim: int):
    """The blocks of ``t`` over the mesh axes ``part`` concatenated along
    ``dim`` in block order (the innermost axis first, so the blocks land
    row-major, as :func:`local_block` numbers them)."""
    import torch
    import torch.distributed as dist

    t = t.contiguous()
    for a in reversed(_names(part)):
        group = mesh.get_group(a)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts, dim=dim)
    return t


def gather_block(x, name: str, dim: int):
    """``x``'s dimension ``dim``, this rank's block of the placed logical
    ``name``, gathered into the global dimension.  Adds one to
    ``ROW_GATHERS["outputs"]`` (rows) or ``HEAD_GATHERS["heads"]``."""
    from repro_torch.analysis import contracts

    out = all_gather_over(x, block(name).part, _CTX.placement.mesh, dim)
    if name == "batch":
        contracts.ROW_GATHERS["outputs"] += 1
    else:
        contracts.HEAD_GATHERS["heads"] += 1
    return out


def activation_amax(x, k_block: Optional[Block] = None):
    """A routed GEMM's activation abs-max over the whole operand its rank
    holds a block of: the local ``max(|x|)`` all-reduced with ``MAX`` over
    the mesh axes of the placed rows and, with ``k_block``, of the placed
    K.  ``None`` when neither is placed (the local reduction is then the
    global one).  Max is exact in any order, so the scale is bitwise the
    replicated program's.  Reference: the ``pmax`` of
    ``repro.core.dpu:quantize_symmetric``'s ``amax=`` callers.  Adds one to
    ``SCALE_REDUCTIONS["amax"]``."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import contracts

    parts = [b.part for b in (block("batch"), k_block) if b is not None]
    if not parts:
        return None
    amax = torch.max(torch.abs(x)).to(torch.float32).reshape(1)
    for part in parts:
        all_reduce_over(amax, part, _CTX.placement.mesh, dist.ReduceOp.MAX)
    contracts.SCALE_REDUCTIONS["amax"] += 1
    return amax.reshape(()).to(x.dtype)


def mean_over_rows(t):
    """``t``, a mean over this rank's rows, as the mean over every rank's
    rows (equal blocks): summed over the placed rows' mesh axes and divided
    by their count, in place; ``t`` as it is where rows are not placed."""
    b = block("batch")
    if b is None:
        return t
    all_reduce_over(t, b.part, _CTX.placement.mesh)
    return t.div_(b.count)


def _over_placed(tree: Any, axes: Any, fn) -> Any:
    """``tree`` with ``fn(tensor, logical name, dim)`` applied along every
    dimension the active placement places (``axes``: a matching tree of
    logical-name tuples); other leaves (a host position) pass through."""
    import torch

    blocks = _CTX.placement.blocks if _CTX.placement is not None else {}
    items = tree_items(tree)
    ax = _axes_items(axes, items)
    out = []
    for key, t in items.items():
        if isinstance(t, torch.Tensor):
            for d, name in enumerate(ax[key]):
                if name in blocks:
                    t = fn(t, name, d)
        out.append(t)
    return tree_unflatten(tree, out)


def place_tree(tree: Any, axes: Any) -> Any:
    """This rank's blocks (copies) of a tree of global tensors."""
    return _over_placed(tree, axes, lambda t, name, d: block(name).take(t, d).contiguous().clone())


def gather_tree(tree: Any, axes: Any) -> Any:
    """The global tensors of a tree of this rank's blocks: every placed
    dimension all-gathered (:func:`gather_block`, counted)."""
    return _over_placed(tree, axes, gather_block)


def port_spec(shape: Sequence[int], axes: Sequence[Optional[str]], mesh, names: Sequence[str],
              rules: Optional[Dict[str, AxisName]] = None) -> Tuple[Spec, list]:
    """``(the port's spec, what it leaves replicated)`` of a leaf: the
    reference's :func:`resolve_spec` with only the logical ``names`` kept,
    and ``[(dim, logical name, mesh axes)]`` of the parts dropped."""
    ref = resolve_spec(shape, axes, mesh, rules)
    spec, dropped = [], []
    for d, part in enumerate(ref):
        if part is not None and axes[d] not in names:
            dropped.append((d, axes[d], part))
            part = None
        spec.append(part)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec), dropped


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A leaf's block shape under ``spec``."""
    sizes = mesh_axis_sizes(mesh)
    out = list(shape)
    for d, part in enumerate(spec):
        if part is not None:
            out[d] //= _axis_size(sizes, part)
    return tuple(out)


def replicated_by_port(leaves: Dict[str, Tuple[Tuple[int, ...], Tuple, int]], mesh, names: Sequence[str],
                       rules: Optional[Dict[str, AxisName]] = None) -> list:
    """What the port holds whole where the reference holds a block:
    ``leaves`` maps a leaf's path to ``(global shape, logical axes,
    itemsize)``; each leaf the reference places along a logical name the
    port does not place (``names`` are the ones it does) gives one entry
    per such name, with the bytes the port holds of the leaf and the bytes
    the reference holds."""
    out = []
    for key, (shape, axes, itemsize) in leaves.items():
        ours, dropped = port_spec(shape, axes, mesh, names, rules)
        if not dropped:
            continue
        ref = resolve_spec(shape, axes, mesh, rules)
        held = math.prod(local_shape(shape, ours, mesh)) * itemsize
        ref_held = math.prod(local_shape(shape, ref, mesh)) * itemsize
        for d, name, part in dropped:
            out.append({"leaf": key, "logical": name, "dim": d, "mesh_axes": part if isinstance(part, str)
                        else list(part), "bytes": held, "reference_bytes": ref_held})
    return out

