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
the data axes; ``"heads"`` / ``"kv_heads"`` over ``model``, and where
the parameters are placed (MLA's ``"heads"`` included) ``"d_ff"`` /
``"vocab"`` / ``"experts"`` / ``"inner"`` / ``"mamba_heads"`` over
``model``; the sequence axes, ``"seq_sp"`` (the residual stream between
blocks, over ``model``: :func:`seq_gather` / :func:`seq_scatter`) and
``"kv_seq"`` (a decode cache's positions, over the data axes where the
rows do not take them: :func:`kv_merge` meets the decode softmax's
partials)):
:func:`place_tree` cuts them from global tensors, :func:`place_params`
cuts a parameter tree by its ``param_axes``, :func:`gather_tree` rebuilds
an output the reference replicates, and :func:`logical_constraint` raises
on a placed dimension that does not have its block size.  Every other
logical name stays replicated (:func:`replicated_by_port` lists what the
reference would place, nothing in any of the dry run's cells).

A GEMM whose weight columns are placed runs column-parallel
(:class:`ColumnLayout`: this rank computes its block of the output
columns; the input's gradient meets in :func:`copy_to_model`'s backward
all-reduce), and one whose K is placed runs row-parallel (its partial
products meet in :func:`reduce_from_model`'s forward all-reduce), the two
forms of the reference's GSPMD partitioning of a placed weight.  An expert
stack placed over ``"experts"`` (the leading dimension of the MoE's
``wi`` / ``wo``) is the third, expert parallelism: a rank runs its experts
on their slots and the partial combines meet in the same forward
all-reduce.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
        out[key] = node if isinstance(node, Axes) else tuple(node)
    return out


class Axes(tuple):
    """A leaf's logical axes whose last dimension is laid out in
    :attr:`parts`: columns of several widths side by side (SwiGLU's ``wi``
    ``[u | g]``, Mamba2's ``in_proj`` ``[z | x | B C | dt]``), each cut into
    the blocks of the dimension's logical name, so a rank holds a block of
    each part (:func:`place_params`, :func:`place_tree`).  It compares and
    hashes as the plain tuple of names."""

    parts: Tuple[int, ...] = ()


def parted(axes: Sequence[Optional[str]], parts: Sequence[int]) -> Axes:
    """``axes`` with the last dimension's column parts declared (their
    global widths, in order)."""
    out = Axes(axes)
    out.parts = tuple(int(w) for w in parts)
    return out


def lead(prefix: Sequence[Optional[str]], axes: Sequence[Optional[str]]) -> Tuple[Optional[str], ...]:
    """``prefix + axes`` (a stacked leaf's axes), the last dimension's
    column parts kept."""
    out = tuple(prefix) + tuple(axes)
    parts = getattr(axes, "parts", ())
    return parted(out, parts) if parts else out


def _part_widths(axes: Sequence[Optional[str]], dim: int, size: int) -> Tuple[int, ...]:
    """The global widths of the parts of dimension ``dim`` (of global
    ``size``): the declared :attr:`Axes.parts` of the last dimension, else
    one part."""
    parts = getattr(axes, "parts", ())
    if not parts or dim != len(axes) - 1:
        return (size,)
    if sum(parts) != size:
        raise ValueError(f"parts {parts} do not lay out a dimension of {size}")
    return parts


class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Dict[str, AxisName]] = None
    fallbacks: list = []
    suspended: bool = False
    placement: Optional["Placement"] = None
    rows: Tuple[str, ...] = ()
    scatter: Optional["Block"] = None
    partial: bool = False


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
PLACED = ("batch", "seq_sp", "kv_seq", "heads", "kv_heads", "d_ff", "vocab", "experts", "inner", "mamba_heads")
# The sequence axes, each resolved after the batch rows on the leaf that
# carries both (the residual ``(batch, seq_sp, .)``, the cache ``(batch,
# kv_seq, ...)``): a mesh axis the rows take is not theirs.
_AFTER_ROWS = ("seq_sp", "kv_seq")


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

    def take(self, x, dim: int, widths: Sequence[int] = ()):
        """This rank's block of ``x``'s global dimension ``dim`` or, with
        ``widths`` (the global widths of its parts), of each part, the
        blocks side by side."""
        if not widths:
            return x.narrow(dim, self.index * self.local, self.local)
        import torch

        pieces, start = [], 0
        for w in widths:
            if w % self.count:
                raise ValueError(f"a part of {w} does not split into {self.count} blocks")
            n = w // self.count
            pieces.append(x.narrow(dim, start + self.index * n, n))
            start += w
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


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
    same axes cut both into the same number of blocks (MLA, which has no
    KV heads, places its ``heads`` alone).  Mamba2's ``inner`` and
    ``mamba_heads`` are placed together or not at all, for the same reason:
    a rank's heads read its block of the ``inner`` channels.  The
    sequence axes ``seq_sp`` and ``kv_seq`` are resolved jointly with
    ``"batch"``, as the reference's ``resolve_spec`` resolves the leaf
    that carries both: the cache's sequence takes "data" only where the
    rows fall back (one row at ``long_500k``)."""
    unknown = set(sizes) - set(PLACED)
    if unknown:
        raise ValueError(f"the port places {PLACED}, not {sorted(unknown)}")
    out = {}
    for name in sorted(sizes, key=lambda n: n in _AFTER_ROWS):
        if name in _AFTER_ROWS:  # the reference's axis-used-once rule on the leaf
            used = set(_names(out["batch"])) if "batch" in out else set()
            mapped = _filter_axis(mesh_axis_sizes(mesh), (rules or _CTX.rules or DEFAULT_RULES).get(name))
            if mapped is None or used & set(_names(mapped)):
                continue
        spec = resolve_spec((int(sizes[name]),), (name,), mesh, rules)
        if spec:
            out[name] = spec[0]
    for a, b in (("heads", "kv_heads"), ("inner", "mamba_heads")):
        if a in sizes and b in sizes and out.get(a) != out.get(b):
            out.pop(a, None)
            out.pop(b, None)
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


def sequence(t: int):
    """The active placement with ``"seq_sp"`` sized ``t`` (a step's own
    sequence: whisper's decoder runs at ``T_enc // decoder_ratio``, a
    decode token at 1), as a context manager; where its blocks do not
    divide ``t`` the sequence is not placed in the scope (the residual
    stays whole, and its constraints record the reference's fallback).
    Nothing changes where ``"seq_sp"`` is not placed."""
    pl = _CTX.placement
    if pl is None or "seq_sp" not in pl.blocks:
        return reenter(pl)
    b, blocks = pl.blocks["seq_sp"], dict(pl.blocks)
    if t % b.count:
        del blocks["seq_sp"]
    else:
        blocks["seq_sp"] = dataclasses.replace(b, size=int(t))
    return reenter(Placement(pl.mesh, blocks))


@contextlib.contextmanager
def rows_over(name: str):
    """A routed GEMM's operand rows in the scope are this rank's block of
    the placed logical ``name`` as well as of the rows (``kv_seq``: an MLA
    decode expanding its block of the latent cache): the activation scale
    takes its ``MAX`` over ``name``'s mesh axes too, and a tensor-parallel
    GEMM does not split the rows again.  Nothing changes where ``name`` is
    not placed."""
    prev = _CTX.rows
    _CTX.rows = prev + ((name,) if block(name) is not None else ())
    try:
        yield
    finally:
        _CTX.rows = prev


def row_segments(lead: Sequence[int]) -> Optional[Tuple[Tuple[int, ...], int]]:
    """Where a routed GEMM's operand rows, of leading shape ``lead`` ``(B,
    L)``, lie in the whole operand when they are this rank's block of the
    placed ``"kv_seq"`` (:func:`rows_over`, the rows themselves not
    placed): ``(origins, total)``, each of the ``B`` leading rows' ``L``
    rows a span from its global row ``b * size + index * L`` of the ``B *
    size`` whole rows.  ``None`` otherwise."""
    b = block("kv_seq")
    if b is None or "kv_seq" not in _CTX.rows or block("batch") is not None or len(lead) != 2 or lead[1] != b.local:
        return None
    return tuple(i * b.size + b.index * b.local for i in range(lead[0])), lead[0] * b.size


def rows_word(word):
    """The whole operand's content word (``noise.stages.tweak_word``, a sum
    mod 2^32) from this rank's rows' ``word``: summed over the placed
    ``"kv_seq"``'s mesh axes (an exact int64 SUM all-reduce), one
    ``SEQ_COLLECTIVES["kv_word"]``."""
    import torch

    from repro_torch.analysis import contracts
    from repro_torch.noise.stages import U32

    b = block("kv_seq")
    out = all_reduce_over(word.to(torch.int64).reshape(1).clone(), b.part, _CTX.placement.mesh)
    contracts.count_seq("kv_word", "all-reduce", 8, b.count)
    return out.reshape(()) & U32


def row_blocks() -> Tuple[Block, ...]:
    """The :class:`Block` s a routed GEMM's operand rows are placed over:
    the rows' and those of :func:`rows_over`."""
    return tuple(b for b in (block(n) for n in ("batch",) + _CTX.rows) if b is not None)


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
    from repro_torch.runtime import collectives

    for a in _names(part):
        collectives.all_reduce(t, op, group=mesh.get_group(a))
    return t


def all_gather_over(t, part: AxisName, mesh, dim: int):
    """The blocks of ``t`` over the mesh axes ``part`` concatenated along
    ``dim`` in block order (the innermost axis first, so the blocks land
    row-major, as :func:`local_block` numbers them)."""
    import torch
    import torch.distributed as dist

    from repro_torch.runtime import collectives

    t = t.contiguous()
    for a in reversed(_names(part)):
        group = mesh.get_group(a)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        collectives.all_gather(parts, t, group=group)
        t = torch.cat(parts, dim=dim)
    return t


@functools.lru_cache(maxsize=None)
def _collectives():
    """The autograd functions of the placed GEMMs' collectives (made at
    first use: this module imports ``torch`` lazily)."""
    from torch.autograd import Function

    class Gather(Function):
        """All-gather over ``part`` along ``dim``; the backward takes this
        rank's block of the gradient (every rank computes the same
        downstream values, so its block is the whole gradient's)."""

        @staticmethod
        def forward(ctx, x, b, mesh, dim):
            ctx.b, ctx.dim = b, dim
            return all_gather_over(x, b.part, mesh, dim)

        @staticmethod
        def backward(ctx, g):
            return ctx.b.take(g, ctx.dim).contiguous(), None, None, None

    class CopyToModel(Function):
        """The column-parallel input: the identity forward; the backward
        all-reduces the gradient (each rank's, from its columns alone) with
        SUM over ``part``."""

        @staticmethod
        def forward(ctx, x, part, mesh, what):
            ctx.part, ctx.mesh, ctx.what = part, mesh, what
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            from repro_torch.analysis import contracts

            g = all_reduce_over(g.contiguous().clone(), ctx.part, ctx.mesh)
            if ctx.what in contracts.SEQ_COLLECTIVES:
                n = math.prod(mesh_axis_sizes(ctx.mesh)[a] for a in _names(ctx.part))
                contracts.count_seq(ctx.what, "all-reduce", _nbytes(g), n)
            else:
                contracts.count_collective(ctx.what)
            return g, None, None, None

    class ReduceFromModel(Function):
        """The row-parallel output: partial sums all-reduced with SUM over
        ``part`` in the forward; the identity backward (every rank's share
        of the sum takes the whole gradient)."""

        @staticmethod
        def forward(ctx, x, part, mesh, what):
            from repro_torch.analysis import contracts

            out = all_reduce_over(x.contiguous().clone(), part, mesh)
            contracts.count_collective(what)
            return out

        @staticmethod
        def backward(ctx, g):
            return g, None, None, None

    class Split(Function):
        """This rank's block of a value every rank holds whole (the
        residual after a block); the backward all-gathers the blocks'
        gradients over ``part`` (every rank's downstream gradient is its
        block's alone), one ``SEQ_COLLECTIVES["split_grad"]``."""

        @staticmethod
        def forward(ctx, x, b, mesh, dim):
            ctx.b, ctx.mesh, ctx.dim = b, mesh, dim
            return b.take(x, dim).contiguous()

        @staticmethod
        def backward(ctx, g):
            return seq_grad_gather(g, ctx.b, ctx.mesh), None, None, None

    class GatherSum(Function):
        """The Megatron form's entry: all-gather over ``b.part`` along the
        sequence; the backward reduce-scatters the gradient, each rank's a
        partial sum (its column-parallel GEMMs' input gradients, not
        all-reduced), one ``SEQ_COLLECTIVES["gather_grad"]``."""

        @staticmethod
        def forward(ctx, x, b, mesh):
            ctx.b, ctx.mesh = b, mesh
            return all_gather_over(x, b.part, mesh, 1)

        @staticmethod
        def backward(ctx, g):
            from repro_torch.analysis import contracts

            out = reduce_scatter_over(g, ctx.b.part, ctx.mesh, 1)
            contracts.count_seq("gather_grad", "reduce-scatter", _nbytes(out), ctx.b.count)
            return out, None, None

    class ReduceScatter(Function):
        """A row-parallel output's partial sums reduce-scattered over
        ``b.part`` along the sequence (this rank's block of the sum),
        counted as the sum it is (``contracts.count_collective(what)``)
        and as one ``SEQ_COLLECTIVES["scatter"]``; the backward all-gathers
        the gradient's blocks, one ``SEQ_COLLECTIVES["split_grad"]``."""

        @staticmethod
        def forward(ctx, x, b, mesh, what):
            from repro_torch.analysis import contracts

            ctx.b, ctx.mesh = b, mesh
            contracts.count_collective(what)
            out = reduce_scatter_over(x, b.part, mesh, 1)
            contracts.count_seq("scatter", "reduce-scatter", _nbytes(out), b.count)
            return out

        @staticmethod
        def backward(ctx, g):
            return seq_grad_gather(g, ctx.b, ctx.mesh), None, None, None

    class Share(Function):
        """The identity forward; the backward keeps the gradient on the
        first rank of ``b.part`` and gives the others zeros, so that a
        gradient every rank computes whole enters a :class:`GatherSum`'s
        reduce-scatter once."""

        @staticmethod
        def forward(ctx, x, b):
            ctx.b = b
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            import torch

            return (g if ctx.b.index == 0 else torch.zeros_like(g)), None

    return Gather, CopyToModel, ReduceFromModel, Split, GatherSum, ReduceScatter, Share


def reduce_scatter_over(t, part: AxisName, mesh, dim: int):
    """This rank's block along ``dim`` of the SUM over the mesh axes
    ``part`` of every rank's ``t``: one reduce-scatter per axis, the
    outermost first (so the blocks are numbered row-major, as
    :func:`local_block` numbers them)."""
    import torch
    import torch.distributed as dist

    from repro_torch.runtime import collectives

    for a in _names(part):
        group = mesh.get_group(a)
        chunks = [c.contiguous() for c in t.chunk(dist.get_world_size(group), dim=dim)]
        t = collectives.reduce_scatter(torch.empty_like(chunks[0]), chunks, group=group)
    return t


def seq_grad_gather(g, b: "Block", mesh):
    """The gradient of a value cut to this rank's block ``b`` of the
    sequence: every rank's block all-gathered along dimension 1, one
    ``SEQ_COLLECTIVES["split_grad"]``."""
    from repro_torch.analysis import contracts

    out = all_gather_over(g, b.part, mesh, 1)
    contracts.count_seq("split_grad", "all-gather", _nbytes(out), b.count)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def copy_to_model(x, part: AxisName, what: str = "column_input"):
    """``x`` as the input of a computation split over the mesh axes
    ``part`` (a column-parallel GEMM, ``"column_input"``; a rank's experts,
    ``"expert_input"``; a replicated value a recurrent layer's rank-split
    work reads, ``"split_input"``): unchanged, its gradient all-reduced
    with SUM over ``part`` in the backward (one
    ``contracts.count_collective(what)`` each).  A column-parallel GEMM's
    input inside :func:`seq_block`'s Megatron form keeps its partial
    gradient: the block's entry reduce-scatters it."""
    if what == "column_input" and _CTX.partial:
        return x
    return _collectives()[1].apply(x, part, _CTX.placement.mesh, what)


def whole_input(x):
    """``x``, read whole by a GEMM that computes its gradient whole on
    every rank (a column-parallel form that does not apply: a bit-sliced
    engine, an int8 scope without ``w_scale``): inside :func:`seq_block`'s
    Megatron form the gradient enters the entry's reduce-scatter from one
    rank only (:class:`Share`); ``x`` as it is elsewhere."""
    if not _CTX.partial:
        return x
    return _collectives()[6].apply(x, block("seq_sp"))


def reduce_rows(x, part: AxisName, what: str = "row_output"):
    """:func:`reduce_from_model` of a row-parallel output ``x`` ``(B, T,
    .)``, or, inside :func:`seq_block` / :func:`scattering` where ``T`` is
    the placed sequence and ``part`` its mesh axes, its reduce-scatter
    over the sequence: this rank's block of the sum (the Megatron form;
    :func:`seq_scatter` then takes it as it is)."""
    b = scatter_block(x.shape[:-1], part)
    if b is None:
        return reduce_from_model(x, part, what)
    return _collectives()[5].apply(x, b, _CTX.placement.mesh, what)


def scatter_block(lead: Sequence[int], part: AxisName) -> Optional[Block]:
    """The ``"seq_sp"`` block a row-parallel output of leading shape
    ``lead`` reduces onto inside :func:`seq_block` / :func:`scattering`:
    where ``lead`` is ``(B, T)`` with ``T`` the placed sequence and
    ``part``, the mesh axes its partial sums meet over, the sequence's;
    ``None`` elsewhere (the output is all-reduced whole)."""
    b = _CTX.scatter
    if b is None or len(lead) != 2 or lead[1] != b.size or _names(part) != _names(b.part):
        return None
    return b


@contextlib.contextmanager
def scattering():
    """A scope whose row-parallel outputs over the placed sequence come
    out reduce-scattered (:func:`reduce_rows`, the routed GEMMs of
    ``photonic.sharded``): a value :func:`seq_scatter` then cuts (the
    embedding's vocab-parallel lookup)."""
    prev = _CTX.scatter
    _CTX.scatter = block("seq_sp")
    try:
        yield
    finally:
        _CTX.scatter = prev


@contextlib.contextmanager
def seq_block(x, norm, params, columns: bool = False):
    """A block over the residual ``x`` that reads it whole, in the
    Megatron form where ``"seq_sp"`` is placed: yields the block's input,
    ``norm(params, .)`` of the whole sequence, and in the scope the
    block's row-parallel outputs come out reduce-scattered over the
    sequence (:func:`scattering`; their backward all-gathers), so ``x +
    seq_scatter(out)`` adds this rank's block.  The input is
    ``norm(params, seq_gather(x))``, the residual gathered as
    :func:`seq_gather` gathers it; with ``columns`` (every GEMM that reads
    the input is column-parallel on this rank's columns of a placed
    weight) the block normalizes its own positions and all-gathers the
    result, whose backward reduce-scatters the GEMMs' partial input
    gradients (:class:`GatherSum`) in place of their all-reduces
    (:func:`copy_to_model`, :func:`whole_input`), and the norm's
    parameters, read on a block of the positions, have their gradients
    summed over the sequence's axes (``SEQ_COLLECTIVES["norm_grad"]``).
    Where the sequence is not placed: ``norm(params, x)``, nothing else
    changes."""
    b = block("seq_sp")
    if b is None:
        yield norm(params, x)
        return
    prev = (_CTX.scatter, _CTX.partial)
    _CTX.scatter, _CTX.partial = b, bool(columns)
    try:
        if columns:
            from repro_torch.analysis import contracts

            if x.shape[1] != b.local:
                raise ValueError(f"a {tuple(x.shape)} residual is not this rank's block {b.local} of {b.size} positions")
            mine = {k: copy_to_model(v, b.part, "norm_grad") for k, v in params.items()}
            h = _collectives()[4].apply(norm(mine, x), b, _CTX.placement.mesh)
            contracts.count_seq("gather", "all-gather", _nbytes(h), b.count)
            yield h
        else:
            yield norm(params, seq_gather(x))
    finally:
        _CTX.scatter, _CTX.partial = prev


def placed_columns(w, parts: Sequence[Tuple[str, int]]) -> bool:
    """Whether ``w`` is this rank's columns of a weight whose columns are
    ``parts`` placed by the active placement (:func:`column_layout`): a
    GEMM on it is column-parallel with this rank's partial input
    gradient."""
    import torch

    lay = column_layout(parts)
    return lay is not None and isinstance(w, torch.Tensor) and w.shape[-1] == lay.local != lay.total


def reduce_from_model(x, part: AxisName, what: str = "row_output"):
    """``x``, this rank's partial sum, all-reduced with SUM over ``part``
    (one ``contracts.count_collective(what)``): a row-parallel GEMM's
    output (``"row_output"``), a vocab-parallel lookup or loss term
    (``"vocab"``), the expert-parallel MoE's combine
    (``"expert_combine"``) or the mLSTM's partial readouts of its placed
    state (``"state_sum"``); the gradient passes through unchanged."""
    return _collectives()[2].apply(x, part, _CTX.placement.mesh, what)


def max_over(t, part: AxisName):
    """A copy of ``t`` all-reduced with ``MAX`` over ``part`` (no
    gradient); one ``PARAM_REDUCES["vocab"]``."""
    import torch.distributed as dist

    from repro_torch.analysis import contracts

    out = all_reduce_over(t.detach().contiguous().clone(), part, _CTX.placement.mesh, dist.ReduceOp.MAX)
    contracts.PARAM_REDUCES["vocab"] += 1
    return out


def gather_block(x, name: str, dim: int, what: Optional[str] = None):
    """``x``'s dimension ``dim``, this rank's block of the placed logical
    ``name``, gathered into the global dimension (differentiable: the
    backward takes this rank's block, so every rank must compute the same
    gradient of the result: a value it then splits again goes through
    :func:`copy_to_model` first).  Adds one to
    ``RECURRENT_COLLECTIVES[what]`` with ``what``, else to
    ``ROW_GATHERS["outputs"]`` (rows, or the vocab of the logits) or
    ``HEAD_GATHERS["heads"]``."""
    from repro_torch.analysis import contracts

    b = block(name)
    out = _gather(x, dataclasses.replace(b, size=x.shape[dim] * b.count), dim)
    if what in contracts.SEQ_COLLECTIVES:
        contracts.count_seq(what, "all-gather", _nbytes(out), b.count)
    elif what is not None:
        contracts.count_collective(what)
    elif name in ("batch", "vocab"):
        contracts.ROW_GATHERS["outputs"] += 1
    else:
        contracts.HEAD_GATHERS["heads"] += 1
    return out


def gather_parts(x, name: str, widths: Sequence[int], what: Optional[str] = None):
    """:func:`gather_block` of ``x``'s last dimension laid out in parts of
    global ``widths`` (this rank holds a block of each): each part gathered,
    the parts side by side; counted once."""
    import torch

    b = block(name)
    pieces = x.split([w // b.count for w in widths], dim=-1)
    out = [_gather(p, dataclasses.replace(b, size=p.shape[-1] * b.count), x.dim() - 1) for p in pieces]
    if what is not None:
        from repro_torch.analysis import contracts

        contracts.count_collective(what)
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# The sequence axes: the residual stream's block (seq_sp) and the decode
# cache's (kv_seq)
# ---------------------------------------------------------------------------
RESIDUAL = ("batch", "seq_sp", None)


def seq_gather(x):
    """The residual ``x`` ``(B, T, D)``, this rank's block of the placed
    ``"seq_sp"``, gathered into the whole sequence for a block that reads
    it whole (attention, the Mamba2 scan, the MoE's dispatch, the
    column-parallel GEMMs, whose scale and noise stream are the replicated
    program's on whole operands); ``x`` as it is where the sequence is not
    placed.  Differentiable (the backward takes this rank's block of a
    gradient every rank computes whole).  One
    ``SEQ_COLLECTIVES["gather"]``."""
    b = block("seq_sp")
    if b is None:
        return x
    if x.shape[1] != b.local:
        raise ValueError(f"a {tuple(x.shape)} residual is not this rank's block {b.local} of {b.size} positions")
    from repro_torch.analysis import contracts

    out = _gather(x, b, 1)
    contracts.count_seq("gather", "all-gather", _nbytes(out), b.count)
    return out


def seq_scatter(x, axes: Optional[Sequence[Optional[str]]] = RESIDUAL):
    """This rank's block of the placed ``"seq_sp"`` of ``x`` ``(B, T, D)``,
    a value every rank holds whole (a block's output, the embedding), then
    :func:`logical_constraint` to ``axes`` (``None``: no constraint, where
    the reference has none).  The backward all-gathers the gradient
    (:class:`Split`).  ``x`` as it is where the sequence is not placed,
    and where it already is this rank's block (a row-parallel output
    reduce-scattered in :func:`seq_block`)."""
    b = block("seq_sp")
    if b is not None and x.shape[1] != b.local:
        x = _collectives()[3].apply(x, b, _CTX.placement.mesh, 1)
    return x if axes is None else logical_constraint(x, axes)


def seq_last(x):
    """The last position ``(B, 1, D)`` of the residual ``x``: where the
    sequence is placed it lives on the last block's rank, and every rank's
    last row is gathered (one ``SEQ_COLLECTIVES["gather"]``) to take it."""
    b = block("seq_sp")
    if b is None:
        return x[:, -1:]
    from repro_torch.analysis import contracts

    out = all_gather_over(x[:, -1:], b.part, _CTX.placement.mesh, 1)
    contracts.count_seq("gather", "all-gather", _nbytes(out), b.count)
    return out[:, -1:]


def kv_origin(n: int) -> int:
    """The global position of the first of this rank's ``n`` cache
    positions: ``index * n`` where ``"kv_seq"`` is placed, else 0."""
    b = block("kv_seq")
    return 0 if b is None else b.index * n


def kv_merge(t, op: str):
    """``t``, a partial over this rank's cache positions, all-reduced over
    the placed ``"kv_seq"``'s mesh axes (``op`` ``"max"``: the scores' row
    max; ``"sum"``: the exp-sums and the ``P @ V`` partials), in place; one
    ``SEQ_COLLECTIVES["kv_max" | "kv_sum"]``."""
    import torch.distributed as dist

    from repro_torch.analysis import contracts

    b = block("kv_seq")
    all_reduce_over(t, b.part, _CTX.placement.mesh, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    contracts.count_seq(f"kv_{op}", "all-reduce", _nbytes(t), b.count)
    return t


def split_block(x, name: str, what: str = "split_input"):
    """This rank's block of ``name`` of ``x``'s last dimension, ``x`` a
    value every rank computes whole (replicated work ahead of a
    row-parallel GEMM): :func:`copy_to_model` first, so the gradient of
    ``x`` sums every rank's block's."""
    b = block(name)
    x = copy_to_model(x, b.part, what)
    return dataclasses.replace(b, size=x.shape[-1]).take(x, x.dim() - 1)


def _gather(x, b: Block, dim: int):
    return _collectives()[0].apply(x, b, _CTX.placement.mesh, dim)


def gather_rows(w, b: Block):
    """A weight's K rows (this rank's block along ``b``'s mesh axes)
    gathered into the whole weight, differentiably (the backward takes this
    rank's rows), for a path that needs the weight whole."""
    return _gather(w, dataclasses.replace(b, size=w.shape[0] * b.count), 0)


@dataclasses.dataclass(frozen=True)
class ColumnLayout:
    """The output columns this rank computes of a GEMM whose weight's
    columns are parts ``(logical name, global width)`` laid side by side,
    each cut by its name's :class:`Block` (a SwiGLU ``wi`` is two
    ``"d_ff"`` parts, ``[u | g]``; a fused ``wqkv`` is ``"heads"``,
    ``"kv_heads"``, ``"kv_heads"``): ``segments`` are ``(global origin,
    width)`` in local order, ``total`` the global width, ``part`` the mesh
    axes every part's blocks lie over."""

    segments: Tuple[Tuple[int, int], ...]
    total: int
    part: AxisName
    mesh: Any

    @property
    def local(self) -> int:
        return sum(w for _, w in self.segments)

    def take(self, t, dim: int = -1):
        """This rank's columns of a whole tensor along ``dim``."""
        import torch

        pieces = [t.narrow(dim, o, w) for o, w in self.segments]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def split(self, t, dim: int = -1) -> list:
        """A tensor of this rank's columns cut into its segments."""
        return list(t.split([w for _, w in self.segments], dim))

    def gather(self, t, dim: int = -1):
        """The whole tensor from every rank's columns along ``dim``: each
        segment all-gathered over :attr:`part` (blocks in rank order),
        the parts side by side."""
        import torch

        pieces = [all_gather_over(s, self.part, self.mesh, dim % t.dim()) for s in self.split(t, dim)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def column_layout(parts: Sequence[Tuple[str, int]]) -> Optional[ColumnLayout]:
    """The :class:`ColumnLayout` of a weight whose columns are ``parts``
    under the active placement, or ``None`` when not every part's name is
    placed over the same mesh axes in as many blocks (the GEMM then runs on
    whole columns)."""
    blocks = [block(name) for name, _ in parts]
    if not blocks or any(b is None for b in blocks):
        return None
    if len({(b.part, b.count, b.index) for b in blocks}) != 1:
        return None
    segments, start = [], 0
    for (_, width), b in zip(parts, blocks):
        if width % b.count:
            return None
        w = width // b.count
        segments.append((start + b.index * w, w))
        start += width
    return ColumnLayout(tuple(segments), start, blocks[0].part, _CTX.placement.mesh)


def activation_amax(x, k_block: Optional[Block] = None):
    """A routed GEMM's activation abs-max over the whole operand its rank
    holds a block of: the local ``max(|x|)`` all-reduced with ``MAX`` over
    the mesh axes of the placed rows (:func:`row_blocks`) and, with
    ``k_block``, of the placed K.  ``None`` when neither is placed (the
    local reduction is then the global one).  Max is exact in any order,
    so the scale is bitwise the replicated program's.  Reference: the ``pmax`` of
    ``repro.core.dpu:quantize_symmetric``'s ``amax=`` callers.  Adds one to
    ``SCALE_REDUCTIONS["amax"]``."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import contracts

    parts = [b.part for b in row_blocks() + (k_block,) if b is not None]
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
    """``tree`` with ``fn(tensor, logical name, dim, leaf axes)`` applied
    along every dimension the active placement places (``axes``: a
    matching tree of logical-name tuples); other leaves (a host position)
    pass through."""
    import torch

    blocks = _CTX.placement.blocks if _CTX.placement is not None else {}
    items = tree_items(tree)
    ax = _axes_items(axes, items)
    out = []
    for key, t in items.items():
        if isinstance(t, torch.Tensor):
            for d, name in enumerate(ax[key]):
                if name in blocks:
                    t = fn(t, name, d, ax[key])
        out.append(t)
    return tree_unflatten(tree, out)


def _take_global(t, name: str, d: int, axes) -> Any:
    """This rank's block (a copy) of the global tensor ``t``'s dimension
    ``d``, a block of each part where ``axes`` lays the dimension out in
    parts; the block sized by the tensor (a logical name such as
    ``"inner"`` names dimensions of several sizes)."""
    b = dataclasses.replace(block(name), size=t.shape[d])
    return b.take(t, d, _part_widths(axes, d, t.shape[d])).contiguous().clone()


def place_tree(tree: Any, axes: Any) -> Any:
    """This rank's blocks (copies) of a tree of global tensors."""
    return _over_placed(tree, axes, _take_global)


def _param_parts(shape: Sequence[int], axes: Sequence[Optional[str]], rules=None) -> Dict[int, Tuple[str, Block]]:
    """``{dim: (logical name, Block)}`` of a parameter leaf's dimensions the
    active placement places: its name is placed and the leaf's own
    :func:`resolve_spec` maps the dimension (one that does not divide falls
    back to replication there, recorded, and stays whole)."""
    pl = _CTX.placement
    if pl is None or not any(name in pl.blocks for name in axes):
        return {}
    spec = resolve_spec(tuple(shape), tuple(axes), pl.mesh, rules)
    return {d: (name, pl.blocks[name]) for d, name in enumerate(axes)
            if name in pl.blocks and d < len(spec) and spec[d] is not None}


def place_params(params: Any, axes: Any, rules: Optional[Dict[str, AxisName]] = None) -> Any:
    """This rank's blocks (copies) of a parameter tree of global tensors
    along the placed logical names of its ``param_axes``, as the
    reference's ``in_shardings`` hold them (:func:`_param_parts`; a
    dimension whose axes declare column parts (:class:`Axes`: SwiGLU's
    ``wi``, Mamba2's ``in_proj`` and conv, the mLSTM's ``up`` and
    ``wq`` / ``wk`` / ``wv``, the sLSTM's ``wx``) by a block of each part,
    the bytes of the reference's contiguous block; an expert stack by its
    leading ``"experts"`` dimension).  Leaves that are not tensors (a
    prepacked bank) stay whole.  Reference: the parameter shardings of
    ``repro.launch.dryrun`` (``tree_shardings(mesh, params,
    param_axes)``)."""
    import torch

    items = tree_items(params)
    ax = _axes_items(axes, items)
    out = []
    for key, t in items.items():
        if isinstance(t, torch.Tensor):
            for d, (name, b) in _param_parts(t.shape, ax[key], rules).items():
                t = dataclasses.replace(b, size=t.shape[d]).take(t, d, _part_widths(ax[key], d, t.shape[d]))
            t = t.contiguous().clone()
        out.append(t)
    return tree_unflatten(params, out)


def placed_leaf_parts(shapes: Any, axes: Any, rules: Optional[Dict[str, AxisName]] = None) -> Any:
    """For each leaf of a parameter tree (global ``.shape``s: tensors or
    definitions), the mesh axes its block is placed over under the active
    placement, comma-joined (``""`` for a leaf held whole): a placed leaf's
    gradient norm sums over them (``adamw.Placed``)."""
    items = tree_items(shapes)
    ax = _axes_items(axes, items)
    out = []
    for key, s in items.items():
        names: Tuple[str, ...] = ()
        for _, (_, b) in _param_parts(s.shape, ax[key], rules).items():
            names += tuple(a for a in _names(b.part) if a not in names)
        out.append(",".join(names))
    return tree_unflatten(shapes, out)


def gather_tree(tree: Any, axes: Any) -> Any:
    """The global tensors of a tree of this rank's blocks: every placed
    dimension all-gathered (:func:`gather_block`, counted; a dimension in
    parts part by part)."""
    def gather(t, name, d, axes):
        parts = getattr(axes, "parts", ())
        if parts and d == len(axes) - 1:
            return gather_parts(t, name, parts)
        return gather_block(t, name, d)

    return _over_placed(tree, axes, gather)


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

