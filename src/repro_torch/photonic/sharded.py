"""Tensor-parallel photonic execution: shard-local channels over a mesh.

Port of ``repro.photonic.sharded``.  The paper's fifth signal manipulation,
Summation, accumulates each DPE's partial dot product in the digital
domain; sharding a GEMM's reduction axis K over a device mesh is the same
semantics at system scale.  Each shard evaluates its local fan-in on a
channel rebuilt at ``N_local = min(N, K/shards)``
(:meth:`~repro_torch.core.dpu.DPUConfig.shard_local`), folds its shard
index into its noise stream, and the int32 partials meet in one exact
all-reduce.

The reference is single-controller: each routed GEMM wraps a
``shard_map``.  The port is SPMD over a ``torch.distributed`` process
group: every rank runs the whole model, replicated, on the same inputs and
keys; at a routed GEMM a rank holds only its K block of the packed bank (or
slices its K block of a float weight), runs the shard-local engine on the
unfused kernel, and an all-reduce (:mod:`repro_torch.runtime.collectives`)
sums the int32 partials over the mesh's tensor-parallel axis; the
replicated epilogue runs on the sum.  The activation's scale is its
global abs-max, which every rank sees because the activation is
replicated: the reference gets the same scale from a ``pmax`` of local
maxima, and max is exact in any order.

Modes (both dispatch from ``models.common.dense`` via
:func:`maybe_tp_matmul`):

* :func:`tensor_parallel` ``(mesh, axis)``: the mesh's process group for
  ``axis``; K-sharded tile-padded packs
  (``prepack_params(mesh=...)``) run here;
* :func:`manual_tp` ``(axis, group)``: the reference's mode for call sites
  inside a ``shard_map`` body; here a process group given directly (the
  default group when none), raw ``(K, C)`` banks and float weights only.

In mesh mode the rows split too, as the reference's GSPMD path splits
them (``_row_sharding``): when the mesh's other axes (its data axes) have
more than one rank and divide the rows, each rank runs only its row block
(by its row-major coordinate over those axes) through
:func:`psum_int_gemm`, so its tiles fold the row-local ids the
reference's ``shard_map`` body folds, and one ``all_gather`` per data axis
rebuilds the replicated output (counted in
``repro_torch.analysis.contracts.ROW_GATHERS``, one a GEMM).  Indivisible
rows replicate.  The straight-through backward stays the dense one on the
replicated operands.

Under a :func:`~repro_torch.runtime.sharding.placement` of the rows the
operand already is this rank's row block: it is not split again and
nothing is gathered, and its scale is the local abs-max all-reduced with
``MAX`` over the data axes
(:func:`~repro_torch.runtime.sharding.activation_amax`), so the tiles,
noise ids and scale are those of the split above.  An operand whose K is
placed too (``k_block``: attention's local heads into ``attn.wo``, whose
K_local = heads x hd / tp is exactly this rank's K shard) is not sliced
again either, and the scale's ``MAX`` runs over ``model`` as well.  The
backward of a placed operand gives this rank's rows' share of ``dw`` and
``db``, which the training step all-reduces over the data axes.

Where the weight is placed too (``sharding.place_params``: ``heads``,
``kv_heads``, ``d_ff``, ``vocab`` over ``model``; the routed experts are
digital ``einsum``s, outside this module), a routed GEMM takes one of the
two forms of the reference's partitioning:

* row-parallel (``attn.wo``, ``ffn.wo``: K placed): the K block above
  against this rank's K rows of the weight, whose per-column scale is the
  whole weight's (a ``MAX`` all-reduce of local column abs-maxima), the
  int32 partials summed in the same ``psum_int_gemm``;
* column-parallel (:func:`column_matmul`: ``wq`` / ``wk`` / ``wv``,
  MLA's ``wq`` / ``wuk`` / ``wuv``, ``ffn.wi`` and the shared experts'
  ``wi``, ``lm_head``, their columns placed, at widths ``tile_c`` need not
  divide): the rank holds its
  column block whole in K and runs every K shard of the TP program
  itself, each at its shard-local fan-in with shard ``s``'s stream and the
  block's global column origin (``c_origin``; the noise ids and content
  words are the whole weight's), summing the int32 partials locally (exact
  in any order, no all-reduce).  Its columns are bitwise the TP program's.
  It also takes the rank's columns of a whole weight (``train(mesh=)``,
  whose parameters stay whole); the backward then gathers the output
  gradient over ``model`` and is the replicated program's, bit for bit.

Contracts (``tests/test_torch_sharded.py``, ``tests/test_torch_train_tp.py``):
an ideal channel makes the K-sharded output bitwise the unsharded one, rows
split or not; each shard's channel is ``build_channel_model`` at its
``N_local``; noisy calls are deterministic per ``noise_seed`` /
``prng_key`` and decorrelate across shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import ALL_REDUCES, ROW_GATHERS
from repro_torch.core.dpu import quantize_symmetric
from repro_torch.kernels.photonic_gemm.epilogue import apply_epilogue, as_epilogue
from repro_torch.photonic.engine import PhotonicEngine, _ste_grads
from repro_torch.photonic.packing import PackedDense
from repro_torch.runtime import collectives


# ---------------------------------------------------------------------------
# Shard-local operating points
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def shard_local_engine(engine: PhotonicEngine, k_local: int) -> PhotonicEngine:
    """The engine one K-shard executes: same backend and policy, the DPU
    rebuilt at the shard-local fan-in.  Reference:
    ``repro.photonic.sharded:shard_local_engine``."""
    return dataclasses.replace(engine, dpu=engine.dpu.shard_local(k_local))


# ---------------------------------------------------------------------------
# Tensor-parallel context
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPContext:
    """Active tensor-parallel scope: a mesh axis to K-shard over, and its
    process group.  ``mesh=None`` is manual mode.  Reference:
    ``repro.photonic.sharded:TPContext``."""

    axis: str
    mesh: Optional[object] = None  # torch.distributed.device_mesh.DeviceMesh
    group: Optional[object] = None  # the axis's ProcessGroup; None: the default group

    @property
    def manual(self) -> bool:
        return self.mesh is None

    def process_group(self):
        return dist.group.WORLD if self.group is None else self.group

    def size(self) -> int:
        return dist.get_world_size(self.process_group())

    def rank(self) -> int:
        """This process's index along the axis (the reference's
        ``lax.axis_index``)."""
        return dist.get_rank(self.process_group())


class _Ctx(threading.local):
    current: Optional[TPContext] = None


_CTX = _Ctx()


def current_tp() -> Optional[TPContext]:
    """The active TP context, or ``None`` (single-device execution)."""
    return _CTX.current


@contextlib.contextmanager
def _scope(ctx: TPContext):
    prev = _CTX.current
    _CTX.current = ctx
    try:
        yield
    finally:
        _CTX.current = prev


def reenter(ctx: Optional[TPContext]):
    """Make ``ctx`` (a context :func:`current_tp` returned earlier, or
    ``None``) the active one again, as a context manager.  The TP scope is
    thread-local, and autograd runs a CUDA backward (and so a remat
    recompute) on its own thread, where the caller's scope is not active."""
    return contextlib.nullcontext() if ctx is None else _scope(ctx)


def tensor_parallel(mesh, axis: str = "model"):
    """Run policy-routed ``dense()`` GEMMs K-sharded over ``mesh[axis]``
    (a :class:`~torch.distributed.device_mesh.DeviceMesh` with named axes).
    Every rank of the axis must make the same calls in the same order.
    Reference: ``repro.photonic.sharded:tensor_parallel``."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; axes are {names}")
    return _scope(TPContext(axis=axis, mesh=mesh, group=mesh.get_group(axis)))


def manual_tp(axis: str = "model", group=None):
    """TP over an explicit process group (the default group when ``group``
    is None), the reference's mode for call sites inside a ``shard_map``
    body: operands arrive replicated, each rank slices its K block by its
    index in the group and the partials meet in the all-reduce.  Tile-padded
    packs are not shardable here, as there.  Reference:
    ``repro.photonic.sharded:manual_tp``."""
    return _scope(TPContext(axis=axis, mesh=None, group=group))


# ---------------------------------------------------------------------------
# The collective core
# ---------------------------------------------------------------------------
def psum_int_gemm(
    engine: PhotonicEngine,
    xq: torch.Tensor,  # (R, K_local) int8: this shard's activation block
    wq: torch.Tensor,  # (K_local, C) int8, or the shard's padded bank
    *,
    group,
    site: Optional[str] = None,
    fold: Optional[int] = None,
    prng_key=None,
    logical_kc=None,
    tiling=None,
    pack: Optional[PackedDense] = None,
    scatter=None,
) -> torch.Tensor:
    """Shard-local integer GEMM and a digital-domain int32 all-reduce over
    ``group`` (the mesh axis's process group): Summation.  The shard runs
    ``engine`` rebuilt at its local fan-in, folds its index in the group
    into the noise stream (shards decorrelate), and the int32 partials add
    exactly, so an ideal channel gives bitwise the unsharded result.
    ``pack`` is the unsharded view of this shard's block
    (:meth:`PackedDense.local`), whose content word and plane cache the
    stream uses.  Adds one to ``ALL_REDUCES["psum_int_gemm"]``.  With
    ``scatter = (B, T)`` (the output's rows are ``(B, T)`` flattened, ``T``
    the sequence placed over ``group``'s axis) the partials are
    reduce-scattered over the sequence instead: this rank's ``T / n``
    positions of each row, summed exactly (the psum's form, one
    ``SEQ_COLLECTIVES["scatter"]`` too).  Reference:
    ``repro.photonic.sharded:psum_int_gemm`` (whose ``axis`` is the mesh
    axis bound in ``shard_map``)."""
    k_local = int((logical_kc or tuple(wq.shape[-2:]))[0])
    local = shard_local_engine(engine, k_local)
    out = local.int_gemm(
        xq,
        wq,
        site=site,
        fold=fold,
        shard=dist.get_rank(group),
        prng_key=prng_key,
        logical_kc=logical_kc,
        tiling=tiling,
        pack=pack,
    ).contiguous()
    ALL_REDUCES["psum_int_gemm"] += 1
    if scatter is not None:
        from repro_torch.analysis.contracts import count_seq

        n = dist.get_world_size(group)
        chunks = [c.contiguous() for c in out.view(*scatter, -1).chunk(n, dim=1)]
        mine = collectives.reduce_scatter(torch.empty_like(chunks[0]), chunks, group=group)
        count_seq("scatter", "reduce-scatter", mine.numel() * mine.element_size(), n)
        return mine.reshape(-1, out.shape[-1])
    return collectives.all_reduce(out, group=group)


def _row_sharding(tp: TPContext, rows: int):
    """The mesh axes a mesh-mode GEMM's rows split over, with this rank's
    block index and the block count: every axis but the TP axis, row-major;
    ``None`` (replicate) in manual mode, with no such axis of more than one
    rank, when the block count does not divide ``rows``, or when the rows
    are placed (this rank's already: ``sharding.row_blocks``).  Reference:
    ``repro.photonic.sharded:_row_sharding``."""
    from repro_torch.runtime.sharding import local_block, row_blocks

    if tp.manual or row_blocks():
        return None
    mesh = tp.mesh
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a != tp.axis)
    if not dp_axes:
        return None

    index, count = local_block(dp_axes, mesh)
    if count == 1 or rows % count:
        return None
    return dp_axes, index, count


def _gather_rows(out: torch.Tensor, tp: TPContext, dp_axes) -> torch.Tensor:
    """This rank's row block of a GEMM's sum, gathered over ``dp_axes``
    (innermost first, so the blocks land row-major) into the replicated
    output.  Adds one to ``ROW_GATHERS["tp_rows"]``."""
    from repro_torch.runtime.sharding import all_gather_over

    out = all_gather_over(out, dp_axes, tp.mesh, 0)
    ROW_GATHERS["tp_rows"] += 1
    return out


def _local_x(x: torch.Tensor, bits: int, i: int, k_local: int, rows=None, k_block=None):
    """``x`` as rows quantized at its global abs-max (the scale every rank
    derives, bitwise the unsharded one), sliced to rank ``i``'s K block
    (unless ``k_block`` says it holds that block already) and, with ``rows``
    (:func:`_row_sharding`), to this rank's row block; with that scale.
    Placed rows and a placed K take the abs-max from
    :func:`~repro_torch.runtime.sharding.activation_amax`."""
    from repro_torch.runtime.sharding import activation_amax

    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = quantize_symmetric(x2, bits, amax=activation_amax(x2, k_block))
    if rows is not None:
        _, index, count = rows
        r = xq.shape[0] // count
        xq = xq[index * r : (index + 1) * r]
    if k_block is not None:
        return xq.contiguous(), sx
    return xq[:, i * k_local : (i + 1) * k_local].contiguous(), sx


def _tp_int_gemm(eng, xl, wl, tp: TPContext, rows, **kw) -> torch.Tensor:
    """:func:`psum_int_gemm` over the TP axis, then the rows gathered when
    they were split."""
    out = psum_int_gemm(eng, xl, wl, group=tp.process_group(), **kw)
    return out if rows is None else _gather_rows(out, tp, rows[0])


def _scatter_of(x: torch.Tensor, tp: TPContext, rows, block_output: bool):
    """The ``"seq_sp"`` :class:`~repro_torch.runtime.sharding.Block` a
    block's output GEMM (``block_output``) of operand ``x`` ``(B, T, K)``
    reduces onto (``sharding.scatter_block``: inside a block's Megatron
    form, the TP axis the sequence's, the rows not split here), else
    ``None``."""
    from repro_torch.runtime.sharding import scatter_block

    if not block_output or rows is not None:
        return None
    return scatter_block(x.shape[:-1], tp.axis)


def _scatter_grad(ctx, g):
    """The output gradient whole along the sequence: a scattered output's
    blocks all-gathered (``sharding.seq_grad_gather``)."""
    if ctx.scatter is None:
        return g
    from repro_torch.runtime.sharding import seq_grad_gather

    return seq_grad_gather(g.contiguous(), ctx.scatter, ctx.tp.mesh)


# ---------------------------------------------------------------------------
# STE autograd wrappers
# ---------------------------------------------------------------------------
def _k_placed_grads(ctx, g, x, wf, bias):
    """``(dx, g2, x2, db)`` of a routed GEMM whose operand is this rank's K
    block (``ctx.k_block``): ``wf`` the f32 K rows of the weight that rank
    holds (a placed weight: ``dx`` is this block's), or the whole weight,
    whose ``dx`` is computed whole and cut to the block (so it is the
    replicated program's bit for bit) and whose ``x2`` is gathered whole
    over the K axes for ``dw``."""
    kb, spec = ctx.k_block, ctx.spec
    if spec.activation is not None:
        raise NotImplementedError("a row-parallel GEMM takes no activation in its epilogue")
    g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    db = None if bias is None else g2.sum(dim=0).to(bias.dtype)
    if wf.shape[0] == x2.shape[1]:
        return (g2 @ wf.T).reshape(x.shape).to(x.dtype), g2, x2, db
    from repro_torch.runtime.sharding import all_gather_over

    dx = dataclasses.replace(kb, size=wf.shape[0]).take(g2 @ wf.T, 1).reshape(x.shape).to(x.dtype)
    return dx, g2, all_gather_over(x2, kb.part, ctx.tp.mesh, 1), db


class _TPFloatMatmul(torch.autograd.Function):
    """A float weight K-sharded per call.  Reference:
    ``repro.photonic.sharded:_tp_float_matmul``: the weight quantized per
    column at its global abs-max, each rank's K block of both operands
    through :func:`psum_int_gemm`, the epilogue on the sum; the backward is
    the dense straight-through one of the unsharded ``matmul_float``.  With
    ``k_block`` the operand is this rank's K block, and ``w`` the whole
    weight or its K rows (a placed weight, whose per-column abs-max is
    then all-reduced with ``MAX`` over the K axes).  Inside a block's
    Megatron form the int32 partials are reduce-scattered over the
    sequence (:func:`psum_int_gemm`'s ``scatter``) and the output is this
    rank's positions; the backward gathers its gradient first."""

    @staticmethod
    def forward(ctx, eng, site, spec, tp, fold, prng_key, k_block, block_output, x, w, bias):
        ctx.spec, ctx.k_block, ctx.tp = spec, k_block, tp
        ctx.save_for_backward(x, w, bias)
        bits = eng.dpu.operand_bits
        size, i = tp.size(), tp.rank()
        placed = k_block is not None and w.shape[0] == x.shape[-1]
        k_local = w.shape[0] if placed else w.shape[0] // size
        c = w.shape[1]
        rows = _row_sharding(tp, x.numel() // x.shape[-1])
        xl, sx = _local_x(x, bits, i, k_local, rows, k_block)
        if placed:
            wq, sw = quantize_symmetric(w, bits, axis=0, amax=_column_amax(w, k_block, tp))
            wl = wq
        else:
            wq, sw = quantize_symmetric(w, bits, axis=0)
            wl = wq[i * k_local : (i + 1) * k_local].contiguous()
        ctx.scatter = _scatter_of(x, tp, rows, block_output)
        lead = x.shape[:-1] if ctx.scatter is None else (x.shape[0], ctx.scatter.local)
        out = _tp_int_gemm(eng, xl, wl, tp, rows, site=site, fold=fold, prng_key=prng_key,
                           scatter=None if ctx.scatter is None else tuple(x.shape[:-1]))
        y = apply_epilogue(out, sx, sw.to(torch.float32), bias, spec)
        return y.reshape(*lead, c).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = _scatter_grad(ctx, g)
        x, w, bias = ctx.saved_tensors
        wf = w.to(torch.float32)
        if ctx.k_block is not None:
            dx, g2, x2, db = _k_placed_grads(ctx, g, x, wf, bias)
        else:
            dx, g2, x2, db = _ste_grads(ctx.spec, g, x, wf, bias)
        dw = (x2.T @ g2).to(w.dtype)
        return None, None, None, None, None, None, None, None, dx, dw, db


def _column_amax(w: torch.Tensor, k_block, tp: TPContext) -> torch.Tensor:
    """The per-column abs-max of a weight whose K rows this rank holds,
    over every rank's rows (``MAX`` all-reduce over the K axes, exact), in
    ``w``'s dtype and ``keepdim`` shape, as ``quantize_symmetric(axis=0)``
    takes it.  Adds one to ``PARAM_REDUCES["weight_scale"]``."""
    from repro_torch.analysis.contracts import PARAM_REDUCES
    from repro_torch.runtime.sharding import all_reduce_over

    amax = torch.amax(torch.abs(w), dim=0, keepdim=True).to(torch.float32)
    all_reduce_over(amax, k_block.part, tp.mesh, dist.ReduceOp.MAX)
    PARAM_REDUCES["weight_scale"] += 1
    return amax.to(w.dtype)


class _TPPackedMatmul(torch.autograd.Function):
    """A prepacked bank, K-sharded.  Reference:
    ``repro.photonic.sharded:_tp_packed_matmul``: this rank's block of the
    bank (:meth:`PackedDense.local`) against its K block of the quantized
    activation, the global per-column scale in the epilogue on the sum.
    Backward: ``dx`` against the whole dequantized bank (a rank holding one
    block gathers the others) and ``db``; the int8 bank is frozen and its
    scale gets zeros."""

    @staticmethod
    def forward(ctx, eng, site, spec, tp, fold, prng_key, k_block, block_output, packed, x, w_scale, bias):
        ctx.spec, ctx.packed, ctx.tp, ctx.k_block = spec, packed, tp, k_block
        ctx.save_for_backward(x, w_scale, bias)
        size, i = tp.size(), tp.rank()
        # A K-placed operand against a bank of its K rows (a placed int8
        # weight): the bank is this rank's block as it is.
        placed = k_block is not None and packed.shards == 1 and packed.k == x.shape[-1]
        k_local = packed.k if placed else packed.k // size
        rows = _row_sharding(tp, x.numel() // x.shape[-1])
        xl, sx = _local_x(x, eng.dpu.operand_bits, i, k_local, rows, k_block)
        view = packed if placed else packed.local(i, size)
        ctx.scatter = _scatter_of(x, tp, rows, block_output)
        lead = x.shape[:-1] if ctx.scatter is None else (x.shape[0], ctx.scatter.local)
        out = _tp_int_gemm(
            eng, xl, view.wq, tp, rows, site=site, fold=fold, prng_key=prng_key,
            logical_kc=(k_local, packed.c), tiling=view.tiling, pack=view,
            scatter=None if ctx.scatter is None else tuple(x.shape[:-1]),
        )
        y = apply_epilogue(out, sx, w_scale.to(torch.float32), bias, spec)
        return y.reshape(*lead, packed.c).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        g = _scatter_grad(ctx, g)
        x, w_scale, bias = ctx.saved_tensors
        p, tp = ctx.packed, ctx.tp
        wf = p.dequant()
        if ctx.k_block is not None:
            dx, _, _, db = _k_placed_grads(ctx, g, x, wf, bias)
            return None, None, None, None, None, None, None, None, None, dx, torch.zeros_like(w_scale), db
        if p.shard is not None:
            blocks = [torch.empty_like(wf) for _ in range(tp.size())]
            collectives.all_gather(blocks, wf.contiguous(), group=tp.process_group())
            wf = torch.cat(blocks, dim=0)
        dx, _, _, db = _ste_grads(ctx.spec, g, x, wf, bias)
        return None, None, None, None, None, None, None, None, None, dx, torch.zeros_like(w_scale), db


# ---------------------------------------------------------------------------
# dense() dispatch
# ---------------------------------------------------------------------------
def maybe_tp_matmul(
    engine: Optional[PhotonicEngine],
    params: dict,
    x: torch.Tensor,
    cfg,
    *,
    site: Optional[str] = None,
    fold: Optional[int] = None,
    prng_key=None,
    epilogue=None,
    slicing=None,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    k_block=None,
    block_output: bool = False,
) -> Optional[torch.Tensor]:
    """The tensor-parallel product for ``models.common.dense``, or ``None``
    when TP does not apply (no active context, degree 1, a site the policy
    keeps digital, a K the degree does not divide, a pack layout the mode
    cannot shard) and the caller falls through to the single-device path.
    ``epilogue=`` is applied after the all-reduce (the legacy ``bias=`` /
    ``activation=`` keywords are its shims); ``slicing`` overrides the
    engine's bit-slicing mode and rides into every shard-local pass.
    ``k_block`` (a :class:`~repro_torch.runtime.sharding.Block`) says that
    ``x``'s last dimension is this rank's block of K; it is taken only when
    that block is this rank's K shard of the TP axis (``None`` otherwise,
    and the caller gathers K first).  ``block_output``: the product is a
    block's output (a ``wo``), which a ``sharding.seq_block`` scope
    reduce-scatters over the sequence.  Reference:
    ``repro.photonic.sharded:maybe_tp_matmul``."""
    tp = current_tp()
    if tp is None or engine is None or not engine.routes(site):
        return None
    size = tp.size()
    if size <= 1:
        return None
    if k_block is not None and (tp.manual or k_block.part != tp.axis or k_block.count != size
                                or k_block.index != tp.rank()):
        return None
    spec, bias = as_epilogue(epilogue, bias=bias, activation=activation)
    if slicing is not None:
        engine = engine.with_slicing(slicing)
    w = params["w"]
    # a weight of this rank's K rows (placed) counts as its whole K here
    k_whole = size if k_block is not None and not isinstance(w, PackedDense) and w.shape[-2] == x.shape[-1] else 1
    if isinstance(w, PackedDense):
        packed = w
    elif "w_scale" in params:
        packed = PackedDense(w, params["w_scale"], w.shape[-2], w.shape[-1])
    elif getattr(cfg, "photonic_scope", "weights") == "weights":
        if (w.shape[0] * k_whole) % size:
            return None
        return _TPFloatMatmul.apply(engine, site, spec, tp, fold, prng_key, k_block, block_output, x, w, bias)
    else:
        return None
    if (packed.k * k_whole) % size:
        return None
    if packed.tiling is not None:
        # Tile-padded banks shard only in the layout they were packed for:
        # mesh mode, pack shards == TP degree.
        if tp.manual or packed.shards != size:
            return None
    elif packed.shards not in (1, size):
        return None
    return _TPPackedMatmul.apply(engine, site, spec, tp, fold, prng_key, k_block, block_output, packed, x,
                                 packed.w_scale, bias)


# ---------------------------------------------------------------------------
# Column-parallel GEMMs (a placed weight's columns)
# ---------------------------------------------------------------------------
def _shard_words(wq: torch.Tensor, shards: int, layout) -> torch.Tensor:
    """The content word (``tweak_word``) of each of ``shards`` K blocks of
    the whole weight, from this rank's columns ``wq``: the words add, so
    the ranks' column words summed over ``layout.part`` (an exact int64
    all-reduce) are the whole weight's, mod 2^32.  Adds one to
    ``PARAM_REDUCES["weight_words"]``."""
    from repro_torch.analysis.contracts import PARAM_REDUCES
    from repro_torch.noise.stages import U32, tweak_words
    from repro_torch.runtime.sharding import all_reduce_over

    words = tweak_words(wq.reshape(shards, wq.shape[0] // shards, wq.shape[1]))
    all_reduce_over(words, layout.part, layout.mesh)
    PARAM_REDUCES["weight_words"] += 1
    return words & U32


def _column_passes(eng, tp, layout, x, wq, sw, bias, spec, site, fold, prng_key):
    """The forward of :class:`_ColumnMatmul` on this rank's columns ``wq``
    (int8, whole in K) and their scales: without a TP scope, the fused
    stream of the single-device program at each segment's column origin;
    under one, every K shard of the TP program (shard-local engine, shard
    ``s``'s stream, the TP program's row blocks) at each segment's origin,
    the int32 partials summed here, then the epilogue."""
    from repro_torch.photonic.engine import _stream_gemm

    k = wq.shape[0]
    if tp is None:
        words = _shard_words(wq, 1, layout)[0] if eng.noisy else None
        biases = layout.split(bias) if bias is not None else [None] * len(layout.segments)
        ys = [_stream_gemm(eng, site, spec, x, wseg, sseg, bseg, fold, prng_key, columns=(o, layout.total),
                           w_word=words)
              for (o, _), wseg, sseg, bseg in zip(layout.segments, layout.split(wq), layout.split(sw), biases)]
        return torch.cat(ys, dim=-1) if len(ys) > 1 else ys[0]
    size = tp.size()
    k_local = k // size
    local = shard_local_engine(eng, k_local)
    rows = _row_sharding(tp, x.numel() // x.shape[-1])
    xq, sx = _local_x(x, eng.dpu.operand_bits, 0, k, None, None)
    blocks = [xq] if rows is None else list(xq.chunk(rows[2], dim=0))
    words = _shard_words(wq, size, layout) if local.noisy else None
    outs = []
    for (o, _), wseg in zip(layout.segments, layout.split(wq)):
        acc = None
        for s in range(size):
            ws = wseg[s * k_local : (s + 1) * k_local].contiguous()
            part = torch.cat([
                local.int_gemm(xb[:, s * k_local : (s + 1) * k_local].contiguous(), ws, site=site, fold=fold,
                               shard=s, prng_key=prng_key, columns=(o, layout.total),
                               w_word=None if words is None else words[s])
                for xb in blocks], dim=0)
            acc = part if acc is None else acc + part
        outs.append(acc)
    out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
    y = apply_epilogue(out, sx, sw.to(torch.float32), bias, spec)
    return y.reshape(*x.shape[:-1], out.shape[-1]).to(x.dtype)


class _ColumnMatmul(torch.autograd.Function):
    """A column-parallel GEMM (:func:`column_matmul`), routed (``eng``) or
    digital (``eng`` None: ``x @ w`` and the epilogue, as
    ``_digital_reference`` spells it).  ``w`` is this rank's columns
    (``whole`` false) or the whole weight, whose columns the forward takes;
    float, or int8 with its per-column ``w_scale`` (frozen: no gradient,
    zeros for the scale).  Backward, straight through: on a
    placed weight ``dx`` from this rank's columns (summed over ``model`` by
    the caller's ``copy_to_model``), ``dw`` and ``db`` its blocks; on a
    whole one the output gradient gathered over ``model`` and the
    replicated program's ``dx``, ``dw`` and ``db``."""

    @staticmethod
    def forward(ctx, eng, site, spec, tp, fold, prng_key, layout, whole, x, w, w_scale, bias):
        ctx.spec, ctx.layout, ctx.whole = spec, layout, whole
        ctx.save_for_backward(x, w, w_scale, bias)
        cols = layout.take if whole else (lambda t: t)
        wb = cols(w)
        if eng is None:
            from repro_torch.photonic.engine import _digital_reference

            wf = wb if w_scale is None else wb.to(torch.float32) * cols(w_scale).to(torch.float32)[None, :]
            return _digital_reference(x, wf.to(x.dtype), None if bias is None else cols(bias), spec)
        if w_scale is None:
            wq, sw = quantize_symmetric(wb, eng.dpu.operand_bits, axis=0)
            sw = sw.reshape(-1)
        else:
            wq, sw = wb, cols(w_scale)
        return _column_passes(eng, tp, layout, x, wq.contiguous(), sw, None if bias is None else cols(bias), spec,
                              site, fold, prng_key)

    @staticmethod
    def backward(ctx, g):
        x, w, w_scale, bias = ctx.saved_tensors
        wf = w.to(torch.float32) if w_scale is None else w.to(torch.float32) * w_scale.to(torch.float32)[None, :]
        if ctx.whole:
            g = ctx.layout.gather(g)
        dx, g2, x2, db = _ste_grads(ctx.spec, g, x, wf, bias)
        dw = None if w_scale is not None else (x2.T @ g2).to(w.dtype)
        dws = None if w_scale is None else torch.zeros_like(w_scale)
        return None, None, None, None, None, None, None, None, dx, dw, dws, db


def column_matmul(engine: Optional[PhotonicEngine], layout, params: dict, x: torch.Tensor, cfg, *, site=None,
                  fold=None, prng_key=None, epilogue=None, slicing=None) -> Optional[torch.Tensor]:
    """The column-parallel product for ``models.common.dense`` under a
    placement of the weight's columns (``layout``, a
    :class:`~repro_torch.runtime.sharding.ColumnLayout`): this rank's
    output columns, routed through ``engine`` bitwise the TP program's (or,
    without a TP scope, the single-device program's) — module docstring —
    or digital with ``engine`` None.  ``params["w"]`` is this rank's
    columns or the whole weight.  ``None`` when the form does not apply (a
    prepacked bank, a bit-sliced engine, manual TP, a K the TP degree does
    not divide, an int8 scope without ``w_scale``); the caller then runs
    the GEMM on whole columns."""
    w = params["w"]
    if isinstance(w, PackedDense) or w.shape[-1] not in (layout.local, layout.total):
        return None
    w_scale = params.get("w_scale")
    tp = None
    if engine is not None:
        if slicing is not None:
            engine = engine.with_slicing(slicing)
        if engine.slicing is not None:
            return None
        tp = current_tp()
        if tp is not None and tp.size() <= 1:
            tp = None
        if tp is not None and (tp.manual or w.shape[0] % tp.size()):
            return None
        if w_scale is None and getattr(cfg, "photonic_scope", "weights") != "weights":
            return None
    spec, bias = as_epilogue(epilogue)
    whole = w.shape[-1] == layout.total and layout.total != layout.local
    if not whole:
        from repro_torch.runtime.sharding import copy_to_model

        x = copy_to_model(x, layout.part)
    return _ColumnMatmul.apply(engine, site, spec, tp, fold, prng_key, layout, whole, x, w, w_scale, bias)
