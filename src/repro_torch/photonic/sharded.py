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
unfused kernel, and ``dist.all_reduce`` sums the int32 partials over the
mesh's tensor-parallel axis; the replicated epilogue runs on the sum.  The
activation's scale is its global abs-max, which every rank sees because
the activation is replicated: the reference gets the same scale from a
``pmax`` of local maxima, and max is exact in any order.

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
) -> torch.Tensor:
    """Shard-local integer GEMM and a digital-domain int32 all-reduce over
    ``group`` (the mesh axis's process group): Summation.  The shard runs
    ``engine`` rebuilt at its local fan-in, folds its index in the group
    into the noise stream (shards decorrelate), and the int32 partials add
    exactly, so an ideal channel gives bitwise the unsharded result.
    ``pack`` is the unsharded view of this shard's block
    (:meth:`PackedDense.local`), whose content word and plane cache the
    stream uses.  Adds one to ``ALL_REDUCES["psum_int_gemm"]``.  Reference:
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
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    ALL_REDUCES["psum_int_gemm"] += 1
    return out


def _row_sharding(tp: TPContext, rows: int):
    """The mesh axes a mesh-mode GEMM's rows split over, with this rank's
    block index and the block count: every axis but the TP axis, row-major;
    ``None`` (replicate) in manual mode, with no such axis of more than one
    rank, when the block count does not divide ``rows``, or when the rows
    are placed (this rank's already).  Reference:
    ``repro.photonic.sharded:_row_sharding``."""
    from repro_torch.runtime.sharding import block, local_block

    if tp.manual or block("batch") is not None:
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


# ---------------------------------------------------------------------------
# STE autograd wrappers
# ---------------------------------------------------------------------------
class _TPFloatMatmul(torch.autograd.Function):
    """A float weight K-sharded per call.  Reference:
    ``repro.photonic.sharded:_tp_float_matmul``: the weight quantized per
    column at its global abs-max, each rank's K block of both operands
    through :func:`psum_int_gemm`, the epilogue on the sum; the backward is
    the dense straight-through one of the unsharded ``matmul_float``."""

    @staticmethod
    def forward(ctx, eng, site, spec, tp, fold, prng_key, k_block, x, w, bias):
        ctx.spec, ctx.k_block = spec, k_block
        ctx.save_for_backward(x, w, bias)
        bits = eng.dpu.operand_bits
        k, c = w.shape
        size, i = tp.size(), tp.rank()
        k_local = k // size
        rows = _row_sharding(tp, x.numel() // x.shape[-1])
        xl, sx = _local_x(x, bits, i, k_local, rows, k_block)
        wq, sw = quantize_symmetric(w, bits, axis=0)
        wl = wq[i * k_local : (i + 1) * k_local].contiguous()
        out = _tp_int_gemm(eng, xl, wl, tp, rows, site=site, fold=fold, prng_key=prng_key)
        y = apply_epilogue(out, sx, sw.to(torch.float32), bias, spec)
        return y.reshape(*x.shape[:-1], c).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.k_block is not None:
            raise NotImplementedError("a K-placed operand (local heads) runs in prefill and decode only")
        x, w, bias = ctx.saved_tensors
        wf = w.to(torch.float32)
        dx, g2, x2, db = _ste_grads(ctx.spec, g, x, wf, bias)
        dw = (x2.T @ g2).to(w.dtype)
        return None, None, None, None, None, None, None, dx, dw, db


class _TPPackedMatmul(torch.autograd.Function):
    """A prepacked bank, K-sharded.  Reference:
    ``repro.photonic.sharded:_tp_packed_matmul``: this rank's block of the
    bank (:meth:`PackedDense.local`) against its K block of the quantized
    activation, the global per-column scale in the epilogue on the sum.
    Backward: ``dx`` against the whole dequantized bank (a rank holding one
    block gathers the others) and ``db``; the int8 bank is frozen and its
    scale gets zeros."""

    @staticmethod
    def forward(ctx, eng, site, spec, tp, fold, prng_key, k_block, packed, x, w_scale, bias):
        ctx.spec, ctx.packed, ctx.tp, ctx.k_block = spec, packed, tp, k_block
        ctx.save_for_backward(x, w_scale, bias)
        size, i = tp.size(), tp.rank()
        k_local = packed.k // size
        rows = _row_sharding(tp, x.numel() // x.shape[-1])
        xl, sx = _local_x(x, eng.dpu.operand_bits, i, k_local, rows, k_block)
        view = packed.local(i, size)
        out = _tp_int_gemm(
            eng, xl, view.wq, tp, rows, site=site, fold=fold, prng_key=prng_key,
            logical_kc=(k_local, packed.c), tiling=view.tiling, pack=view,
        )
        y = apply_epilogue(out, sx, w_scale.to(torch.float32), bias, spec)
        return y.reshape(*x.shape[:-1], packed.c).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.k_block is not None:
            raise NotImplementedError("a K-placed operand (local heads) runs in prefill and decode only")
        x, w_scale, bias = ctx.saved_tensors
        p, tp = ctx.packed, ctx.tp
        wf = p.dequant()
        if p.shard is not None:
            blocks = [torch.empty_like(wf) for _ in range(tp.size())]
            dist.all_gather(blocks, wf.contiguous(), group=tp.process_group())
            wf = torch.cat(blocks, dim=0)
        dx, _, _, db = _ste_grads(ctx.spec, g, x, wf, bias)
        return None, None, None, None, None, None, None, None, dx, torch.zeros_like(w_scale), db


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
    and the caller gathers K first).  Reference:
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
    if isinstance(w, PackedDense):
        packed = w
    elif "w_scale" in params:
        packed = PackedDense(w, params["w_scale"], w.shape[-2], w.shape[-1])
    elif getattr(cfg, "photonic_scope", "weights") == "weights":
        if w.shape[0] % size:
            return None
        return _TPFloatMatmul.apply(engine, site, spec, tp, fold, prng_key, k_block, x, w, bias)
    else:
        return None
    if packed.k % size:
        return None
    if packed.tiling is not None:
        # Tile-padded banks shard only in the layout they were packed for:
        # mesh mode, pack shards == TP degree.
        if tp.manual or packed.shards != size:
            return None
    elif packed.shards not in (1, size):
        return None
    return _TPPackedMatmul.apply(engine, site, spec, tp, fold, prng_key, k_block, packed, x, packed.w_scale, bias)
