"""What a step dispatched, moved and held: launch, collective, GEMM-traffic
and memory accounting of the port's eager programs.

Port of ``repro.launch.hlo_analysis``.  The reference parses compiled HLO
text; the port compiles no HLO, so each pass reads what the port can
observe while the program runs:

* :func:`dispatch_summary` — a ``torch.profiler`` run: device kernels by
  name and count, ``cudaLaunchKernel`` calls, the photonic and flash
  kernels' launches, device-busy milliseconds and share;
* :class:`Recorder` — a ``TorchDispatchMode`` that records every aten op
  (name, input shapes and dtypes, output shapes), every ``c10d`` op (kind,
  bytes, group size) and, with ``track_memory``, the live bytes of the
  storages the ops allocate (fake or real);
* :func:`collective_summary` — wire bytes per kind over recorded
  collectives, priced by the reference's ring formula :func:`_wire_bytes`
  (point-to-point sends, the int8 ring's hops, as ``collective-permute``);
* :func:`matmul_traffic_bytes` — operands plus output of every GEMM that
  ran (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``; ``einsum`` and
  ``matmul`` reach these) and of every photonic kernel launch.

The reference's HLO text parsers (``parse_computations``,
``computation_multipliers``, ``_group_size``, ``collect_collectives``)
have no input here and are not copied: an eager run executes every loop
iteration, so there is no loop multiplier to recover.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# c10d op name -> the reference's collective kind, for the collectives the
# port issues (and the tensor forms of all-gather and reduce-scatter).  A
# ``recv_`` is the incoming half of a permute whose ``send`` is priced; any
# other c10d op (a barrier) is recorded under its own name, unpriced.
C10D_KINDS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "send": "collective-permute",
    "recv_": "recv",
}

GEMM_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm", "addbmm"})


def _wire_bytes(kind: str, out_bytes: float, group: Optional[int]) -> float:
    """Ring-algorithm wire-byte estimate per device.  Reference:
    ``repro.launch.hlo_analysis:_wire_bytes``."""
    g = group or 2
    frac = (g - 1) / g
    if kind.startswith("all-gather"):
        return out_bytes * frac                  # receive full output minus own shard
    if kind.startswith("all-reduce"):
        return 2.0 * out_bytes * frac            # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)  # operand (= out * g) times (g-1)/g
    if kind == "all-to-all":
        return out_bytes * frac
    if kind.startswith("collective-permute"):
        return out_bytes
    return out_bytes


def _nbytes(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as this rank issued it: ``kind`` (the reference's
    name), its output bytes and the size of its group."""

    kind: str
    op: str
    out_bytes: int
    group_size: Optional[int]


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One aten op: its name (``round``, ``mm``, ...), the shapes and dtypes
    of its tensor inputs (in argument order, lists flattened) and of its
    tensor outputs."""

    name: str
    inputs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    outputs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    """One launch of a hand-written kernel: its name, the shapes and dtypes
    of its operands and output as the wrapper passed them, and the live
    rows of a photonic launch (None for flash)."""

    name: str
    operands: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    output: Tuple[Tuple[int, ...], torch.dtype]
    rows: Optional[int] = None


def _spec(t: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    return tuple(int(d) for d in t.shape), t.dtype


def _tensors(values) -> List[torch.Tensor]:
    """The tensors among ``values`` and in the lists / tuples among them
    (an op's arguments and results are no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _group_of(args) -> Optional[int]:
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith("c10d.ProcessGroup"):
            import torch.distributed as dist

            return dist.ProcessGroup.unbox(a).size()
    return None


def collective_record(func, args) -> Optional[CollectiveRecord]:
    """The record of a ``c10d`` op call, or None for any other op."""
    if func.namespace != "c10d":
        return None
    op = func.overloadpacket.__name__
    return CollectiveRecord(C10D_KINDS.get(op, op), op, _nbytes(args[0]), _group_of(args))


class _LiveBytes:
    """Live bytes of the storages created while tracking, and their peak.
    A storage is counted once, when an op first outputs it (not when it
    returns a view of, or writes into, a storage it was given), and
    released when its last reference dies (a weak reference's callback),
    fake storages included."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}

    def _release(self, key: int, size: int) -> None:
        if self._seen.pop(key, None) is not None:
            self.live -= size

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        size = st.nbytes()
        self._seen[key] = weakref.ref(st, lambda _, k=key, n=size: self._release(k, n))
        self.live += size
        self.peak = max(self.peak, self.live)


class Recorder(TorchDispatchMode):
    """Records every aten op and ``c10d`` collective dispatched while it is
    active (the port's counterpart of tracing a jaxpr and compiling its
    HLO: the program runs, eagerly, and is observed), and the launches of
    the hand-written kernels (their wrappers' launch record).  With
    ``track_memory`` it also keeps the live and peak bytes of the storages
    the ops allocate.  Collectives are recorded whichever backend runs them
    (``gloo``, ``nccl``, or the ``fake`` group of a dry run)."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self.launches: List[LaunchRecord] = []
        self.memory = _LiveBytes() if track_memory else None

    # -- kernel launch record ---------------------------------------------------
    def _photonic(self, name, x, wq, out, rows) -> None:
        self.launches.append(LaunchRecord(name, (_spec(x), _spec(wq)), _spec(out), int(rows or x.shape[0])))

    def _flash(self, name, q, k, v, out) -> None:
        self.launches.append(LaunchRecord(name, (_spec(q), _spec(k), _spec(v)), _spec(out)))

    def __enter__(self):
        from repro_torch.kernels.flash_attention import kernel as F
        from repro_torch.kernels.photonic_gemm import kernel as K

        K.LAUNCH_RECORDERS.append(self._photonic)
        F.LAUNCH_RECORDERS.append(self._flash)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import kernel as F
        from repro_torch.kernels.photonic_gemm import kernel as K

        K.LAUNCH_RECORDERS.remove(self._photonic)
        F.LAUNCH_RECORDERS.remove(self._flash)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.prim.device.default:
            # a fake tensor's ``.device`` dispatches as an op; a real one's
            # does not.  A metadata query, not work: left out of the record
            return func(*args, **kwargs)
        coll = collective_record(func, args)
        if coll is not None:
            self.collectives.append(coll)
        out = func(*args, **kwargs)
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        self.ops.append(OpRecord(func.overloadpacket.__name__, tuple(_spec(t) for t in ins),
                                 tuple(_spec(t) for t in outs)))
        if self.memory is not None:
            # a view or an in-place result shares an input's storage: no new bytes
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in held:
                    self.memory.add(t)
        return out


def collective_summary(records: Iterable[CollectiveRecord]) -> Dict[str, float]:
    """Wire bytes per device by kind and overall, and the count of each
    kind, over recorded collectives.  Reference:
    ``repro.launch.hlo_analysis:collective_summary`` (there from HLO
    text, each op times its loop multiplier; here every issued op)."""
    by_kind: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for rec in records:
        if rec.kind not in _COLLECTIVES:
            continue
        by_kind[rec.kind] += _wire_bytes(rec.kind, rec.out_bytes, rec.group_size)
        count[rec.kind] += 1
    out = {f"bytes_{k}": v for k, v in by_kind.items()}
    out.update({f"count_{k}": float(v) for k, v in count.items()})
    out["total_wire_bytes"] = sum(by_kind.values())
    return out


def _bytes_of(spec: Tuple[Tuple[int, ...], torch.dtype]) -> int:
    shape, dtype = spec
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


def matmul_traffic_bytes(ops: Iterable[OpRecord], launches: Iterable[LaunchRecord] = ()) -> int:
    """The GEMMs' memory traffic: operands plus output of every GEMM op that
    ran and of every photonic kernel launch, each counted once (the
    elementwise chains around them assumed fused away).  Reference:
    ``repro.launch.hlo_analysis:matmul_traffic_bytes``."""
    total = 0
    for op in ops:
        if op.name in GEMM_OPS:
            total += sum(_bytes_of(s) for s in op.inputs) + sum(_bytes_of(s) for s in op.outputs)
    for rec in launches:
        if rec.name.startswith("photonic_gemm"):
            total += sum(_bytes_of(s) for s in rec.operands) + _bytes_of(rec.output)
    return total


def dispatch_summary(prof, wall_ms: Optional[float] = None, *, top: int = 6) -> Dict[str, Any]:
    """Launch and device-time summary of one ``torch.profiler.profile``
    run (the profile, or its ``key_averages()`` when the caller has them):
    device kernels by name and count (the ``top`` by device time),
    ``cudaLaunchKernel`` calls, the photonic and flash kernels' launches
    (device events whose name holds ``photonic_gemm`` / ``flash_attention``),
    device-busy milliseconds and, given the run's ``wall_ms``, the busy
    share.  Reference: ``repro.launch.hlo_analysis:dispatch_summary``
    (there the op count of a compiled module's entry computation)."""
    ka = prof if isinstance(prof, list) else prof.key_averages()  # an EventList is a list

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = [e for e in ka if e.device_type != torch.autograd.DeviceType.CUDA]
    return {
        "device_events": int(sum(e.count for e in kernels)),
        "launch_calls": int(sum(e.count for e in ka if e.key == "cudaLaunchKernel")),
        "photonic_launches": int(sum(e.count for e in kernels if "photonic_gemm" in e.key)),
        "flash_launches": int(sum(e.count for e in kernels if "flash_attention" in e.key)),
        "device_busy_ms": busy_ms,
        "wall_ms": wall_ms,
        "busy_share": (busy_ms / wall_ms) if wall_ms and busy_ms > 0 else None,
        "top_kernels": [(e.key, int(e.count), dev_us(e) / 1e3)
                        for e in sorted(kernels, key=dev_us, reverse=True)[:top]],
        "top_host_ops": [(e.key, int(e.count), e.self_cpu_time_total / 1e3)
                         for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]],
    }
