"""Runtime contract checks for the port.

Stands in for ``repro.analysis.contracts:assert_zero_weight_rounds`` (and
``count_weight_round_ops``): the reference counts round primitives over
weight-sized arrays in a traced jaxpr; PyTorch runs eagerly, so the port
counts ``aten.round`` calls on *weight-shaped* tensors — the logical
``(K, C)`` or stored ``(Kp, Cp)`` shape of a routed weight — while the code
runs, with a ``TorchDispatchMode``.

:data:`ALL_REDUCES` counts the collectives of tensor-parallel execution:
``repro_torch.photonic.sharded.psum_int_gemm`` adds one for each int32
all-reduce it issues, the forward counterpart of the reference
``ContractChecker``'s "one psum per routed GEMM".  :data:`ROW_GATHERS`
counts the mesh-mode GEMMs whose rows split over the data axes and were
gathered back (``repro_torch.photonic.sharded``): one a GEMM.
"""

from __future__ import annotations

from typing import Any, Iterable, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


ALL_REDUCES = {"psum_int_gemm": 0}
ROW_GATHERS = {"tp_rows": 0}


def reset_all_reduces() -> None:
    """Zero :data:`ALL_REDUCES` and :data:`ROW_GATHERS`."""
    for counts in (ALL_REDUCES, ROW_GATHERS):
        for name in counts:
            counts[name] = 0


class WeightRoundCounter(TorchDispatchMode):
    """Counts ``aten.round`` calls on tensors of one of ``shapes`` while the
    mode is active."""

    def __init__(self, shapes: Iterable[Tuple[int, ...]]):
        super().__init__()
        self.shapes: Set[Tuple[int, ...]] = {tuple(s) for s in shapes}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.round and args:
            x = args[0]
            if isinstance(x, torch.Tensor) and tuple(x.shape) in self.shapes:
                self.count += 1
        return func(*args, **(kwargs or {}))


def weight_shapes(params: Any) -> Set[Tuple[int, ...]]:
    """Logical and stored shapes of every prepacked weight in a tree (a
    K-sharded pack's shard-local ``(K/shards, C)`` among them)."""
    from repro_torch.photonic.packing import PackedDense

    shapes: Set[Tuple[int, ...]] = set()

    def walk(node):
        if isinstance(node, PackedDense):
            shapes.add((node.k, node.c))
            shapes.add((node.k_local, node.c))
            shapes.add(tuple(node.wq.shape))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return shapes
