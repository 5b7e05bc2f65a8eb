"""Runtime contract checks for the port.

Stands in for ``repro.analysis.contracts:assert_zero_weight_rounds`` (and
``count_weight_round_ops``): the reference counts round primitives over
weight-sized arrays in a traced jaxpr; PyTorch runs eagerly, so the port
counts ``aten.round`` calls on *weight-shaped* tensors — the logical
``(K, C)`` or stored ``(Kp, Cp)`` shape of a routed weight — while the code
runs, with a ``TorchDispatchMode``.
"""

from __future__ import annotations

from typing import Any, Iterable, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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
    """Logical and stored shapes of every prepacked weight in a tree."""
    from repro_torch.photonic.packing import PackedDense

    shapes: Set[Tuple[int, ...]] = set()

    def walk(node):
        if isinstance(node, PackedDense):
            shapes.add((node.k, node.c))
            shapes.add(tuple(node.wq.shape))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return shapes
