"""RPR010 — FPS/makespan/energy aggregation routes through the mapper.

Port of ``repro.analysis.rules.mapper``, with the same matcher, over the
port's package and ``chip_smoke.py`` (the counterpart of the reference's
``examples/``), ``repro_torch/mapper/`` and ``core/simulator.py`` exempt.

The event loop lives in ``repro_torch.mapper``: the timeline owns every
derived performance number (``Timeline.fps`` / ``fps_per_w`` /
``avg_power_w`` / ``mean_utilization``), and ``core/simulator.py`` is its
degenerate batch-1 re-expression.  Ad-hoc arithmetic over the timing
attributes of layer stats / node schedules / timelines (summing
``time_s`` into a makespan, dividing by ``energy_j``, scaling a
``makespan_s``) re-derives those numbers at the call site — which is
exactly the class of silent utilization assumption the mapper exists to
centralize (and that arXiv 2511.00186 shows decides photonic throughput
claims).  Reading a timing attribute, storing it, or serializing it is
fine; *arithmetic* on one belongs in ``repro_torch/mapper/`` or
``core/simulator.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from repro_torch.analysis.core import Finding, Rule, register_rule

#: Timing/energy attributes owned by the mapper timeline contract.
_TIMING_ATTRS = frozenset(
    {
        "time_s",
        "stream_s",
        "reduce_s",
        "tune_s",
        "energy_j",
        "total_time_s",
        "dynamic_energy_j",
        "makespan_s",
        "busy_s",
    }
)

#: Aggregation builtins that re-derive a schedule-level number.
_AGGREGATORS = frozenset({"sum", "min", "max"})

_SCOPED_PREFIXES = ("src/repro_torch/", "chip_smoke.py")
_EXEMPT_PREFIXES = ("src/repro_torch/mapper/", "src/repro_torch/core/simulator.py")


def _parents(tree: ast.Module) -> Dict[ast.AST, Optional[ast.AST]]:
    out: Dict[ast.AST, Optional[ast.AST]] = {tree: None}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


@register_rule
class MapperTimingArithmeticRule(Rule):
    id = "RPR010"
    summary = "ad-hoc timing/FPS arithmetic outside repro_torch.mapper"
    rationale = (
        "Makespan/FPS/energy aggregation must route through the mapper "
        "timeline (Timeline.fps / fps_per_w / avg_power_w) or "
        "core/simulator.py's degenerate schedule; arithmetic over "
        "time_s/energy_j/makespan_s at the call site re-implements the "
        "schedule's utilization assumptions."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPED_PREFIXES) and not relpath.startswith(
            _EXEMPT_PREFIXES
        )

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        parents = _parents(tree)
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Attribute)
                and node.attr in _TIMING_ATTRS
                and isinstance(node.ctx, ast.Load)
            ):
                continue
            cur: Optional[ast.AST] = node
            while cur is not None:
                parent = parents.get(cur)
                if isinstance(parent, (ast.BinOp, ast.AugAssign)):
                    yield self.finding(
                        relpath,
                        node,
                        f"arithmetic over timing attribute .{node.attr}; "
                        "use the repro_torch.mapper Timeline metrics "
                        "(fps/fps_per_w/avg_power_w) instead",
                    )
                    break
                if (
                    isinstance(parent, ast.Call)
                    and isinstance(parent.func, ast.Name)
                    and parent.func.id in _AGGREGATORS
                    and cur is not parent.func
                ):
                    yield self.finding(
                        relpath,
                        node,
                        f"aggregating timing attribute .{node.attr} with "
                        f"{parent.func.id}(); makespans/energies come from "
                        "the repro_torch.mapper Timeline, not call-site reductions",
                    )
                    break
                cur = parent
