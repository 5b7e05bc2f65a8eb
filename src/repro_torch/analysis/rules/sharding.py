"""RPR006 — no ``tensor_parallel`` scope inside a ``manual_tp`` block.

Port of ``repro.analysis.rules.sharding``.  ``tensor_parallel(mesh,
axis)`` installs the *mesh-level* sharded-GEMM scope: it takes the mesh's
process group for the axis and issues its own collectives.  The port's
counterpart of the reference's manual per-shard body is the body of a
``with manual_tp(axis, group=...)`` block (``runtime/dp_step.py``), which
only tags the axis and the rank's group for the engine's shard-local
channel model.  Entering ``tensor_parallel`` inside that body nests a
second set of collectives and deadlocks or double-reduces.

The block's body is checked, and so is every function of the same module
that the body calls by name (module-wide name resolution, as in the
reference: it errs toward flagging).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List

from repro_torch.analysis.core import Finding, Rule, register_rule

_BANNED = "tensor_parallel"
_MANUAL = "manual_tp"


def _callee_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _uses_banned(node: ast.AST) -> List[ast.AST]:
    hits = []
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            name = sub.id if isinstance(sub, ast.Name) else sub.attr
            if name == _BANNED:
                hits.append(sub)
    return hits


def _manual_body(node: ast.AST) -> List[ast.AST]:
    """What runs under a ``with manual_tp(...)`` at ``node``: the block's
    statements and any context managers entered after it on the same
    ``with`` line.  Empty if ``node`` is no such block."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return []
    for i, item in enumerate(node.items):
        expr = item.context_expr
        if isinstance(expr, ast.Call) and _callee_name(expr.func) == _MANUAL:
            later = [it.context_expr for it in node.items[i + 1:]]
            return later + list(node.body)
    return []


@register_rule
class ShardMapNestingRule(Rule):
    id = "RPR006"
    summary = "tensor_parallel entered inside a manual_tp block"
    rationale = (
        "tensor_parallel is a mesh-level scope (it issues its own "
        "collectives over the mesh's group); nesting it under a manual_tp "
        "block, the port's per-shard body, double-issues collectives. Use "
        "manual_tp(axis, group=) alone inside per-shard code."
    )

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        defs: Dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)

        seen = set()  # nested blocks and shared callees hit once
        for node in ast.walk(tree):
            body = _manual_body(node)
            if not body:
                continue
            targets: List[ast.AST] = list(body)
            called = set()
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                        called.add(sub.func.id)
            targets.extend(defs[name] for name in sorted(called) if name in defs)
            for target in targets:
                for hit in _uses_banned(target):
                    if hit in seen:
                        continue
                    seen.add(hit)
                    yield self.finding(
                        relpath,
                        hit,
                        "tensor_parallel inside a manual_tp block; use "
                        "manual_tp(axis, group=) for in-shard scopes",
                    )
