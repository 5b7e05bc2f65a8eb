"""RPR008 — engine GEMM outputs take no post-GEMM scale/bias shoulders.

Port of ``repro.analysis.rules.epilogue``.  The engine's fused epilogue
(``EpilogueSpec``) carries the int32→float rescale, bias add, and
elementwise activation: a routed GEMM's result leaves ``engine.matmul*``
already rescaled, biased and activated — on the card, inside the
photonic kernel's epilogue.  Model code that multiplies or adds onto an
engine output afterwards re-introduces the materialized intermediate the
fusion removed — and silently double-applies the shoulder if the epilogue
was also requested.  The blessed spelling is
``dense(..., epilogue=EpilogueSpec(...))`` /
``engine.matmul(..., epilogue=Epilogue(spec, bias))``.

Only *engine* matmul results are tracked, by the receiver spelling
(``matmul``, ``matmul_float``, ``maybe_tp_matmul``: ``photonic/engine.py``,
``photonic/sharded.py``).  The shoulders are the operators ``*`` ``+``
``-`` ``/`` (and their augmented forms), the tensor methods ``.mul``
``.add`` ``.sub`` ``.div`` in place or not, and ``torch.mul`` /
``torch.add`` / ``torch.sub`` / ``torch.div`` with the result as an
operand.  ``torch.matmul`` and arithmetic on :func:`dense` outputs
(residual adds, SwiGLU gating) are out of scope — those run in the
digital domain.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.core import Finding, Rule, dotted_name, register_rule

# Engine GEMM entry points whose results are epilogue-complete.
_ENGINE_MATMULS = frozenset({"matmul", "matmul_float", "maybe_tp_matmul"})

# Receiver modules whose .matmul is the digital op, not the engine's.
_DIGITAL_BASES = frozenset({"torch", "np", "numpy"})

_ARITH_OPS = (ast.Mult, ast.Add, ast.Sub, ast.Div)

# result.<method>(...) shoulders.
_ARITH_METHODS = frozenset({"mul", "mul_", "add", "add_", "sub", "sub_", "div", "div_"})

# torch.<fn>(result, ...) / torch.<fn>(..., result) shoulders.
_ARITH_FUNCTIONS = frozenset({"torch.mul", "torch.add", "torch.sub", "torch.div"})


def _is_engine_matmul(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _ENGINE_MATMULS:
        base = func.value
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id in _DIGITAL_BASES:
            return False
        return True
    if isinstance(func, ast.Name) and func.id in _ENGINE_MATMULS:
        return True
    return False


@register_rule
class FusedEpilogueRule(Rule):
    id = "RPR008"
    summary = "post-GEMM arithmetic on an engine matmul output"
    rationale = (
        "Engine GEMM results are epilogue-complete (rescale, bias, "
        "activation ride the fused EpilogueSpec); scaling or bias-adding "
        "them afterwards re-materializes the intermediate the fusion "
        "removed — pass epilogue= (EpilogueSpec/Epilogue) to "
        "dense()/engine.matmul* instead."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("src/repro_torch/models/")

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                yield from self._check_scope(fn, relpath)

    def _check_scope(self, fn: ast.AST, relpath: str) -> Iterable[Finding]:
        tracked: Set[str] = set()
        findings: List[Finding] = []

        def operand_hits(node: ast.AST) -> bool:
            if _is_engine_matmul(node):
                return True
            return isinstance(node, ast.Name) and node.id in tracked

        def shoulder(node: ast.AST) -> bool:
            if isinstance(node, ast.BinOp) and isinstance(node.op, _ARITH_OPS):
                return operand_hits(node.left) or operand_hits(node.right)
            if not isinstance(node, ast.Call):
                return False
            func = node.func
            if dotted_name(func) in _ARITH_FUNCTIONS:
                return any(operand_hits(a) for a in node.args[:2])
            return (
                isinstance(func, ast.Attribute)
                and func.attr in _ARITH_METHODS
                and operand_hits(func.value)
            )

        def visit_expr(node: ast.AST) -> None:
            if shoulder(node):
                findings.append(
                    self.finding(
                        relpath,
                        node,
                        "arithmetic on an engine matmul output; pass "
                        "epilogue= so it rides the fused "
                        "epilogue",
                    )
                )
            for child in ast.iter_child_nodes(node):
                # Nested scopes get their own tracker pass.
                if not isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    visit_expr(child)

        def visit_stmts(stmts: List[ast.stmt]) -> None:
            for stmt in stmts:
                if isinstance(stmt, ast.AugAssign):
                    if (
                        isinstance(stmt.target, ast.Name)
                        and stmt.target.id in tracked
                        and isinstance(stmt.op, _ARITH_OPS)
                    ):
                        findings.append(
                            self.finding(
                                relpath,
                                stmt,
                                "in-place arithmetic on an engine matmul "
                                "output; pass epilogue= so it rides "
                                "the fused epilogue",
                            )
                        )
                    visit_expr(stmt.value)
                    continue
                if isinstance(stmt, ast.Assign):
                    visit_expr(stmt.value)
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            if _is_engine_matmul(stmt.value):
                                tracked.add(tgt.id)
                            else:
                                tracked.discard(tgt.id)
                    continue
                # Recurse through compound statements in source order so
                # tracking follows control flow (approximately: branches
                # share one tracker, which only over-approximates).
                for field in ("test", "value", "iter", "exc"):
                    sub = getattr(stmt, field, None)
                    if sub is not None and isinstance(sub, ast.AST):
                        visit_expr(sub)
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                        visit_stmts(sub)
                for handler in getattr(stmt, "handlers", []) or []:
                    visit_stmts(handler.body)

        if isinstance(fn, ast.Lambda):
            visit_expr(fn.body)
        else:
            visit_stmts(fn.body)
        yield from findings
