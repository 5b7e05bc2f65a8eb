"""RPR005 — quantization paths multiply by a reciprocal, never divide by a
constant scale.

Port of ``repro.analysis.rules.quant``.  ``x / 127.0`` and
``x * (1.0 / 127.0)`` round differently in the last ulp.  The port's
quantizers run twice over the same values — eagerly in PyTorch, and in
the hand-written kernels' prologues, which build the scale as a
reciprocal multiply — and the int8 codes must agree bit for bit between
the two (and with the reference, which XLA compiles to the reciprocal
form).  So everywhere a quantization scale is built from constants, the
port spells the reciprocal multiply: no ``/`` by a constant, and no
``torch.div`` / ``torch.true_divide`` / ``.div()`` / ``.div_()`` by one.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Tuple

from repro_torch.analysis.core import Finding, Rule, dotted_name, register_rule

_CONST_CALLS = frozenset({"float", "int", "min", "max", "abs"})

# torch.<fn>(dividend, divisor) spellings.
_DIV_FUNCTIONS = frozenset({"torch.div", "torch.divide", "torch.true_divide"})

# dividend.<method>(divisor) spellings, in place or not.
_DIV_METHODS = frozenset(
    {"div", "div_", "divide", "divide_", "true_divide", "true_divide_"}
)


def _is_const_expr(node: ast.AST) -> bool:
    """Syntactically constant numeric expression (no names, no attributes).

    Names are deliberately NOT constant: ``x / scale`` with a runtime scale
    is the correct second half of the blessed pattern and must never flag.
    """
    if isinstance(node, ast.Constant):
        is_num = isinstance(node.value, (int, float))
        return is_num and not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp):
        return _is_const_expr(node.operand)
    if isinstance(node, ast.BinOp):
        return _is_const_expr(node.left) and _is_const_expr(node.right)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _CONST_CALLS and all(
            _is_const_expr(a) for a in node.args
        )
    return False


def _is_literal_one(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value in (1, 1.0)


def _division(node: ast.AST) -> Optional[Tuple[Optional[ast.AST], Optional[ast.AST]]]:
    """(dividend, divisor) of a division spelling at ``node``, else None.
    A method call's dividend is its receiver."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        return node.left, node.right
    if not isinstance(node, ast.Call):
        return None
    kw = {k.arg: k.value for k in node.keywords}
    func = node.func
    if dotted_name(func) in _DIV_FUNCTIONS:
        args = list(node.args) + [None, None]
        return args[0] or kw.get("input"), args[1] or kw.get("other")
    if isinstance(func, ast.Attribute) and func.attr in _DIV_METHODS:
        divisor = node.args[0] if node.args else kw.get("other")
        return func.value, divisor
    return None


@register_rule
class ReciprocalQuantRule(Rule):
    id = "RPR005"
    summary = "constant-divisor division in a quantization path"
    rationale = (
        "x / const and x * (1/const) differ in the last ulp, and the port's "
        "kernels build quantization scales as reciprocal multiplies; the "
        "eager PyTorch path must spell the same reciprocal multiply "
        "(amax * (1.0 / qmax)) so eager and kernel int8 codes stay "
        "bit-identical."
    )

    def applies_to(self, relpath: str) -> bool:
        # Quantization paths live in the port's package; test tolerance
        # arithmetic is out of scope.
        return relpath.startswith("src/repro_torch/")

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if "quant" not in fn.name.lower():
                continue
            for node in ast.walk(fn):
                operands = _division(node)
                if operands is None:
                    continue
                dividend, divisor = operands
                if _is_literal_one(dividend):
                    continue  # 1.0 / qmax IS the reciprocal idiom
                if divisor is not None and _is_const_expr(divisor):
                    yield self.finding(
                        relpath,
                        node,
                        f"division by constant scale in {fn.name}(); use "
                        "reciprocal multiply: x * (1.0 / const)",
                    )
