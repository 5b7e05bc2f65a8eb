"""RPR001 — the port's one import boundary: no ``jax``, ``jaxlib`` or
``repro`` import inside the port.

Port of ``repro.analysis.rules.compat``.  The reference funnels every
version-sensitive JAX symbol through a single compat surface; the port
imports no JAX at all, so its single surface is the boundary itself: no
absolute ``import`` or ``from`` of ``jax``, ``jaxlib`` or the reference
package ``repro`` under ``src/repro_torch/`` or in ``chip_smoke.py``
(whose card has no JAX).  The rule form of the AST scan in
``tests/test_torch_package.py``.  Port tests are out of scope: they call
the reference on purpose.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import Finding, Rule, register_rule

#: Top-level packages the port must never import.
_BANNED_ROOTS = frozenset({"jax", "jaxlib", "repro"})


def _banned_root(module: str) -> bool:
    return module.split(".", 1)[0] in _BANNED_ROOTS


@register_rule
class CompatIsolationRule(Rule):
    id = "RPR001"
    summary = "jax / jaxlib / repro imported inside the port"
    rationale = (
        "The port runs where there is no JAX: repro_torch and chip_smoke.py "
        "import neither jax, jaxlib nor the reference package repro, and "
        "keep their own copies of what they need from it, so the port "
        "starts on a machine that has only PyTorch."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("src/repro_torch/") or relpath == "chip_smoke.py"

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _banned_root(alias.name):
                        yield self.finding(
                            relpath,
                            node,
                            f"import of {alias.name!r} inside the port; keep a "
                            "copy under repro_torch instead",
                        )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level == 0 and _banned_root(mod):
                    yield self.finding(
                        relpath,
                        node,
                        f"import from {mod!r} inside the port; keep a copy "
                        "under repro_torch instead",
                    )
