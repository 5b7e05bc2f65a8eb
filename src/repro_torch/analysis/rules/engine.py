"""RPR003 — models/runtime route every GEMM through the engine surface.

Port of ``repro.analysis.rules.engine``.  The sanctioned entry points are
``repro_torch.models.common.dense(site=...)``,
``engine.matmul``/``matmul_float`` and the ``repro_torch.photonic.sharded``
contexts.  Imports from ``repro_torch.kernels`` and direct calls into the
kernel backends (the hand-written kernels' wrappers and twins, the
reference int GEMMs, the raw ops wrappers, flash attention's entry points)
from model or runtime code bypass routing policy, seed derivation, and
prepacking.  Model code reaches the epilogue types through
``repro_torch.photonic``, which re-exports them.
"""

from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import Finding, Rule, dotted_name, register_rule

# Backend entry points that only repro_torch.photonic / repro_torch.kernels
# may touch: the wrappers and twins of kernels/photonic_gemm/kernel.py, the
# ops surface (ops.py), the plain references (ref.py), the engine's integer
# GEMM and its sharded psum (photonic/engine.py, photonic/sharded.py), the
# prepacked matmul, and flash attention (kernels/flash_attention/kernel.py).
_BACKEND_NAMES = frozenset(
    {
        "photonic_gemm",
        "photonic_gemm_fused",
        "photonic_gemm_twin",
        "photonic_gemm_fused_twin",
        "photonic_gemm_int",
        "photonic_gemm_ref",
        "exact_int_gemm",
        "int_gemm",
        "psum_int_gemm",
        "_packed_matmul",
        "flash_attention_fwd",
        "flash_attention_fwd_twin",
    }
)

_KERNELS_PACKAGE = "repro_torch.kernels"

_SCOPED_PREFIXES = ("src/repro_torch/models/", "src/repro_torch/runtime/")


@register_rule
class EngineRoutingRule(Rule):
    id = "RPR003"
    summary = "direct kernel-backend call outside repro_torch.photonic"
    rationale = (
        "Models and runtime must route GEMMs via dense(site=...) or "
        "engine.matmul*; calling kernel backends directly skips the "
        "engine's routing policy, per-site seed derivation, and the "
        "weight-stationary prepacked path."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPED_PREFIXES)

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == _KERNELS_PACKAGE or mod.startswith(_KERNELS_PACKAGE + "."):
                    yield self.finding(
                        relpath,
                        node,
                        f"import from kernel backend {mod!r}; route via "
                        "dense(site=...) / engine.matmul*",
                    )
                    continue
                for alias in node.names:
                    if alias.name in _BACKEND_NAMES:
                        yield self.finding(
                            relpath,
                            node,
                            f"import of backend entry point {alias.name!r}; "
                            "route via dense(site=...) / engine.matmul*",
                        )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith(_KERNELS_PACKAGE):
                        yield self.finding(
                            relpath,
                            node,
                            f"import of kernel backend {alias.name!r}; "
                            "route via dense(site=...) / engine.matmul*",
                        )
            elif isinstance(node, ast.Call):
                func = node.func
                name = None
                if isinstance(func, ast.Attribute):
                    name = func.attr
                elif isinstance(func, ast.Name):
                    name = func.id
                if name in _BACKEND_NAMES:
                    dotted = dotted_name(func) or name
                    yield self.finding(
                        relpath,
                        node,
                        f"direct kernel-backend call {dotted}(); route via "
                        "dense(site=...) / engine.matmul*",
                    )
