"""RPR009 — platform-typed strings resolve through
``repro_torch.platforms.resolve`` only.

Port of ``repro.analysis.rules.platforms``, with the same heuristic.

The mirror of RPR002 for the material-platform axis: platform
names ("SOI", "SiN") are registry keys, and the single blessed
normalization site is ``platforms._normalize_platform`` — ad-hoc
``.upper()``/``.lower()`` on a platform-typed value forks the
canonicalization and silently diverges from the registry's
case/whitespace handling.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from repro_torch.analysis.core import Finding, Rule, dotted_name, register_rule

_CASE_METHODS = frozenset({"upper", "lower", "casefold", "title", "capitalize"})

# Identifier tokens that mark a value as platform-typed. "material" is
# included because the platform axis *is* the waveguide material choice
# (SOI vs SiN) throughout the paper's Sec. V discussion.
_PLATFORM_TOKENS = frozenset(
    {"platform", "platforms", "material", "materials"}
)
_TOKEN_SPLIT = re.compile(r"[^a-zA-Z0-9]+")


def _is_platformish(node: ast.AST) -> bool:
    dotted = dotted_name(node)
    if dotted is None:
        return False
    tokens = {t.lower() for t in _TOKEN_SPLIT.split(dotted) if t}
    return bool(tokens & _PLATFORM_TOKENS)


@register_rule
class PlatformResolutionRule(Rule):
    id = "RPR009"
    summary = "ad-hoc case normalization of a platform string outside repro_torch.platforms"
    rationale = (
        "Platform-typed values (material names like 'SOI'/'SiN') must flow "
        "through repro_torch.platforms.resolve; hand-rolled .upper()/.lower() "
        "normalization forks the canonicalization logic and silently "
        "diverges from the registry's case/whitespace handling."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath != "src/repro_torch/platforms.py"

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _CASE_METHODS
                and not node.args
                and not node.keywords
            ):
                continue
            receiver = node.func.value
            # `platform.strip().upper()` — look through chained str methods.
            while (
                isinstance(receiver, ast.Call)
                and isinstance(receiver.func, ast.Attribute)
            ):
                receiver = receiver.func.value
            if _is_platformish(receiver):
                yield self.finding(
                    relpath,
                    node,
                    f"case-normalizing a platform-typed value via "
                    f".{node.func.attr}(); route through "
                    f"repro_torch.platforms.resolve",
                )
