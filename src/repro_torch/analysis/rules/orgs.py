"""RPR002 — org-typed strings resolve through ``repro_torch.orgs.resolve``
only.

Port of ``repro.analysis.rules.orgs``, with the same heuristic.

Ad-hoc case normalization of an organization/order string is how two call
sites drift apart (the rule's first catch was ``orgs.resolve`` itself
duplicating ``from_order``'s ``.strip().upper()``). The single blessed
normalization site is ``orgs._normalize_order``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable

from repro_torch.analysis.core import Finding, Rule, dotted_name, register_rule

_CASE_METHODS = frozenset({"upper", "lower", "casefold", "title", "capitalize"})

# Identifier tokens that mark a value as organization-typed. "order" is
# included because in this codebase the four-letter block order *is* the
# organization identity (OrgSpec.from_order / resolve accept it).
_ORG_TOKENS = frozenset(
    {"org", "orgs", "organization", "organizations", "order", "orders", "ordering"}
)
_TOKEN_SPLIT = re.compile(r"[^a-zA-Z0-9]+")


def _is_orgish(node: ast.AST) -> bool:
    dotted = dotted_name(node)
    if dotted is None:
        return False
    tokens = {t.lower() for t in _TOKEN_SPLIT.split(dotted) if t}
    return bool(tokens & _ORG_TOKENS)


@register_rule
class OrgResolutionRule(Rule):
    id = "RPR002"
    summary = "ad-hoc case normalization of an org string outside repro_torch.orgs"
    rationale = (
        "Organization-typed values (order strings like 'ASMW') must flow "
        "through repro_torch.orgs.resolve; hand-rolled .upper()/.lower() "
        "normalization forks the canonicalization logic and silently "
        "diverges from the registry's case/whitespace handling."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath != "src/repro_torch/orgs.py"

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
            # `org.strip().upper()` — look through chained str methods.
            while (
                isinstance(receiver, ast.Call)
                and isinstance(receiver.func, ast.Attribute)
            ):
                receiver = receiver.func.value
            if _is_orgish(receiver):
                yield self.finding(
                    relpath,
                    node,
                    f"case-normalizing an org-typed value via "
                    f".{node.func.attr}(); route through repro_torch.orgs.resolve",
                )
