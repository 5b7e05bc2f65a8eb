"""RPR007 — paged KV memory is touched only through the kv_cache API.

Port of ``repro.analysis.rules.serving``.  The serving pool's invariants
(null block stays zero, blocks zero at allocation, scatter destinations
distinct, ``(block, offset)`` addressing) all live in
``repro_torch.serving.kv_cache``.  Model and runtime code therefore
consumes the pool opaquely: it may pass ``kv_pool`` / ``block_table``
tensors through calls, but raw indexing (``kv_pool[...]``,
``block_table[i]``, ``kv_pool[idx] = ...``) or an in-place writer on one
(``kv_pool.index_copy_(...)``, ``.index_put_``, ``.scatter_``,
``.copy_``, ...) re-implements paged addressing at the call site and
silently breaks those invariants — e.g. writing into the null block
corrupts every request's zero-padding at once.

Axis manipulation (``block_table[None]`` — adding a broadcast axis before
a batched gather) carries no block arithmetic and stays allowed.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from repro_torch.analysis.core import Finding, Rule, register_rule

# Variable names that carry paged-serving memory by convention.
_PAGED_NAME = re.compile(r"(^|_)(kv_pools?|block_tables?)$")

# Tensor methods that write into their receiver in place.
_INPLACE_WRITERS = frozenset(
    {
        "index_copy_",
        "index_put_",
        "index_fill_",
        "scatter_",
        "masked_fill_",
        "copy_",
    }
)

_SCOPED_PREFIXES = ("src/repro_torch/models/", "src/repro_torch/runtime/")


def _paged_base(node: ast.AST) -> Optional[str]:
    """The paged-memory variable name behind an expression, if any —
    handles ``kv_pool``, ``self.kv_pool``, and chained attributes."""
    if isinstance(node, ast.Name) and _PAGED_NAME.search(node.id):
        return node.id
    if isinstance(node, ast.Attribute) and _PAGED_NAME.search(node.attr):
        return node.attr
    return None


def _is_axis_only_index(idx: ast.AST) -> bool:
    """True for pure broadcast-axis indices: ``x[None]``, ``x[None, None]``
    — no block arithmetic, just layout."""
    if isinstance(idx, ast.Constant):
        return idx.value is None
    if isinstance(idx, ast.Tuple):
        return all(_is_axis_only_index(e) for e in idx.elts)
    return False


@register_rule
class PagedKVAccessRule(Rule):
    id = "RPR007"
    summary = "raw paged-KV indexing outside repro_torch.serving.kv_cache"
    rationale = (
        "Models and runtime must go through the kv_cache API "
        "(gather_kv/scatter_kv/zero_blocks/chunk_dest/token_dest); "
        "subscripting kv_pool or block_table, or writing into one in "
        "place, re-implements block addressing and can break the pool "
        "invariants (zero null block, allocation-time zeroing, distinct "
        "scatter rows)."
    )

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith(_SCOPED_PREFIXES)

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Subscript):
                base = _paged_base(node.value)
                if base is not None and not _is_axis_only_index(node.slice):
                    yield self.finding(
                        relpath,
                        node,
                        f"raw indexing of paged memory {base!r}; use the "
                        "repro_torch.serving.kv_cache gather/scatter API",
                    )
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_WRITERS
            ):
                base = _paged_base(node.func.value)
                if base is not None:
                    yield self.finding(
                        relpath,
                        node,
                        f"in-place update of paged memory {base!r} via "
                        f".{node.func.attr}(); use "
                        "repro_torch.serving.kv_cache.scatter_kv/zero_blocks",
                    )
