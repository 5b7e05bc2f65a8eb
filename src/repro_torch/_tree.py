"""Parameter-tree helpers (no reference counterpart: the reference uses
``jax.tree``).

A tree is nested dicts, lists and NamedTuples (``adamw.OptState``) with
tensors (or other leaves) at the bottom.  Dict keys are walked in sorted
order, as ``jax.tree`` walks them, so every function here visits leaves in
one fixed order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *parts) for parts in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the fixed walk order."""
    return list(tree_items(tree).values())


def tree_items(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/0/c": leaf}``: each leaf under its path (dict keys, list
    indices and NamedTuple field names joined by ``/``)."""
    if isinstance(tree, dict):
        children = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        children = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, child in children:
        out.update(tree_items(child, f"{prefix}/{key}" if prefix else key))
    return out


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in the walk order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
