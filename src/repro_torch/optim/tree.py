"""Nested dicts and lists of tensors (the port's parameter trees): their
leaves in a fixed order, and maps over them.  Anything that is neither a
dict nor a list is a leaf (a tuple too)."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves in order: dict keys as stored, lists by index."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def named_leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs in ``leaves`` order, each name the path of dict
    keys and list indices joined with ``__``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += named_leaves(v, f"{prefix}__{k}" if prefix else str(k))
    return out
