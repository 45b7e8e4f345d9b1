"""Nested dicts and lists of tensors (the port's parameter trees).

Shared by the models and the aggregation engine, so that neither layer
depends on the other for them.  Leaves come in insertion order.
"""
from __future__ import annotations

from typing import Any, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to every leaf of nested dicts and lists (leaf by
    leaf over several trees of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)
