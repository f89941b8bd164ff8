"""Pytrees of tensors: nested dicts, lists, tuples and NamedTuples.

Leaves are visited in the reference's (`jax.tree_util`) order — dict
keys sorted, sequences and NamedTuple fields in order, None an empty
subtree — so a checkpoint's leaf `i` is the same tensor in both
packages."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of `tree`, in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """`fn` over corresponding leaves of `tree` and `rest` (same
    structure), rebuilt in `tree`'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree, new_leaves: List[Any]):
    """`tree`'s structure with `new_leaves` (in `leaves` order) as its
    leaves."""
    return _rebuild(tree, iter(new_leaves))


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)
