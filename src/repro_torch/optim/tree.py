"""Trees of tensors: nested dicts, lists, tuples and NamedTuples (the
optimizer states), walked in the order ``jax.tree_util`` walks them (dict
keys sorted), so a state's leaves line up with the JAX package's and with
``checkpoint/``'s."""
from __future__ import annotations

from typing import Any, Callable


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in sorted(tree)}
    out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf) for i, t in enumerate(tree)]
    if hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*out)
    return type(tree)(out)


def tree_leaves(tree: Any) -> list:
    """The leaves, in ``jax.tree_util``'s order (None holds none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def unzip(tree: Any, n: int) -> tuple:
    """A tree of n-tuples as n trees (the reference's ``pick``)."""
    is_tuple = lambda x: isinstance(x, tuple) and not hasattr(x, "_fields") and len(x) == n  # noqa: E731
    return tuple(tree_map(lambda t, i=i: t[i], tree, is_leaf=is_tuple) for i in range(n))
