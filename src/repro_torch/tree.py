"""Parameter trees: nested dicts with tensor leaves (the port's stand-in
for JAX pytrees).  Keys keep their insertion order."""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leafwise to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unstack(tree, n: int) -> list:
    """A tree stacked on a leading axis of ``n`` as ``n`` trees, one an
    index (one ``unbind`` a leaf)."""
    per_leaf = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda a: a[i], per_leaf) for i in range(n)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in the order
    `tree_leaves` gives."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
